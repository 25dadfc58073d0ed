// Warp-per-lane big-integer toolkit shared by the Hopper kernels.
//
// One warp owns one batch row ("lane" of the JAX package's batch). Its W
// int32 limbs (base 2^16, little-endian, possibly redundant) are spread in
// BLOCKED order over the 32 threads: thread t holds limbs
// [t*NPT, t*NPT + NPT) in registers, so a carry crosses threads once per pass
// (one __shfl_up_sync) instead of once per limb. Limbs at index >= W are
// padding and are kept at 0 by every helper.
//
// Every helper mirrors a function of cofhe_tpu_torch/ops/{limb,rl}.py on the
// same integers. Arithmetic that may wrap (left shifts of negative limbs,
// Montgomery products) goes through uint32_t, the way int32 tensors wrap in
// torch; right shifts of negative ints are arithmetic (floor), as in torch.
//
// Floats: value estimates only steer loops. They are summed in another order
// than torch's reduction, so they may differ in the last bit from the plain
// version; the outputs the kernels write are canonical integers and do not.
// Build without --use_fast_math (the steering needs IEEE division), rintf
// rounds half to even like torch.round.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define WL_FULL 0xffffffffu

namespace wl {

__device__ __forceinline__ int mulw(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// 2^e as f32 for e <= 127 (callers clamp); 0 below -126 (rl.pow2f).
__device__ __forceinline__ float pow2f(int e) {
  if (e < -126) return 0.0f;
  if (e > 127) e = 127;
  return __int_as_float((e + 127) << 23);
}

// rl._log2_f32
__device__ __forceinline__ float log2_f32(float v) {
  const float tiny = 1e-30f;
  int bits = __float_as_int(fmaxf(v, tiny));
  float e = (float)((bits >> 23) - 127);
  float frac = __int_as_float((bits & 0x7FFFFF) | (127 << 23));
  float approx = e + (frac - 1.0f) * (2.0f - frac * 0.5f) * 0.7219281f;
  return v <= tiny ? -200.0f : approx;
}

__device__ __forceinline__ float bits_est(float mant, int top) {
  return 16.0f * (float)top + log2_f32(fabsf(mant));
}

// Inverse of odd y0 modulo 2^16 (limb.modinv16).
__device__ __forceinline__ int modinv16(int y0) {
  uint32_t y = (uint32_t)y0, x = y;
#pragma unroll
  for (int k = 0; k < 4; k++) x = (x * (2u - y * x)) & 0xFFFFu;
  return (int)x;
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

template <int NPT>
__device__ __forceinline__ void load_row(int (&x)[NPT], const int* row, int len,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    x[j] = i < len ? row[i] : 0;
  }
}

template <int NPT>
__device__ __forceinline__ void store_row(const int (&x)[NPT], int* row, int W,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    if (i < W) row[i] = x[j];
  }
}

// rl.carry_pass: balanced partial carry pass, the top limb keeps its carry.
template <int NPT>
__device__ __forceinline__ void carry_pass(int (&x)[NPT], int lane, int W) {
  int c[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) c[j] = (int)((uint32_t)x[j] + 32768u) >> 16;
  int cin = __shfl_up_sync(WL_FULL, c[NPT - 1], 1);
  if (lane == 0) cin = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    int prev = j == 0 ? cin : c[j - 1];
    if (i < W - 1)
      x[j] = ((int)(((uint32_t)x[j] + 32768u) & 0xFFFFu) - 32768) + prev;
    else if (i == W - 1)
      x[j] = x[j] + prev;
    else
      x[j] = 0;
  }
}

// Floor carry pass (limb._bound_limbs): limbs below the top land in
// [0, 2^16) plus the carry of the limb below.
template <int NPT>
__device__ __forceinline__ void floor_pass(int (&x)[NPT], int lane, int W) {
  int c[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) c[j] = x[j] >> 16;
  int cin = __shfl_up_sync(WL_FULL, c[NPT - 1], 1);
  if (lane == 0) cin = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    int prev = j == 0 ? cin : c[j - 1];
    if (i < W - 1)
      x[j] = (x[j] & 0xFFFF) + prev;
    else if (i == W - 1)
      x[j] = x[j] + prev;
    else
      x[j] = 0;
  }
}

// Maps {-1,0,1} -> {-1,0,1} coded as 9*(f(-1)+1) + 3*(f(0)+1) + (f(1)+1).
__device__ __forceinline__ int map_apply(int code, int c) {
  int v = c < 0 ? code / 9 : (c > 0 ? code % 3 : (code / 3) % 3);
  return v - 1;
}
// code of (g o h)
__device__ __forceinline__ int map_compose(int g, int h) {
  return 9 * (map_apply(g, map_apply(h, -1)) + 1) +
         3 * (map_apply(g, map_apply(h, 0)) + 1) +
         (map_apply(g, map_apply(h, 1)) + 1);
}
#define WL_ID_MAP 5

// limb.canonicalize_fast: redundant signed limbs (|value| < 2^(16 W)) ->
// (sign, canonical magnitude in x). Two floor passes bound the lower limbs
// to [-1, 2^16]; each lower limb's carry-out is then a map of its carry-in;
// a warp scan over the per-thread composed maps gives every carry.
template <int NPT>
__device__ __forceinline__ int canonicalize(int (&x)[NPT], int lane, int W) {
  floor_pass<NPT>(x, lane, W);
  floor_pass<NPT>(x, lane, W);
  int tmap = WL_ID_MAP;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    if (i < W - 1) {
      int v = x[j];
      int code = 9 * (((v - 1) >> 16) + 1) + 3 * ((v >> 16) + 1) +
                 (((v + 1) >> 16) + 1);
      tmap = map_compose(code, tmap);
    }
  }
  // inclusive scan over threads: prefix_t = tmap_t o ... o tmap_0
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int lower = __shfl_up_sync(WL_FULL, tmap, d);
    if (lane >= d) tmap = map_compose(tmap, lower);
  }
  int below = __shfl_up_sync(WL_FULL, tmap, 1);
  int c = lane == 0 ? 0 : map_apply(below, 0);
  int final_c = 0;
  int top_lane = (W - 1) / NPT;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    int t = x[j] + c;
    if (i < W) {
      x[j] = t & 0xFFFF;
      c = t >> 16;
      if (i == W - 1) final_c = c;
    } else {
      x[j] = 0;
    }
  }
  int is_neg = __shfl_sync(WL_FULL, final_c, top_lane) < 0;
  if (is_neg) {
    // 2^(16 W) - mag: zeros below the lowest nonzero limb, 2^16 - limb
    // there, 2^16 - 1 - limb above
    bool mine = false;
#pragma unroll
    for (int j = 0; j < NPT; j++) mine |= x[j] != 0;
    uint32_t nzmask = __ballot_sync(WL_FULL, mine);
    bool seen = (nzmask & ((1u << lane) - 1u)) != 0;
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      int i = lane * NPT + j;
      if (i >= W) continue;
      if (seen) {
        x[j] = 0xFFFF - x[j];
      } else if (x[j] != 0) {
        x[j] = 0x10000 - x[j];
        seen = true;
      }
    }
  }
  bool nz = false;
#pragma unroll
  for (int j = 0; j < NPT; j++) nz |= x[j] != 0;
  bool any_nz = __any_sync(WL_FULL, nz);
  return any_nz ? (is_neg ? -1 : 1) : 0;
}

// limb.mag_cmp of canonical magnitudes.
template <int NPT>
__device__ __forceinline__ int mag_cmp(const int (&a)[NPT],
                                       const int (&b)[NPT], int lane) {
  int res = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    if (a[j] != b[j]) res = a[j] > b[j] ? 1 : -1;  // highest slot wins
  }
  uint32_t has = __ballot_sync(WL_FULL, res != 0);
  if (has == 0) return 0;
  return __shfl_sync(WL_FULL, res, 31 - __clz(has));
}

// rl.value_est: value ~= mant * 2^(16 top) for balanced limbs; (0, 0) for 0.
template <int NPT>
__device__ __forceinline__ void value_est(const int (&x)[NPT], int lane,
                                          float& mant, int& top) {
  int t = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++)
    if (x[j] != 0) t = lane * NPT + j;
  top = __reduce_max_sync(WL_FULL, t);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    if (i <= top) s += (float)x[j] * pow2f(16 * (i - top));
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) s += __shfl_xor_sync(WL_FULL, s, d);
  mant = s;
}

// ---- 64-bit steering (K3) and int64 limb sums (K2, K3)

// 2^e as f64 from its exponent bits; 0 below -1022, clamped at 1023
// (rl.pow2d).
__device__ __forceinline__ double pow2d(long long e) {
  if (e < -1022) return 0.0;
  if (e > 1023) e = 1023;
  return __longlong_as_double((e + 1023) << 52);
}

// rl.value_est_wide: value ~= mant * 2^(16 top) from the top four limbs,
// the top three summed exactly in int64 and the fourth added in f64, so
// every thread (and the plain version) gets the same double.
template <int NPT>
__device__ __forceinline__ void value_est_wide(const int (&x)[NPT], int lane,
                                               double& mant, int& top) {
  int t = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++)
    if (x[j] != 0) t = lane * NPT + j;
  top = __reduce_max_sync(WL_FULL, t);
  long long p = 0;
  int q = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int k = top - (lane * NPT + j);
    if (k >= 0 && k <= 2) p += (long long)x[j] * (1LL << (16 * (2 - k)));
    if (k == 3) q = x[j];
  }
  const int lo = top >= 3 ? top - 3 : 0;
  long long ps = 0;
  int qs = 0;
  for (int src = lo / NPT; src <= top / NPT; src++) {  // warp-uniform
    ps += __shfl_sync(WL_FULL, p, src);
    qs += __shfl_sync(WL_FULL, q, src);
  }
  mant = ((double)ps + (double)qs * 1.52587890625e-05) *
         2.3283064365386962890625e-10;
}

// rl.spread_carry: int64 limb sums -> int32 limbs of the same value. Each
// sum splits into ND balanced 16-bit digits (the last takes the rest) and
// digit k moves k limbs up (a shuffle from the thread below where it
// crosses one), so limbs below the top land within ND * 2^15; the top limb
// W-1 keeps everything that would pass it.
template <int NPT, int ND>
__device__ __forceinline__ void spread_carry(const long long (&s)[NPT],
                                             int (&out)[NPT], int lane,
                                             int W) {
  int e[ND][NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    long long r = s[j];
#pragma unroll
    for (int k = 0; k < ND; k++) {
      if (k < ND - 1) {
        int d = (int)(((r + 32768) & 0xFFFF) - 32768);
        e[k][j] = i == W - 1 - k ? (int)r : d;
        r = (r - d) >> 16;
      } else {
        e[k][j] = (int)r;
      }
    }
  }
  int acc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    acc[j] = e[0][j];
#pragma unroll
    for (int k = 1; k < ND; k++)
      if (j - k >= 0) acc[j] += e[k][j - k];
  }
#pragma unroll
  for (int tb = 1; tb <= (ND - 1 + NPT - 1) / NPT; tb++) {
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      int send = 0;
      bool any = false;
#pragma unroll
      for (int k = 1; k < ND; k++) {
        const int src = j - k;
        if (src < 0 && (-src + NPT - 1) / NPT == tb) {
          send += e[k][src + tb * NPT];
          any = true;
        }
      }
      if (any) {
        int v = __shfl_up_sync(WL_FULL, send, tb);
        if (lane >= tb) acc[j] += v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; j++) out[j] = lane * NPT + j < W ? acc[j] : 0;
}

}  // namespace wl
