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

// A carry map f: {-1, 0, 1} -> {-1, 0, 1} as f(c) + 1 in bits 2 (c + 1) ..
// 2 (c + 1) + 1 of an int, so that applying and composing maps are shifts
// and masks; WL_ID_MAP is the identity.
__device__ __forceinline__ int map_apply(int f, int c) {
  return ((f >> (2 * (c + 1))) & 3) - 1;
}
// g o h
__device__ __forceinline__ int map_compose(int g, int h) {
  return ((g >> (2 * (h & 3))) & 3) | (((g >> (2 * ((h >> 2) & 3))) & 3) << 2) |
         (((g >> (2 * ((h >> 4) & 3))) & 3) << 4);
}
#define WL_ID_MAP (0 | 1 << 2 | 2 << 4)

// 2^(16 W) - x mod 2^(16 W) of canonical limbs x: zeros below the lowest
// nonzero limb, 2^16 - limb there, 2^16 - 1 - limb above.
template <int NPT>
__device__ __forceinline__ void negate_canonical(int (&x)[NPT], int lane, int W) {
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

// limb.canonicalize_fast of N rows at once: redundant signed limbs
// (|value| < 2^(16 W)) -> canonical magnitudes in x, signs in sg. Two floor
// passes bound the lower limbs to [-1, 2^16]; each lower limb's carry-out
// is then a map of its carry-in; a warp scan over the per-thread composed
// maps gives every carry. The rows' collectives run side by side (one
// shuffle level for all of them), the negation of a negative row is a
// select, and the row's nonzero ballot gives both the negation's start and
// the sign.
template <int NPT, int N>
__device__ __forceinline__ void canonicalize_rows(int (&x)[N][NPT],
                                                  int (&sg)[N], int lane,
                                                  int W) {
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {  // floor_pass on every row
    int cin[N];
#pragma unroll
    for (int r = 0; r < N; r++)
      cin[r] = __shfl_up_sync(WL_FULL, x[r][NPT - 1] >> 16, 1);
#pragma unroll
    for (int r = 0; r < N; r++) {
      int prev = lane == 0 ? 0 : cin[r];
#pragma unroll
      for (int j = 0; j < NPT; j++) {
        const int i = lane * NPT + j, v = x[r][j], c = v >> 16;
        x[r][j] = i < W - 1 ? (v & 0xFFFF) + prev : (i == W - 1 ? v + prev : 0);
        prev = c;
      }
    }
  }
  int tm[N];  // each thread's composed carry map
#pragma unroll
  for (int r = 0; r < N; r++) {
    tm[r] = WL_ID_MAP;
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      if (lane * NPT + j < W - 1) {  // limb v's carry out for each carry in
        const int v = x[r][j];
        const int f = (((v - 1) >> 16) + 1) | (((v >> 16) + 1) << 2) |
                      ((((v + 1) >> 16) + 1) << 4);
        tm[r] = map_compose(f, tm[r]);
      }
    }
  }
  // inclusive scan over threads: prefix_t = tmap_t o ... o tmap_0
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int lower[N];
#pragma unroll
    for (int r = 0; r < N; r++) lower[r] = __shfl_up_sync(WL_FULL, tm[r], d);
#pragma unroll
    for (int r = 0; r < N; r++)
      if (lane >= d) tm[r] = map_compose(tm[r], lower[r]);
  }
  int below[N];
#pragma unroll
  for (int r = 0; r < N; r++) below[r] = __shfl_up_sync(WL_FULL, tm[r], 1);
  const int top_lane = (W - 1) / NPT;
  int fin[N];
  bool mine[N];
#pragma unroll
  for (int r = 0; r < N; r++) {
    int c = lane == 0 ? 0 : map_apply(below[r], 0);
    fin[r] = 0;
    mine[r] = false;
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      const int i = lane * NPT + j, t = x[r][j] + c;
      x[r][j] = i < W ? t & 0xFFFF : 0;
      c = t >> 16;
      if (i == W - 1) fin[r] = c;
      mine[r] |= x[r][j] != 0;
    }
  }
  bool neg[N];
  uint32_t nz[N];
#pragma unroll
  for (int r = 0; r < N; r++) {
    neg[r] = __shfl_sync(WL_FULL, fin[r], top_lane) < 0;
    nz[r] = __ballot_sync(WL_FULL, mine[r]);
  }
#pragma unroll
  for (int r = 0; r < N; r++) {
    // 2^(16 W) - mag where negative (negate_canonical as a select)
    bool seen = (nz[r] & ((1u << lane) - 1u)) != 0;
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      const int v = x[r][j];
      const int nv = seen ? 0xFFFF - v : (v != 0 ? 0x10000 - v : 0);
      seen |= v != 0;
      if (neg[r] && lane * NPT + j < W) x[r][j] = nv;
    }
    sg[r] = nz[r] == 0 ? 0 : (neg[r] ? -1 : 1);
  }
}

// One row of canonicalize_rows; returns its sign.
template <int NPT>
__device__ __forceinline__ int canonicalize(int (&x)[NPT], int lane, int W) {
  int sg[1];
  canonicalize_rows<NPT, 1>(reinterpret_cast<int(&)[1][NPT]>(x), sg, lane, W);
  return sg[0];
}

// limb.mag_shr_bits(x, s) of a canonical row, 0 <= s < 16: limb i becomes
// (x_i >> s) | ((x_{i+1} << (16 - s)) & 0xFFFF), the limb above a thread's
// last one from the next thread (0 past the row: padding limbs are 0).
template <int NPT>
__device__ __forceinline__ void shr_bits(const int (&x)[NPT], int (&out)[NPT],
                                         int s, int lane) {
  int up = __shfl_down_sync(WL_FULL, x[0], 1);
  if (lane == 31) up = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int nxt = j + 1 < NPT ? x[j + 1] : up;
    out[j] = (x[j] >> s) | (int)(((uint32_t)nxt << (16 - s)) & 0xFFFFu);
  }
}

// limb.mag_cmp of canonical magnitudes, from two independent ballots (where
// the highest differing limb is, and whether it is greater there).
template <int NPT>
__device__ __forceinline__ int mag_cmp(const int (&a)[NPT],
                                       const int (&b)[NPT], int lane) {
  int res = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    if (a[j] != b[j]) res = a[j] > b[j] ? 1 : -1;  // highest slot wins
  }
  const uint32_t has = __ballot_sync(WL_FULL, res != 0);
  const uint32_t gt = __ballot_sync(WL_FULL, res > 0);
  if (has == 0) return 0;
  return (gt >> (31 - __clz(has))) & 1u ? 1 : -1;
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

// ---- ordered estimates and the JAX digit (K7)

// floor(a / b) for b != 0 (torch's floor division; C's `/` truncates).
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// rl.log2f_i: the f32 exponent of |v|, -200 for 0.
__device__ __forceinline__ int log2f_i(float v) {
  return v == 0.0f ? -200 : ((__float_as_int(fabsf(v)) >> 23) - 127);
}

// rl.digit_est(mx, tx, mm, tm, D, exp_clamp=D + 2) with no jmax, the JAX
// package's digit: q ~= qd * 2^(16 j), |qd| < 2^D, for positive mm.
__device__ __forceinline__ void digit_est_jax(float mx, int tx, float mm,
                                              int tm, int D, int& qd,
                                              int& j) {
  const float ratio = mx / fmaxf(mm, 1e-30f);
  const int ebits = 16 * (tx - tm);
  const int qbits = ebits + log2f_i(ratio) + 1;
  j = max(floordiv(qbits - D + 15, 16), 0);
  const int e = min(max(ebits - 16 * j, -126), D + 2);
  const float lim = (float)((1 << D) - 1);
  qd = (int)fminf(fmaxf(rintf(ratio * pow2f(e)), -lim), lim);
}

// XLA-CPU's order for a row of 19-32 terms (rl._XLA_PLANS): lane k of V
// sums t[off + k] over the offsets in order, the lanes are halved down to
// one, then the tail from START is added one term at a time, or (PAIRED)
// the even term of each pair into the sum and the odd one into a second
// sum that joins before an unpaired last term.
template <int V, int NOFF>
__device__ __forceinline__ float xla_lanes(const float (&t)[32],
                                           const int (&off)[NOFF]) {
  float l[V];
#pragma unroll
  for (int k = 0; k < V; k++) {
    l[k] = t[off[0] + k];
#pragma unroll
    for (int o = 1; o < NOFF; o++) l[k] = l[k] + t[off[o] + k];
  }
#pragma unroll
  for (int h = V / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; k++) l[k] = l[k] + l[k + h];
  }
  return l[0];
}

template <int START, bool PAIRED>
__device__ __forceinline__ float xla_tail(float acc, const float (&t)[32],
                                          int n) {
  int q0 = START;
  if (PAIRED) {
    float odd = 0.0f;
#pragma unroll
    for (int q = START; q + 1 < 32; q += 2) {
      if (q + 1 < n) {
        acc = acc + t[q];
        odd = odd + t[q + 1];
      }
    }
    acc = acc + odd;
    q0 = START + 2 * ((n - START) / 2);
  }
#pragma unroll
  for (int q = START; q < 32; q++)
    if (q >= q0 && q < n) acc = acc + t[q];
  return acc;
}

// rl._sum_xla_row of n <= 32 terms (t[i] = 0 for i >= n).
__device__ __forceinline__ float sum_xla_row(const float (&t)[32], int n) {
  if (n <= 18) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; i++)
      if (i < n) acc = acc + t[i];
    return acc;
  }
  if (n == 19) {
    constexpr int off[] = {0, 8};
    return xla_tail<16, true>(xla_lanes<8, 2>(t, off), t, n);
  }
  if (n <= 23) {
    constexpr int off[] = {0, 4, 8, 12};
    return xla_tail<16, true>(xla_lanes<4, 4>(t, off), t, n);
  }
  if (n <= 27) {
    constexpr int off[] = {0, 8, 16};
    return xla_tail<24, true>(xla_lanes<8, 3>(t, off), t, n);
  }
  if (n <= 31) {
    constexpr int off[] = {0, 8, 16, 12, 4, 20};
    return xla_tail<24, false>(xla_lanes<4, 6>(t, off), t, n);
  }
  constexpr int off[] = {0, 8, 16, 24};
  return xla_lanes<8, 4>(t, off);
}

// v * 2^E exactly, for |v| <= 2^22 and -112 <= E <= 0: v added into the
// mantissa of 1.5 * 2^(23 + E), whose unit is 2^E, and that number taken
// away again (an integer and a float add in place of a conversion and a
// product; the shorter of the two on K7's estimates).
__device__ __forceinline__ float magic_term(int v, int E) {
  const float m = __int_as_float((150 + E) << 23 | 0x400000);  // 1.5 * 2^(23 + E)
  return __int_as_float(__float_as_int(m) + v) - m;
}

// rl._log2_f32 and bits_est, bit for bit, with the exponent and 16 top
// converted as magic_term does (K7's estimates; K2 keeps bits_est).
__device__ __forceinline__ float bits_est_magic(float mant, int top) {
  const float tiny = 1e-30f;
  const float v = fabsf(mant);
  const int bits = __float_as_int(fmaxf(v, tiny));
  const float e = magic_term((bits >> 23) - 127, 0);
  const float frac = __int_as_float((bits & 0x7FFFFF) | (127 << 23));
  const float approx = e + (frac - 1.0f) * (2.0f - frac * 0.5f) * 0.7219281f;
  return magic_term(16 * top, 0) + (v <= tiny ? -200.0f : approx);
}

// rl.value_est_ordered of N rows side by side: value_est with the
// mantissa rounded step by step in the order XLA's CPU backend sums the
// JAX package's value_est (rl._sum_ordered), so that every decision taken
// on it is the plain version's. A term is limb i times 2^(16 (i - top)),
// exact in f32; only limbs top - 7 .. top give nonzero terms (pow2f is 0
// below 2^-126), and adding a zero is exact, so the sum runs over those
// eight, in the order the whole row's sum meets them: left to right for
// rows of at most 18 limbs; for rows past 32, whose windows of 32 limbs
// (after (32 - W % 32) % 32 / 2 zeros in front) are summed left to right
// and then added left to right, the eight split at the window cut into
// two left-to-right sums that are then added. The rows' top limbs come
// from N warp maxima taken back to back; the rows are staged in `stage`
// (N rows of 8 + 32 NPT ints in this warp's shared memory, the first 8
// zero: limb i at 8 + i, so limbs below 0 read as 0) and every thread
// reads the eight terms of each row by broadcast loads. A row of 19-32
// limbs (one limb a thread) takes all its terms by 32 shuffles and
// sum_xla_row.
// BALANCED: the limbs below each row's top are below 2^22 in magnitude (a
// carried row), so each of their terms converts as magic_term does; else
// by I2F and a product.
template <int NPT, int N, bool BALANCED>
__device__ __forceinline__ void value_est_ordered_rows(
    const int (&x)[N][NPT], int (*stage)[8 + 32 * NPT], int lane, int W,
    float (&mant)[N], int (&top)[N]) {
  int tl[N];  // each thread's highest nonzero limb, a max over its limbs
#pragma unroll
  for (int r = 0; r < N; r++) {
    tl[r] = 0;
#pragma unroll
    for (int j = 0; j < NPT; j++) tl[r] = max(tl[r], x[r][j] != 0 ? lane * NPT + j : 0);
  }
#pragma unroll
  for (int r = 0; r < N; r++) top[r] = __reduce_max_sync(WL_FULL, tl[r]);
  if (NPT == 1 && W > 18) {
#pragma unroll
    for (int r = 0; r < N; r++) {
      const float mine = (float)x[r][0] * pow2f(16 * (lane - top[r]));
      float t[32];
#pragma unroll
      for (int i = 0; i < 32; i++) t[i] = __shfl_sync(WL_FULL, mine, i);
      mant[r] = sum_xla_row(t, W);
    }
    return;
  }
  __syncwarp();  // the previous reads of the stage are done
#pragma unroll
  for (int r = 0; r < N; r++) {
#pragma unroll
    for (int j = 0; j < NPT; j++) stage[r][8 + lane * NPT + j] = x[r][j];
  }
  __syncwarp();
  const int front = ((32 - W % 32) % 32) / 2;
#pragma unroll
  for (int r = 0; r < N; r++) {
    // the term k (limb top - 7 + k) that opens a window, if any (else 8):
    // the terms before it and from it on are two left-to-right sums, each
    // with the other's terms as zeros (exact: no term or sum is -0)
    int kc = (32 - ((top[r] - 7 + front) & 31)) & 31;
    if (!(W > 32 && kc >= 1 && kc <= 7 && top[r] - 7 + kc > 0)) kc = 8;
    float left = 0.0f, right = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int v = stage[r][top[r] + 1 + k];
      const float term = BALANCED && k < 7 ? magic_term(v, 16 * (k - 7))
                                           : (float)v * pow2f(16 * (k - 7));
      left = left + (k < kc ? term : 0.0f);
      right = right + (k < kc ? 0.0f : term);
    }
    mant[r] = left + right;
  }
}

// rl.carry_pass of N rows side by side: the N carries that cross threads
// go by N independent shuffles; a limb's balanced low part,
// ((v + 2^15) mod 2^16) - 2^15, is its low 16 bits sign-extended.
template <int NPT, int N>
__device__ __forceinline__ void carry_pass_rows(int (&x)[N][NPT], int lane,
                                                int W) {
  int cin[N];
#pragma unroll
  for (int r = 0; r < N; r++)
    cin[r] = __shfl_up_sync(WL_FULL, (int)((uint32_t)x[r][NPT - 1] + 32768u) >> 16, 1);
#pragma unroll
  for (int r = 0; r < N; r++) {
    int prev = lane == 0 ? 0 : cin[r];
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      const int i = lane * NPT + j, v = x[r][j];
      const int c = (int)((uint32_t)v + 32768u) >> 16;
      x[r][j] = i < W - 1 ? (int)(int16_t)v + prev : (i == W - 1 ? v + prev : 0);
      prev = c;
    }
  }
}

// floor(f) for |f| < 2^22: f added to 1.5 * 2^23 rounding down (unit 1),
// read back from the bits (where F2I would queue on the conversion unit).
// Monotone in f for f > -1.5 * 2^23, and of magnitude >= 2^22 past 2^22.
__device__ __forceinline__ int floor_small(float f) {
  return __float_as_int(__fadd_rd(f, 12582912.0f)) - 0x4B400000;
}

// 1 / b as f32 within 2^-23 (MUFU.RCP alone: PTX rcp.approx.ftz, no
// range handling, which |b| < 2^31 does not need). Volatile, so that it
// issues where it is written, ahead of the branches that use it.
__device__ __forceinline__ float rcp_f32(float b) {
  float r;
  asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  return r;
}

// floor(a / b) for |a| < 2^28 and |b| >= 33 with no integer division,
// from the estimate qe of a / b (relative error below 2^-20, as (float)a *
// rcp_f32((float)b) has: three roundings to f32 and the reciprocal's
// 2^-23): qe floored as floor_small does, then one correction by the
// remainder r = a - q b taken with b's sign on both, from sa = s a and
// nb = -s b (s = sign b; both off the quotient's chain). Exact where |a /
// b| < 2^19 (qe within half of a / b, r in int32); elsewhere, since
// floor_small's reading of the bits is monotone below 1.5 * 2^23 (|qe| <
// 2^28 / 33 is), a value of a / b's sign and magnitude above 2^18, which a
// clip to |q| <= 2^13 takes to the same bound as the floor.
__device__ __forceinline__ int floor_quot(int sa, int nb, float qe) {
  const int q = floor_small(qe);
  const int r = (int)((uint32_t)sa + (uint32_t)q * (uint32_t)nb);
  return q + (r >> 31) - ((-nb - 1 - r) >> 31);  // -1 if r < 0, +1 if r >= |b|
}

// floor(n / e) for 0 <= n < 2^14, 1 <= e < 2^14: the estimate and one
// correction, as floor_quot.
__device__ __forceinline__ int quot_small(int n, int e) {
  const int q = floor_small((float)n * rcp_f32((float)e));
  const int r = n - q * e;
  return q + (r >= e) - (r < 0);
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
// every thread (and the plain version) gets the same double. The top four
// limbs lie on at most kSrc threads, read by a fixed number of shuffles
// (straight-line code, so two estimates side by side interleave).
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
  constexpr int kSrc = (3 + NPT - 1) / NPT + 1;
  const int first = (top >= 3 ? top - 3 : 0) / NPT;
  long long ps = 0;
  int qs = 0;
#pragma unroll
  for (int k = 0; k < kSrc; k++) {  // warp-uniform
    const long long pk = __shfl_sync(WL_FULL, p, first + k);
    const int qk = __shfl_sync(WL_FULL, q, first + k);
    if (first + k <= top / NPT) {
      ps += pk;
      qs += qk;
    }
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

// ---- nonnegative limbs and 64-bit column sums (K5m, K5d, K4)

// Nonnegative limbs (each below 2^30) -> canonical limbs of their value mod
// 2^(16 W) (limb.canonicalize_nonneg). Two floor passes bound every limb but
// the top to [0, 2^16], so each carry is 0 or 1: a thread's block of lower
// limbs generates a carry (g), stops it, or passes its carry-in on (p), and
// the highest deciding block below a thread gives its carry-in, from two
// ballots. The top limb drops what passes it.
template <int NPT>
__device__ __forceinline__ void carry_nonneg(int (&x)[NPT], int lane, int W) {
  floor_pass<NPT>(x, lane, W);
  floor_pass<NPT>(x, lane, W);
  bool g = false, p = true;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    if (lane * NPT + j < W - 1) {
      const bool pl = x[j] == 0xFFFF;
      g = x[j] > 0xFFFF || (pl && g);
      p = pl && p;
    }
  }
  const uint32_t G = __ballot_sync(WL_FULL, g);
  const uint32_t decides = (G | ~__ballot_sync(WL_FULL, p)) & ((1u << lane) - 1u);
  int c = decides ? (int)((G >> (31 - __clz(decides))) & 1u) : 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int t = x[j] + c;
    x[j] = lane * NPT + j < W ? (t & 0xFFFF) : 0;
    c = t >> 16;
  }
}

// 64-bit column sums s (each in [0, 2^46)) -> nonnegative limbs (below
// 2^31) of the same value mod 2^(16 W), for carry_nonneg: limb i takes the
// low 16 bits of s_i and the rest of s_(i-1).
template <int NPT, typename T>
__device__ __forceinline__ void split_u64(const T (&s)[NPT], int (&x)[NPT],
                                          int lane, int W) {
  T below = __shfl_up_sync(WL_FULL, s[NPT - 1], 1);
  if (lane == 0) below = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const T prev = j == 0 ? below : s[j - 1];
    x[j] = lane * NPT + j < W ? (int)(s[j] & 0xFFFF) + (int)(prev >> 16) : 0;
  }
}

// ---- Hensel digits in blocks (K5d's quotient, K4's Montgomery digits)

// A divisor row's L limbs, each read as its low 16 bits, into shared memory
// (lane-strided); returns its significant limbs, 1 + the index of its top
// nonzero limb (0 for zero), by a warp max. Ends with __syncwarp.
__device__ __forceinline__ int load_divisor(uint32_t* dst, const int* src,
                                            int L, int lane) {
  int top = 0;
  for (int i = lane; i < L; i += 32) {
    const uint32_t v = (uint32_t)src[i] & 0xFFFFu;
    dst[i] = v;
    if (v) top = i + 1;
  }
  __syncwarp();
  return __reduce_max_sync(WL_FULL, top);
}

// One block step of hensel_steps: block o (thread o's positions [o NPT,
// o NPT + NPT)) takes n digits, NPT when FULL.
template <int NPT, bool FULL>
__device__ __forceinline__ void hensel_block(unsigned long long (&r)[NPT],
                                             int (&q)[NPT],
                                             const uint32_t (&dlo)[NPT],
                                             const uint32_t* div, int nd,
                                             uint32_t inv, int o, int n,
                                             uint32_t& cin, int lane) {
  constexpr int NW = (NPT + 1) / 2;  // digit words a hand-over
  uint32_t t[NPT];
  uint32_t cout = 0;
#pragma unroll
  for (int s = 0; s < NPT; s++) t[s] = 0u;
  if (lane == o) {
    r[0] += cin;
#pragma unroll
    for (int s = 0; s < NPT; s++) {
      if (FULL || s < n) {
        if (s > 0) r[s] += r[s - 1] >> 16;
        t[s] = ((uint32_t)r[s] * inv) & 0xFFFFu;
#pragma unroll
        for (int j = s; j < NPT; j++)
          r[j] += (unsigned long long)t[s] * dlo[j - s];
        q[s] = (int)t[s];
      }
    }
    cout = (uint32_t)(r[NPT - 1] >> 16);
  }
  uint32_t w[NW];
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const uint32_t hi = 2 * i + 1 < NPT ? t[2 * i + 1] << 16 : 0u;
    w[i] = __shfl_sync(WL_FULL, t[2 * i] | hi, o);
  }
  cin = __shfl_sync(WL_FULL, cout, o);
#pragma unroll
  for (int s = 0; s < NPT; s++) t[s] = (w[s / 2] >> (16 * (s % 2))) & 0xFFFFu;
  // slot j of this thread takes digit s times div[base + j - s]
  const int base = (lane - o) * NPT;
  if (lane > o && base - (NPT - 1) < nd) {
    uint32_t dw[2 * NPT - 1];
#pragma unroll
    for (int i = 0; i < 2 * NPT - 1; i++) {
      const int m = base - (NPT - 1) + i;  // >= 1
      dw[i] = m < nd ? div[m] : 0u;
    }
#pragma unroll
    for (int j = 0; j < NPT; j++) {
#pragma unroll
      for (int s = 0; s < NPT; s++)
        r[j] += (unsigned long long)t[s] * dw[j - s + NPT - 1];
    }
  }
}

// `steps` Montgomery digits, LSB first, in blocks of NPT: block o is thread
// o's positions [o NPT, o NPT + NPT), the last block holds the digits left
// (steps - o NPT). r holds x + Q div as 64-bit sums at fixed positions,
// never shifted; div is the divisor's low 16 bits in shared memory, of
// which nd are significant (div[m] = 0 for m >= nd adds nothing and is not
// multiplied); inv = -div^-1 mod 2^16. One block step:
//  1. the owner, thread o, adds the carry of position o NPT - 1 to its
//     first position and takes its digits one after another in registers:
//     digit s is (position s mod 2^16) * inv mod 2^16 (kept in q[s]); d_s *
//     div[m] joins its positions s + m (m < NPT, from registers), and
//     position s's carry, a multiple of 2^16 by then, joins position s + 1;
//  2. it hands the warp its digits, two a word, and the carry of its last
//     position: ceil(NPT / 2) + 1 independent shuffles;
//  3. each thread above it within reach of the divisor adds d_s * div[m]
//     to its positions (m = position - (o NPT + s) < nd, from shared
//     memory), NPT digits on NPT positions.
// So the chain is ceil(steps / NPT) hand-overs and `steps` digits on one
// thread's registers, every register index static, every product one
// 32 x 32 -> 64-bit multiply-add, and the products run over the divisor's
// significant limbs only. The digits are Q = -x div^-1 mod 2^(16 steps).
// Position steps - 1 keeps its carry and positions below it hold spent
// sums (multiples of 2^16 whose carries have moved up): with those cleared
// and the sums split (split_u64), the positions from `steps` on are (x + Q
// div) / 2^(16 steps) (K4). Positions past the row's width take products
// too and are never read.
// Each position p receives x_p (below 2^16), the products d_k div[p - k]
// for k <= p, k < steps, p - k < nd, the ones the limb-by-limb Hensel loop
// gives it, and the carry of p - 1 once. Worst case: 288 products of
// (2^16 - 1)^2 beside x_p and a carry below 2^25 (the position below over
// 2^16), all nonnegative, so every sum stays below 288 * 2^32 + 2^26 <
// 2^41.
template <int NPT>
__device__ __forceinline__ void hensel_steps(unsigned long long (&r)[NPT],
                                             int (&q)[NPT],
                                             const uint32_t* div, int nd,
                                             uint32_t inv, int steps,
                                             int lane) {
  uint32_t dlo[NPT];  // the divisor's low limbs, for the owner
#pragma unroll
  for (int m = 0; m < NPT; m++) dlo[m] = m < nd ? div[m] : 0u;
  uint32_t cin = 0;  // the carry into the next owner's first position
  const int full = steps / NPT, rest = steps - full * NPT;
  for (int o = 0; o < full; o++)
    hensel_block<NPT, true>(r, q, dlo, div, nd, inv, o, NPT, cin, lane);
  if (rest > 0)
    hensel_block<NPT, false>(r, q, dlo, div, nd, inv, full, rest, cin, lane);
}

}  // namespace wl
