// K2: batched x mod m on Hopper (sm_90a).
//
// Replaces the TPU kernel cofhe_tpu/ops/pallas_group.py::mod_topdown (its
// body is cofhe_tpu/ops/rl.py::mod_topdown) and computes the JAX package's
// 28-bit-digit variant rl.mod_topdown28, whose plain torch version is
// cofhe_tpu_torch/ops/rl.py::mod_topdown28: x mod m into [0, m) for signed
// redundant x (B, L) and canonical m (B, Lm), Lm < L. Each iteration takes
// a 28-bit digit qd and a limb shift j from f32 estimates (rl.digit_est,
// q ~= qd * 2^(16 j)), subtracts qd * m * 2^(16 j) and carries; an exact
// tail of at most two fixes ends it. x mod m is unique, so the output is
// the plain version's and rl.mod_topdown's bit for bit.
//
// What bounds it on this card: integer operations, per iteration and live
// limb one 32x32->64 product, a 3-digit spread, one balanced carry pass
// (the f32 estimate needs balanced limbs) and a value estimate, for
// ~(bits(x) - bits(m)) / 20 iterations (a digit at a 16-bit limb shift
// carries 13-28 bits); the bytes (x and m read once, the result written
// once) are small beside them. At the main path's batches (128-256 lanes,
// one warp a lane) the time is the latency of one warp's loop. The design:
// x lives in a per-warp row of shared memory; each iteration loads only
// the live window x[j .. j + 32*NPW) (NPW = ceil((Lm + 3) / 32), 5 limbs a
// thread at Lm = 144 instead of 9 over all of x), so the j-limb shift is
// an address offset and m stays one register-resident row with no m<<12 /
// m<<14 copy; the product is one 64-bit multiply a limb and the spread one
// shuffle a digit. The window always holds x's top limb and the product
// (a guard raises j in the case it would not). Tensor cores and TMA do not
// fit: a different scalar per lane times one row, read once. Launch
// shape: four lanes a block. At 128-256 lanes a warp's loop is latency
// bound, and one, two or four lanes a block measured within 3% of each
// other on the main path's operands (PERF.md), so the shape is fixed.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;      // lanes (warps) per block
constexpr int kMaxLimbs = 288; // 9 limbs x 32 threads
constexpr int kFull = 9;       // limbs a thread over a whole row
constexpr float kDigitLim = 268435455.0f;  // 2^28 - 1

// rl.log2f_i
__device__ __forceinline__ int log2f_i(float m) {
  if (m == 0.0f) return -200;
  return (__float_as_int(fabsf(m)) >> 23) - 127;
}

// qd ~= ratio * 2^(ebits - 16 j), clipped to 28 bits (rl.digit_est's digit
// for a given j; the exponent clamp of 60 only guards f32 overflow)
__device__ __forceinline__ int digit_at(float ratio, int ebits, int j) {
  int e = ebits - 16 * j;
  e = e < -126 ? -126 : (e > 60 ? 60 : e);
  float qd = rintf(ratio * wl::pow2f(e));
  return (int)fminf(fmaxf(qd, -kDigitLim), kDigitLim);
}

template <int NPW>
__global__ void __launch_bounds__(kWarps * 32)
    mod_topdown_kernel(const int* __restrict__ x_in,
                       const int* __restrict__ m_in, int* __restrict__ out,
                       int* __restrict__ iters_out, int B, int L, int Lm,
                       int max_iters) {
  __shared__ int rowbuf[kWarps][kMaxLimbs];
  const int warp_in_block = threadIdx.x >> 5;
  const int row = (int)(blockIdx.x * kWarps + warp_in_block);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warp leaves together
  int* xs = rowbuf[warp_in_block];
  const int* mrow = m_in + (size_t)row * Lm;

  float mant_m, mant_x;
  int top_m, top_x;
  {
    int m[kFull], x[kFull];
    wl::load_row<kFull>(m, mrow, Lm, lane);
    wl::value_est<kFull>(m, lane, mant_m, top_m);
    wl::load_row<kFull>(x, x_in + (size_t)row * L, L, lane);
    wl::carry_pass<kFull>(x, lane, L);
    wl::carry_pass<kFull>(x, lane, L);
    wl::value_est<kFull>(x, lane, mant_x, top_x);
#pragma unroll
    for (int s = 0; s < kFull; s++)
      if (lane * kFull + s < L) xs[lane * kFull + s] = x[s];
  }
  __syncwarp();
  const float bits_m = wl::bits_est(mant_m, top_m);
  int mw[NPW];  // m in the window's blocked layout: limb lane*NPW + s
#pragma unroll
  for (int s = 0; s < NPW; s++) {
    int i = lane * NPW + s;
    mw[s] = i < Lm ? mrow[i] : 0;
  }
  const int jmax = L - 2 - top_m > 0 ? L - 2 - top_m : 0;
  bool w = wl::bits_est(mant_x, top_x) > bits_m - 0.75f;

  int it = 0;
  for (; it < max_iters && w; it++) {
    // rl.digit_est with 28-bit digits and j clipped to jmax; the window
    // [j, j + 32*NPW) must also hold x's top limb and its carries
    const float ratio = mant_x / fmaxf(mant_m, 1e-30f);
    const int ebits = 16 * (top_x - top_m);
    const int qbits = ebits + log2f_i(ratio) + 1;
    int j = (qbits - 28 + 15) >> 4;  // floor division
    j = j < 0 ? 0 : (j > jmax ? jmax : j);
    const int jlo = top_x + 3 - 32 * NPW;
    j = j < jlo ? jlo : j;
    const int qd = digit_at(ratio, ebits, j);
    const int wl_len = L - j < 32 * NPW ? L - j : 32 * NPW;
    long long t[NPW];
#pragma unroll
    for (int s = 0; s < NPW; s++) {
      int k = lane * NPW + s;
      int xv = k < wl_len ? xs[j + k] : 0;
      t[s] = (long long)xv - (long long)qd * (long long)mw[s];
    }
    int xo[NPW];
    wl::spread_carry<NPW, 3>(t, xo, lane, wl_len);
    // back to balanced limbs: the spread leaves limbs within 3 * 2^15, and
    // a top limb of 1 over a limb of -2^16 cancels in the f32 estimate
    wl::carry_pass<NPW>(xo, lane, wl_len);
#pragma unroll
    for (int s = 0; s < NPW; s++) {
      int k = lane * NPW + s;
      if (k < wl_len) xs[j + k] = xo[s];
    }
    __syncwarp();
    int topw;
    wl::value_est<NPW>(xo, lane, mant_x, topw);
    top_x = j + topw;
    if (mant_x == 0.0f && j > 0) {  // the window is zero: look below it
      int x[kFull];
      wl::load_row<kFull>(x, xs, L, lane);
      wl::value_est<kFull>(x, lane, mant_x, top_x);
    }
    w = wl::bits_est(mant_x, top_x) > bits_m - 0.75f;
  }
  if (iters_out != nullptr && lane == 0) iters_out[row] = it;

  // exact tail: |x| <~ 2m; canonicalize, then fold the sign / subtract m
  int x[kFull], m[kFull];
  wl::load_row<kFull>(x, xs, L, lane);
  wl::load_row<kFull>(m, mrow, Lm, lane);
  int sg = wl::canonicalize<kFull>(x, lane, L);
  for (int rep = 0; rep < 2; rep++) {
    bool ge = sg > 0 && wl::mag_cmp<kFull>(x, m, lane) >= 0;
    bool neg = sg < 0;
#pragma unroll
    for (int s = 0; s < kFull; s++)
      x[s] = sg * x[s] + (neg ? m[s] : 0) - (ge ? m[s] : 0);
    sg = wl::canonicalize<kFull>(x, lane, L);
  }
  wl::store_row<kFull>(x, out + (size_t)row * L, L, lane);
}

template <int NPW>
void launch(const int* x, const int* m, int* out, int* iters, int B, int L,
            int Lm, int max_iters, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  mod_topdown_kernel<NPW><<<blocks, kWarps * 32, 0, stream>>>(
      x, m, out, iters, B, L, Lm, max_iters);
}

}  // namespace

// Plain C entry point (bound with ctypes). x: contiguous int32 (B, L) on the
// device, m: contiguous int32 (B, Lm) with Lm < L <= 288 and Lm <= 285;
// out: (B, L); iters, when not null, receives each row's number of loop
// iterations. Returns cudaGetLastError() after the launch (0 on success);
// 1 (cudaErrorInvalidValue) for unsupported widths.
extern "C" int mod_topdown_launch(const int* x, const int* m, int* out,
                                  int* iters, int B, int L, int Lm,
                                  int max_iters, void* stream) {
  if (B <= 0) return 0;
  if (Lm < 1 || Lm >= L || L > kMaxLimbs || Lm > 32 * kFull - 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((Lm + 3 + 31) / 32) {
#define K2_CASE(n)                                                        \
  case n:                                                                 \
    launch<n>(x, m, out, iters, B, L, Lm, max_iters, s);                  \
    break;
    K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4) K2_CASE(5) K2_CASE(6)
    K2_CASE(7) K2_CASE(8) K2_CASE(9)
#undef K2_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
