// K3: batched grouped rho-descent of quadratic forms on Hopper (sm_90a).
//
// Replaces the XLA while loop of cofhe_tpu/ops/forms2.py::CG.reduce2_grouped
// (not a Pallas kernel in the JAX package; ported here because in eager
// PyTorch its ~90 iterations of ~1000 small ops dominate every compose).
// Same algorithm as the plain version cofhe_tpu_torch/ops/forms2.py::
// grouped_rho_loop: per group, up to 3 normalization / rho quotients are
// simulated on (mant f32, top) estimates of a and b (c's estimate comes from
// the invariant c = (b^2 + |Delta|) / 4a), accumulating a unimodular
// M = [[p, q], [r, s]] with entries below 2^12; M is then applied once to
// the redundant limbs of (a, b, c) with 13+12-bit split coefficients.
// The output is the redundant (a, b, c) after the loop; the exact tail
// (canonicalize + forms.reduce_batch) stays in torch.
//
// What bounds it on this card: integer operations, ~(9 products + 3 sums +
// 6 carry passes + 2 value estimates) per limb and group for ~bits/12
// groups; the bytes (3 rows in, 3 rows out) are small beside them. The
// design keeps a, b, c, their <<13 copies and the new rows in registers, one
// warp per lane with its limbs blocked over the 32 threads; the scalar
// simulation runs redundantly on every thread (warp-uniform estimates), and
// each lane leaves its loop as soon as its flags clear. Later work: fusing
// the exact tail and the compose before it (ROADMAP K6).

#include "warp_limbs.cuh"

namespace {

constexpr int kLim = 4096;  // 2^12 matrix-entry bound

struct Est {
  float m;
  int t;
};

// rl.log2f_i: floor-ish log2 |m| via the exponent bits; 0 -> -200.
__device__ __forceinline__ int log2f_i(float m) {
  if (m == 0.0f) return -200;
  return (__float_as_int(fabsf(m)) >> 23) - 127;
}

// forms2._renorm_est
__device__ __forceinline__ Est renorm(float m, int t) {
  if (m == 0.0f) return {m, t};
  int sh = log2f_i(m) >> 4;
  sh = sh < -4 ? -4 : (sh > 4 ? 4 : sh);
  return {m * wl::pow2f(-16 * sh), t + sh};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// forms2._c_est: c = (b^2 + |Delta|) / (4a) from the estimates of a and b.
__device__ __forceinline__ Est c_est(float ma, int ta, float mb, int tb,
                                     float dD_mant, int dD_top) {
  int t2b = 2 * tb;
  int tbig = t2b > dD_top ? t2b : dD_top;
  float m1 = (mb * mb) * wl::pow2f(clampi(16 * (t2b - tbig), -126, 0));
  float m2 = dD_mant * wl::pow2f(clampi(16 * (dD_top - tbig), -126, 0));
  float mc = (m1 + m2) / fmaxf(4.0f * ma, 1e-30f);
  return renorm(mc, tbig - ta);
}

// forms2.CG._flags on bit estimates: (need_norm, need_rho)
__device__ __forceinline__ void flags(float ma, int ta, float mb, int tb,
                                      float mc, int tc, bool& need_norm,
                                      bool& need_rho) {
  float bitsA = wl::bits_est(ma, ta);
  float bitsB = wl::bits_est(mb, tb);
  float bitsC = wl::bits_est(mc, tc);
  bool raw_norm = bitsB > bitsA + 0.25f;
  bool freak = bitsB - bitsA > 25.0f;
  need_rho = !raw_norm && bitsC < bitsA - 0.25f;
  need_norm = raw_norm && !freak;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <int NPT>
__device__ __forceinline__ void shl13(const int (&x)[NPT], int (&y)[NPT],
                                      int lane, int L) {
#pragma unroll
  for (int j = 0; j < NPT; j++) y[j] = (int)((uint32_t)x[j] << 13);
  wl::carry_pass<NPT>(y, lane, L);
}

// out = carry_pass(sum over (a, b, c) of coef_lo * v + coef_hi * v13)
template <int NPT>
__device__ __forceinline__ void xform(int ca, int cb, int cc,
                                      const int (&a)[NPT], const int (&a13)[NPT],
                                      const int (&b)[NPT], const int (&b13)[NPT],
                                      const int (&c)[NPT], const int (&c13)[NPT],
                                      int (&out)[NPT], int lane, int L) {
  int sa = wl::sgn(ca), ua = ca < 0 ? -ca : ca;
  int sb = wl::sgn(cb), ub = cb < 0 ? -cb : cb;
  int sc = wl::sgn(cc), uc = cc < 0 ? -cc : cc;
  int alo = (ua & 0x1FFF) * sa, ahi = (ua >> 13) * sa;
  int blo = (ub & 0x1FFF) * sb, bhi = (ub >> 13) * sb;
  int clo = (uc & 0x1FFF) * sc, chi = (uc >> 13) * sc;
  // each product is below 2^29; the six-term sum wraps like int32 tensors
#pragma unroll
  for (int j = 0; j < NPT; j++)
    out[j] = (int)((uint32_t)(alo * a[j]) + (uint32_t)(ahi * a13[j]) +
                   (uint32_t)(blo * b[j]) + (uint32_t)(bhi * b13[j]) +
                   (uint32_t)(clo * c[j]) + (uint32_t)(chi * c13[j]));
  wl::carry_pass<NPT>(out, lane, L);
}

template <int NPT>
__global__ void __launch_bounds__(128)
    reduce2_grouped_kernel(const int* __restrict__ a_in,
                           const int* __restrict__ b_in,
                           const int* __restrict__ c_in,
                           int* __restrict__ a_out, int* __restrict__ b_out,
                           int* __restrict__ c_out, int* __restrict__ iters_out,
                           int B, int L, float dD_mant, int dD_top,
                           int red_iters) {
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warp leaves together
  const size_t off = (size_t)row * (size_t)L;

  int a[NPT], b[NPT], c[NPT];
  wl::load_row<NPT>(a, a_in + off, L, lane);
  wl::load_row<NPT>(b, b_in + off, L, lane);
  wl::load_row<NPT>(c, c_in + off, L, lane);
#pragma unroll
  for (int rep = 0; rep < 2; rep++) {
    wl::carry_pass<NPT>(a, lane, L);
    wl::carry_pass<NPT>(b, lane, L);
    wl::carry_pass<NPT>(c, lane, L);
  }
  float ma, mb;
  int ta, tb;
  wl::value_est<NPT>(a, lane, ma, ta);
  wl::value_est<NPT>(b, lane, mb, tb);
  bool nn, nr;
  Est ce = c_est(ma, ta, mb, tb, dD_mant, dD_top);
  flags(ma, ta, mb, tb, ce.m, ce.t, nn, nr);
  bool on = nn || nr;

  int it = 0;
  for (; it < red_iters && on; it++) {
    // ---- scalar simulation of up to 3 quotients (warp-uniform)
    int p = 1, r = 0, qq = 0, ss = 1;
    float sma = ma, smb = mb;
    int sta = ta, stb = tb;
#pragma unroll
    for (int step = 0; step < 3; step++) {
      Est e = c_est(sma, sta, smb, stb, dD_mant, dD_top);
      bool need_norm, need_rho;
      flags(sma, sta, smb, stb, e.m, e.t, need_norm, need_rho);
      bool act = need_norm || need_rho;
      bool do_rho = act && need_rho;
      float man = do_rho ? e.m : sma;
      int tan = do_rho ? e.t : sta;
      float mbn = do_rho ? -smb : smb;
      // matrix right-multiplied by rho = [[0,-1],[1,0]]
      int p2 = do_rho ? qq : p;
      int qq2 = do_rho ? -p : qq;
      int r2 = do_rho ? ss : r;
      int ss2 = do_rho ? -r : ss;
      // digit q ~ b/2a, clipped to the remaining matrix budget
      float ratio = mbn / fmaxf(2.0f * man, 1e-30f);
      float scale = wl::pow2f(clampi(16 * (stb - tan), -126, 60));
      int col1 = max(abs(p2), abs(r2));
      int col2 = max(abs(qq2), abs(ss2));
      float qcap = (float)floordiv(kLim - col2, max(col1, 1));
      float qf = fminf(fmaxf(rintf(ratio * scale), -qcap), qcap);
      if (!act) qf = 0.0f;
      int qi = (int)qf;
      // b <- b - 2 q a at b's scale, renormalized
      float inv = wl::pow2f(clampi(16 * (tan - stb), -126, 60));
      Est nb = renorm(mbn - 2.0f * qf * man * inv, stb);
      smb = nb.m;
      stb = nb.t;
      sma = man;
      sta = tan;
      p = p2;
      r = r2;
      qq = qq2 - qi * p2;
      ss = ss2 - qi * r2;
    }
    // ---- apply M once to the limbs
    int a13[NPT], b13[NPT], c13[NPT];
    shl13<NPT>(a, a13, lane, L);
    shl13<NPT>(b, b13, lane, L);
    shl13<NPT>(c, c13, lane, L);
    int na[NPT], nb_[NPT], nc[NPT];
    xform<NPT>(p * p, p * r, r * r, a, a13, b, b13, c, c13, na, lane, L);
    xform<NPT>(2 * p * qq, p * ss + qq * r, 2 * r * ss, a, a13, b, b13, c,
               c13, nb_, lane, L);
    xform<NPT>(qq * qq, qq * ss, ss * ss, a, a13, b, b13, c, c13, nc, lane,
               L);
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      a[j] = na[j];
      b[j] = nb_[j];
      c[j] = nc[j];
    }
    wl::value_est<NPT>(a, lane, ma, ta);
    wl::value_est<NPT>(b, lane, mb, tb);
    ce = c_est(ma, ta, mb, tb, dD_mant, dD_top);
    flags(ma, ta, mb, tb, ce.m, ce.t, nn, nr);
    on = nn || nr;
  }
  if (iters_out != nullptr && lane == 0) iters_out[row] = it;
  wl::store_row<NPT>(a, a_out + off, L, lane);
  wl::store_row<NPT>(b, b_out + off, L, lane);
  wl::store_row<NPT>(c, c_out + off, L, lane);
}

template <int NPT>
void launch(const int* a, const int* b, const int* c, int* ao, int* bo,
            int* co, int* iters, int B, int L, float dD_mant, int dD_top,
            int red_iters, cudaStream_t stream) {
  const int threads = 128;  // 4 lanes (warps) per block
  const int blocks = (B + 3) / 4;
  reduce2_grouped_kernel<NPT><<<blocks, threads, 0, stream>>>(
      a, b, c, ao, bo, co, iters, B, L, dD_mant, dD_top, red_iters);
}

}  // namespace

// Plain C entry point (bound with ctypes). a, b, c: contiguous int32 (B, L)
// redundant rows on the device, L <= 288; outputs the same shape; iters,
// when not null, receives each row's number of groups. Returns
// cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for an unsupported L.
extern "C" int reduce2_grouped_launch(const int* a, const int* b,
                                      const int* c, int* ao, int* bo, int* co,
                                      int* iters, int B, int L, int dD_top,
                                      int red_iters, float dD_mant,
                                      void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 31) / 32) {
#define K3_CASE(n)                                                         \
  case n:                                                                  \
    launch<n>(a, b, c, ao, bo, co, iters, B, L, dD_mant, dD_top, red_iters, \
              s);                                                          \
    break;
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6)
    K3_CASE(7) K3_CASE(8) K3_CASE(9)
#undef K3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
