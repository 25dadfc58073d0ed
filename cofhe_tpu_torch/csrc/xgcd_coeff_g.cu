// K1: batched Bezout-coefficient xgcd on Hopper (sm_90a).
//
// Replaces the TPU kernel cofhe_tpu/ops/pallas_group.py::xgcd_coeff_g (its
// body is cofhe_tpu/ops/xgcd2.py::xgcd_coeff_g). For odd f and m | f0 it
// returns d = gcd(f, g) and the canonical cg in [0, m) with
// cg * g0 ≡ d (mod m); with need_u also cu with cu*f0 + cg*g0 ≡ d (mod m).
// Same algorithm as the plain version cofhe_tpu_torch/ops/xgcd2.py:
// Bernstein-Yang divsteps, 13 per group simulated on the low bits of limb 0,
// the 2x2 matrix applied to balanced redundant limbs, and each Bezout row
// reduced by an f32-estimated quotient plus a fused Montgomery step
// (reduce_row) so |Q| stays ~1.5m.
//
// What bounds it on this card: integer operations. Per group and lane it
// does ~20 passes over W limbs (matrix products, shifts, 5 carry passes,
// two value estimates) plus the 13-step divstep chain, for ~2.3*bits/13
// groups; its bytes are the 3 input and 2-3 output rows, read and written
// once. The design keeps all per-lane state (f, g, Q, S[, P, R], m, m<<14)
// in registers: one warp per lane, limbs spread in blocked order over the
// 32 threads (W=144 -> 5 limbs a thread), carries as one neighbour shuffle
// per pass, the top-limb search as a warp max, the f32 sum as a butterfly,
// the divstep chain computed redundantly by every thread from the broadcast
// limb 0, and each lane leaving its loop as soon as its g is zero. Later
// work: several lanes per warp for W <= 32, and fusing K1 -> K2.

#include "warp_limbs.cuh"

namespace {

constexpr int kW = 13;
constexpr int kMaskW = (1 << kW) - 1;

// xgcd2._shr_w: exact /2^13 of a redundant value that is ≡ 0 mod 2^13.
template <int NPT>
__device__ __forceinline__ void shr_w(int (&x)[NPT], int lane, int W) {
  int nxt = __shfl_down_sync(WL_FULL, x[0] & kMaskW, 1);
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int i = lane * NPT + j;
    int up = j + 1 < NPT ? (x[j + 1] & kMaskW) : nxt;
    if (i + 1 >= W) up = 0;
    x[j] = i < W ? (x[j] >> kW) + (up << (16 - kW)) : 0;
  }
}

struct Consts {
  float mant_m;
  int top_m;
  int minv_w;
};

// xgcd2.xgcd_coeff_g.reduce_row: (row) * 2^-13 mod m, ~1.5m-bounded.
template <int NPT>
__device__ __forceinline__ void reduce_row(int (&x)[NPT], const int (&m)[NPT],
                                           const int (&m14)[NPT],
                                           const Consts& k, int lane, int W) {
  wl::carry_pass<NPT>(x, lane, W);
  wl::carry_pass<NPT>(x, lane, W);
  float mant_x;
  int top_x;
  wl::value_est<NPT>(x, lane, mant_x, top_x);
  float ratio = mant_x / fmaxf(k.mant_m, 1e-30f);
  int e = 16 * (top_x - k.top_m);
  e = e < -126 ? -126 : (e > 30 ? 30 : e);
  float qf = rintf(ratio * wl::pow2f(e));
  qf = fminf(fmaxf(qf, -98303.0f), 98303.0f);
  int qd = (int)qf;
  int s = wl::sgn(qd);
  int a = qd < 0 ? -qd : qd;
  int lo = (a & 0x3FFF) * s;
  int hi = (a >> 14) * s;
  int p1[NPT], p2[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    p1[j] = lo * m[j];
    p2[j] = hi * m14[j];
  }
  wl::carry_pass<NPT>(p1, lane, W);
  wl::carry_pass<NPT>(p2, lane, W);
#pragma unroll
  for (int j = 0; j < NPT; j++) x[j] = x[j] - p1[j] - p2[j];
  int x0 = __shfl_sync(WL_FULL, x[0], 0);
  int t = wl::mulw(x0 & kMaskW, k.minv_w) & kMaskW;
#pragma unroll
  for (int j = 0; j < NPT; j++) x[j] = x[j] + t * m[j];
  shr_w<NPT>(x, lane, W);
  wl::carry_pass<NPT>(x, lane, W);
}

// xgcd2.xgcd_coeff_g.into_range (== rl.exact_mod_tail after the sign
// normalization): canonical x mod m in [0, m).
template <int NPT>
__device__ __forceinline__ void into_range(int (&x)[NPT], const int (&m)[NPT],
                                           int sf, int lane, int W) {
  int s = wl::canonicalize<NPT>(x, lane, W);
  if (sf < 0) s = -s;
  // exact tail: canonicalize, then fold the sign / subtract m twice
#pragma unroll
  for (int j = 0; j < NPT; j++) x[j] = s * x[j];
  s = wl::canonicalize<NPT>(x, lane, W);
  for (int rep = 0; rep < 2; rep++) {
    bool ge = s > 0 && wl::mag_cmp<NPT>(x, m, lane) >= 0;
    bool neg = s < 0;
#pragma unroll
    for (int j = 0; j < NPT; j++)
      x[j] = s * x[j] + (neg ? m[j] : 0) - (ge ? m[j] : 0);
    s = wl::canonicalize<NPT>(x, lane, W);
  }
}

template <int NPT, bool NEED_U>
__global__ void __launch_bounds__(128)
    xgcd_coeff_g_kernel(const int* __restrict__ f_in,
                        const int* __restrict__ g_in,
                        const int* __restrict__ m_in, int* __restrict__ d_out,
                        int* __restrict__ cg_out, int* __restrict__ cu_out,
                        int* __restrict__ iters_out, int B, int W,
                        int groups) {
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warp leaves together
  const size_t off = (size_t)row * (size_t)W;

  int f[NPT], g[NPT], m[NPT], m14[NPT], Q[NPT], S[NPT], P[NPT], R[NPT];
  wl::load_row<NPT>(f, f_in + off, W, lane);
  wl::load_row<NPT>(g, g_in + off, W, lane);
  wl::load_row<NPT>(m, m_in + off, W, lane);

#pragma unroll
  for (int j = 0; j < NPT; j++) m14[j] = m[j] << 14;  // canonical m < 2^16
  wl::canonicalize<NPT>(m14, lane, W);
  Consts k;
  k.minv_w = (-wl::modinv16(__shfl_sync(WL_FULL, m[0], 0))) & kMaskW;
  wl::value_est<NPT>(m, lane, k.mant_m, k.top_m);

  wl::carry_pass<NPT>(f, lane, W);
  wl::carry_pass<NPT>(g, lane, W);
  int delta = 1;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int one = (lane == 0 && j == 0) ? 1 : 0;
    Q[j] = 0;
    S[j] = one;
    P[j] = one;
    R[j] = 0;
  }

  int grp = 0;
  for (; grp < groups; grp++) {
    bool gnz = false;
#pragma unroll
    for (int j = 0; j < NPT; j++) gnz |= g[j] != 0;
    // extra groups past g == 0 are exact identities on the outputs, so
    // each lane stops on its own
    if (!__any_sync(WL_FULL, gnz)) break;

    // 13 divsteps on the low bits of limb 0, computed by every thread
    int fl = __shfl_sync(WL_FULL, f[0], 0);
    int gl = __shfl_sync(WL_FULL, g[0], 0);
    int u = 1, v = 0, q = 0, r = 1;
#pragma unroll
    for (int st = 0; st < kW; st++) {
      int g_odd = gl & 1;
      bool swap = (delta > 0) && g_odd == 1;
      if (swap) {
        delta = 1 - delta;
        int nf = gl, ng = (gl - fl) >> 1;
        int nu = 2 * q, nv = 2 * r, nq = q - u, nr = r - v;
        fl = nf; gl = ng; u = nu; v = nv; q = nq; r = nr;
      } else {
        delta = 1 + delta;
        gl = (gl + g_odd * fl) >> 1;
        int nq = q + g_odd * u, nr = r + g_odd * v;
        u = 2 * u; v = 2 * v; q = nq; r = nr;
      }
    }

    int t1[NPT], t2[NPT];
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      t1[j] = u * f[j] + v * g[j];
      t2[j] = q * f[j] + r * g[j];
    }
    shr_w<NPT>(t1, lane, W);
    shr_w<NPT>(t2, lane, W);
    wl::carry_pass<NPT>(t1, lane, W);
    wl::carry_pass<NPT>(t2, lane, W);
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      f[j] = t1[j];
      g[j] = t2[j];
    }

#pragma unroll
    for (int j = 0; j < NPT; j++) {
      t1[j] = u * Q[j] + v * S[j];
      t2[j] = q * Q[j] + r * S[j];
    }
    reduce_row<NPT>(t1, m, m14, k, lane, W);
    reduce_row<NPT>(t2, m, m14, k, lane, W);
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      Q[j] = t1[j];
      S[j] = t2[j];
    }
    if (NEED_U) {
#pragma unroll
      for (int j = 0; j < NPT; j++) {
        t1[j] = u * P[j] + v * R[j];
        t2[j] = q * P[j] + r * R[j];
      }
      reduce_row<NPT>(t1, m, m14, k, lane, W);
      reduce_row<NPT>(t2, m, m14, k, lane, W);
#pragma unroll
      for (int j = 0; j < NPT; j++) {
        P[j] = t1[j];
        R[j] = t2[j];
      }
    }
  }

  if (iters_out != nullptr && lane == 0) iters_out[row] = grp;
  int sf = wl::canonicalize<NPT>(f, lane, W);
  wl::store_row<NPT>(f, d_out + off, W, lane);
  into_range<NPT>(Q, m, sf, lane, W);
  wl::store_row<NPT>(Q, cg_out + off, W, lane);
  if (NEED_U) {
    into_range<NPT>(P, m, sf, lane, W);
    wl::store_row<NPT>(P, cu_out + off, W, lane);
  }
}

template <int NPT>
void launch(const int* f, const int* g, const int* m, int* d, int* cg,
            int* cu, int* iters, int B, int W, int groups, int need_u,
            cudaStream_t stream) {
  const int threads = 128;  // 4 lanes (warps) per block
  const int blocks = (B + 3) / 4;
  if (need_u)
    xgcd_coeff_g_kernel<NPT, true>
        <<<blocks, threads, 0, stream>>>(f, g, m, d, cg, cu, iters, B, W, groups);
  else
    xgcd_coeff_g_kernel<NPT, false>
        <<<blocks, threads, 0, stream>>>(f, g, m, d, cg, cu, iters, B, W, groups);
}

}  // namespace

// Plain C entry point (bound with ctypes). Rows are contiguous int32 (B, W)
// arrays on the device; W <= 288. cu may be null without need_u; iters,
// when not null, receives each row's number of divstep groups. Returns
// cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for an unsupported W.
extern "C" int xgcd_coeff_g_launch(const int* f, const int* g, const int* m,
                                   int* d, int* cg, int* cu, int* iters,
                                   int B, int W, int groups, int need_u,
                                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((W + 31) / 32) {
    case 1: launch<1>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 2: launch<2>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 3: launch<3>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 4: launch<4>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 5: launch<5>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 6: launch<6>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 7: launch<7>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 8: launch<8>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 9: launch<9>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
