// K3: batched grouped rho-descent of quadratic forms on Hopper (sm_90a).
//
// Replaces the XLA while loop of cofhe_tpu/ops/forms2.py::CG.reduce2_grouped
// (not a Pallas kernel in the JAX package; in eager PyTorch its groups of
// small ops dominated every compose). It computes the plain version
// cofhe_tpu_torch/ops/forms2.py::grouped_rho_loop_wide and gives the same
// limbs and group counts: per group, normalization / rho quotients are
// simulated on f64 estimates of a and b (rl.value_est_wide, held at a's
// scale for the whole group; c from the invariant c = (b^2 + |Delta|) / 4a)
// until the unimodular M = [[p, q], [r, s]] would pass its 2^22 entry
// budget, the form looks reduced, or kSimMax steps; M is then applied once
// to the redundant limbs of (a, b, c) with one 64-bit product per
// coefficient (coefficients below 2^45, limbs below 2^15.01, three-term
// sums below 2^62), the sums spread back into 16-bit limbs and one carry
// pass run. The exact tail (canonicalize + forms.reduce_batch) stays in
// torch and gives the unique reduced form.
//
// What bounds it on this card: the count of integer operations is 9 int64
// products and sums, a 4-digit spread and a carry pass per group and limb,
// ~3x fewer groups than a 2^12-budget loop (25 against 73 at
// sec=128). What holds it back is the scalar simulation between groups:
// ~10 dependent steps of f64 arithmetic with one or two IEEE divisions
// each, which at the main path's 128-256 lanes (32-64 of 132 SMs) is the
// serial latency of the loop, and at 16384 lanes costs as many warp
// instructions as the apply. The design keeps that chain short: flags by
// products and comparisons (no logarithms), no renormalization inside a
// group, the cap division only when the budget is spent, and after a rho
// the quotient's division issued beside the one that gives the new a.
// Every thread of the warp runs the simulation on the same doubles: a warp
// instruction costs one issue whatever its active threads, so running it on
// one thread and broadcasting M would add a shuffle and save nothing; a
// variant that simulated a block's lanes side by side in warp 0 and handed
// M over shared memory measured slower (its barriers serialize simulation
// and apply, and it needed 128 registers). Tensor cores and TMA do not fit:
// the work is a different scalar times each lane's rows (no tile for
// wgmma), and the rows are read once (their bytes are under 1% of the
// bound). Launch shape: four lanes a block. At 128-256 lanes a warp's
// loop is latency bound, and one, two or four lanes a block measured
// within 3% of each other on the main path's operands (PERF.md), so the
// shape is fixed.

#include "warp_limbs.cuh"

namespace {

constexpr double kLim = 4194304.0;  // 2^22 matrix-entry budget
constexpr int kSimMax = 12;          // simulated quotients a group at most
constexpr int kWarps = 4;            // lanes (warps) a block
// forms2.UP, DOWN, FREAK: the flags' margins 2^(+-0.25), the freak bound
constexpr double kUp = 1.189207115002721;
constexpr double kDown = 0.8408964152537145;
constexpr double kFreak = 33554432.0;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// forms2._scaled_wide: b and |Delta| at a's scale 2^(16 ta)
__device__ __forceinline__ void scaled(double mb, int ta, int tb,
                                       double dD_mant, int dD_top, double& sb,
                                       double& dp) {
  sb = mb * wl::pow2d(clampi(16 * (tb - ta), -1100, 1000));
  dp = dD_mant * wl::pow2d(clampi(16 * (dD_top - 2 * ta), -1100, 1000));
}

// forms2._flags_wide: (need_norm, need_rho) and num = b^2 + |Delta|, by
// products and comparisons only
__device__ __forceinline__ void flags(double sa, double sb, double dp,
                                      bool& need_norm, bool& need_rho,
                                      double& num) {
  const double ab = fabs(sb);
  const bool raw = ab > sa * kUp;
  num = sb * sb + dp;
  need_rho = !raw && num < 4.0 * sa * sa * kDown;
  need_norm = raw && !(ab > sa * kFreak);
}

// out = carry_pass(spread(ca * a + cb * b + cc * c)) with int64 sums
template <int NPT>
__device__ __forceinline__ void xform(long long ca, long long cb, long long cc,
                                      const int (&a)[NPT], const int (&b)[NPT],
                                      const int (&c)[NPT], int (&out)[NPT],
                                      int lane, int L) {
  long long s[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++)
    s[j] = ca * (long long)a[j] + cb * (long long)b[j] + cc * (long long)c[j];
  wl::spread_carry<NPT, 4>(s, out, lane, L);
  wl::carry_pass<NPT>(out, lane, L);
}

// One group's scalar simulation (forms2.grouped_rho_loop_wide's inner
// loop) from a's scale: returns M = [[P, Q], [R, S]].
__device__ __forceinline__ void simulate(double sa, double sb, double dp,
                                         long long (&m)[4]) {
  double num;
  double p = 1.0, r = 0.0, qq = 0.0, ss = 1.0;
  for (int step = 0; step < kSimMax; step++) {
    bool need_norm, need_rho;
    flags(sa, sb, dp, need_norm, need_rho, num);
    if (!(need_norm || need_rho)) break;
    // q = round(b / 2a) of the form after the optional rho, clipped to
    // what the budget leaves once it would pass it (the only step that
    // divides for the cap). After a rho, q = -2 a b / (b^2 + |Delta|):
    // its division does not wait for the one that gives the new a.
    double man = sa, mbn = sb, qreal;
    if (need_rho) {  // (a, b, c) -> (c, -b, a); M times [[0,-1],[1,0]]
      man = num / fmax(4.0 * sa, 1e-300);
      qreal = -2.0 * sa * sb / fmax(num, 1e-300);
      mbn = -sb;
      const double t0 = p, t1 = r;
      p = qq;
      qq = -t0;
      r = ss;
      ss = -t1;
    } else {
      qreal = sb / fmax(2.0 * sa, 1e-300);
    }
    const double qround = rint(qreal);
    const double col1 = fmax(fmax(fabs(p), fabs(r)), 1.0);
    const double col2 = fmax(fabs(qq), fabs(ss));
    const bool spent = !(fabs(qround) * col1 + col2 <= kLim);
    double qf = qround;
    if (spent) {
      const double qcap = floor((kLim - col2) / col1);
      qf = fmin(fmax(qround, -qcap), qcap);
    }
    sb = mbn - 2.0 * qf * man;
    sa = man;
    qq = qq - qf * p;
    ss = ss - qf * r;
    if (spent) break;
  }
  m[0] = (long long)p;
  m[1] = (long long)r;
  m[2] = (long long)qq;
  m[3] = (long long)ss;
}

template <int NPT>
__global__ void __launch_bounds__(kWarps * 32)
    reduce2_grouped_kernel(const int* __restrict__ a_in,
                           const int* __restrict__ b_in,
                           const int* __restrict__ c_in,
                           int* __restrict__ a_out, int* __restrict__ b_out,
                           int* __restrict__ c_out, int* __restrict__ iters_out,
                           int B, int L, double dD_mant, int dD_top,
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
  double sa, mb, sb, dp, num;
  int ta, tb;
  bool on, nn, nr;
  wl::value_est_wide<NPT>(a, lane, sa, ta);
  wl::value_est_wide<NPT>(b, lane, mb, tb);
  scaled(mb, ta, tb, dD_mant, dD_top, sb, dp);
  flags(sa, sb, dp, nn, nr, num);
  on = nn || nr;

  int it = 0;
  for (; it < red_iters && on; it++) {
    // every thread of the warp runs the lane's simulation on the same
    // doubles: one warp instruction either way, and no broadcast
    long long m[4];
    simulate(sa, sb, dp, m);
    const long long P = m[0], R = m[1], Q = m[2], S = m[3];
    // ---- apply M once to the limbs
    int na[NPT], nb_[NPT], nc[NPT];
    xform<NPT>(P * P, P * R, R * R, a, b, c, na, lane, L);
    xform<NPT>(2 * P * Q, P * S + Q * R, 2 * R * S, a, b, c, nb_, lane, L);
    xform<NPT>(Q * Q, Q * S, S * S, a, b, c, nc, lane, L);
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      a[j] = na[j];
      b[j] = nb_[j];
      c[j] = nc[j];
    }
    wl::value_est_wide<NPT>(a, lane, sa, ta);
    wl::value_est_wide<NPT>(b, lane, mb, tb);
    scaled(mb, ta, tb, dD_mant, dD_top, sb, dp);
    flags(sa, sb, dp, nn, nr, num);
    on = nn || nr;
  }
  if (iters_out != nullptr && lane == 0) iters_out[row] = it;
  wl::store_row<NPT>(a, a_out + off, L, lane);
  wl::store_row<NPT>(b, b_out + off, L, lane);
  wl::store_row<NPT>(c, c_out + off, L, lane);
}

template <int NPT>
void launch(const int* a, const int* b, const int* c, int* ao, int* bo,
            int* co, int* iters, int B, int L, double dD_mant, int dD_top,
            int red_iters, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  reduce2_grouped_kernel<NPT><<<blocks, kWarps * 32, 0, stream>>>(
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
                                      int red_iters, double dD_mant,
                                      void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 31) / 32) {
#define K3_CASE(n)                                                       \
  case n:                                                                \
    launch<n>(a, b, c, ao, bo, co, iters, B, L, dD_mant, dD_top,         \
              red_iters, s);                                             \
    break;
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6)
    K3_CASE(7) K3_CASE(8) K3_CASE(9)
#undef K3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
