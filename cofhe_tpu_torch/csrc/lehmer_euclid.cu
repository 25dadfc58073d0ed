// K7: the NUCOMP tail's Lehmer walk on Hopper (sm_90a).
//
// Replaces the XLA while loop of cofhe_tpu/ops/rl.py::lehmer_euclid (not a
// Pallas kernel in the JAX package; in eager PyTorch its groups of small
// ops ran ~46k device kernels a compose2 and read their exit condition on
// the host, which kept NUCOMP out of compose2's CUDA graph). It computes
// the plain version cofhe_tpu_torch/ops/rl.py::lehmer_euclid and gives the
// same seven outputs limb for limb and the same working groups a lane:
// the rows (rp, rc, xp, xc, yp, yc), redundant signed (B, L), with
// r = x r0 + y r1 on both, and par (B,).
//
// One warp a lane (four lanes a block), its six rows in registers,
// NPT = ceil(L / 32) limbs a thread, as in K3. A group:
//  1. ordered value estimates of rp, rc and yc (wl::value_est_ordered:
//     the plain version's f32 sums, term for term, in XLA-CPU's order)
//     and their bit lengths; the fresh work flag w_f = active & bits(rc) >
//     bits_stop & bits(yc) < y_cap; the lane works if w & w_f;
//  2. a "big" lane (bits(rp) - bits(rc) > 20) takes one shifted ~24-bit
//     digit step (the JAX digit: exponent clamp 26, no cap on the shift)
//     on (rp, xp, yp), the limb shift through a row of shared memory;
//  3. otherwise up to sim_steps continued-fraction steps on ~27-bit top
//     words, run on every thread of the warp on the same integers (one
//     warp instruction either way, and no broadcast), build a 2x2 matrix
//     with entries up to 2^13, applied once to the rows with one carry
//     pass each. Matrix entries <= 2^13 against balanced limbs < 2^15.3
//     keep a0 p + a1 c below 2^29.3 (int32-exact); the digit step splits
//     its digit 12 + 12 against v and carry_pass(v << 12) (products below
//     2^27.3 and 2^27.3), as the plain version does;
//  4. an idle lane (not w & w_f) runs the same matrix, the identity: its
//     rows are carry-passed and nothing else changes.
// Floats copy the plain version's arithmetic: rintf for torch.round
// (half to even), the top word's exponent clamped in f32 to [-126, 30]
// and truncated, _log2_f32 from the f32 bits, IEEE division, no FMA
// contraction (--fmad=false), floor division for the simulation's
// quotients.
//
// Each lane leaves on its own. The batch loop (the plain version and the
// JAX while loop) runs group g while any lane's carried flag w_g is set,
// with w_(g+1) = w_f(g). A lane's w_f depends on its own rows only, so its
// first g with w_g false, t, is its own; while no lane's flag comes back
// on, the batch runs G = min(max_groups, max over lanes of t) groups. A
// lane's groups from t on are idle. They are not quite no-ops: each runs
// a carry pass over the six rows, and a carry pass is not idempotent (a
// limb that reaches 2^15 after one pass moves its carry up in the next),
// so the limbs (never the values) of a lane that stopped early depend on
// G. Kernel A (lehmer_euclid_walk_kernel) runs each lane until its flag
// drops or max_groups, writes its rows and t, and takes max t into
// work[B] by an atomic; a lane whose last, idle group changed no limb is
// a fixed point (its w_f was false on the same rows) and is marked done.
// Kernel B (lehmer_euclid_finish_kernel) runs the other lanes' groups
// t .. G - 1 with the same group code, stopping early at an idle group
// that changes no limb with w_f false: from there every group gives the
// same rows. So each lane gets exactly the batch loop's groups, unless an
// idle lane's w_f comes back on (an estimate that crosses bits_stop or
// y_cap between two limb forms of one value), which the plain version
// would follow further. The `go` mask of the plain version and the JAX
// any(w) only stop lanes that are fixed points once G is reached.
//
// What bounds it on this card: ~8k integer operations a group and lane
// (three estimates, the 2x2 matrix on six rows with their carry passes)
// over ~143 groups at compose2's L = 144; at the NUCOMP compose2's 128
// lanes one warp on 32 of 132 SMs, so the walk is the serial latency of
// its groups: the estimates' shuffles and reductions and the scalar
// simulation between them. The rows are read and written once.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;    // lanes (warps) a block
constexpr int kLim = 8192;   // 2^13 matrix-entry bound

struct LaneParams {
  float bits_stop, y_cap;
  bool active;
};

template <int NPT>
struct Walk {
  int rp[NPT], rc[NPT], xp[NPT], xc[NPT], yp[NPT], yc[NPT];
  int par;
};

__device__ __forceinline__ int fsign(float v) { return (v > 0.0f) - (v < 0.0f); }

// rl.lehmer_euclid's top_word: round(mant * 2^e), e = 16 top - sh clipped
// to [-126, 30] in f32 and truncated.
__device__ __forceinline__ int top_word(float mant, int top, float sh) {
  const float e = fminf(fmaxf((float)(16 * top) - sh, -126.0f), 30.0f);
  return (int)rintf(mant * wl::pow2f((int)e));
}

// Carry pass of a row; true if a limb changed.
template <int NPT>
__device__ __forceinline__ bool carry_moved(int (&x)[NPT], int lane, int W) {
  int old[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) old[j] = x[j];
  wl::carry_pass<NPT>(x, lane, W);
  bool ch = false;
#pragma unroll
  for (int j = 0; j < NPT; j++) ch |= old[j] != x[j];
  return ch;
}

// x <- carry_pass(x - qd * v * 2^(16 jj)) (the plain version's
// submul_shift_red): qd split 12 + 12 against v and carry_pass(v << 12),
// each partial product carried, the limb shift through `buf` (this warp's
// row of shared memory), limbs past the top dropped.
template <int NPT>
__device__ __forceinline__ void submul_shift(int (&x)[NPT], const int (&v)[NPT],
                                             int qd, int jj, int* buf,
                                             int lane, int W) {
  const int s = wl::sgn(qd), a = abs(qd);
  const int lo = (a & 0xFFF) * s, hi = (a >> 12) * s;
  int v12[NPT], p[NPT], p2[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) v12[j] = (int)((uint32_t)v[j] << 12);
  wl::carry_pass<NPT>(v12, lane, W);
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    p[j] = wl::mulw(lo, v[j]);
    p2[j] = wl::mulw(hi, v12[j]);
  }
  wl::carry_pass<NPT>(p, lane, W);
  wl::carry_pass<NPT>(p2, lane, W);
  __syncwarp();  // the previous row's reads are done
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    if (i < W) buf[i] = p[j] + p2[j];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int src = lane * NPT + j - jj;
    if (lane * NPT + j < W && src >= 0) x[j] -= buf[src];
  }
  wl::carry_pass<NPT>(x, lane, W);
}

// (p, c) <- (carry_pass(a0 p + a1 c), carry_pass(b0 p + b1 c))
template <int NPT>
__device__ __forceinline__ void apply2(int (&p)[NPT], int (&c)[NPT], int a0,
                                       int a1, int b0, int b1, int lane,
                                       int W) {
  int np[NPT], nc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    np[j] = wl::mulw(a0, p[j]) + wl::mulw(a1, c[j]);
    nc[j] = wl::mulw(b0, p[j]) + wl::mulw(b1, c[j]);
  }
  wl::carry_pass<NPT>(np, lane, W);
  wl::carry_pass<NPT>(nc, lane, W);
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    p[j] = np[j];
    c[j] = nc[j];
  }
}

// One group on one lane with carried flag w. Returns the fresh flag w_f;
// `on`: the lane worked (w & w_f); `moved`: an idle group's carry passes
// changed a limb.
template <int NPT>
__device__ __forceinline__ bool group(Walk<NPT>& s, bool w, const LaneParams& lp,
                                      int sim_steps, int* buf, int lane, int W,
                                      bool& on, bool& moved) {
  float mp, mc, my;
  int tp, tc, ty;
  wl::value_est_ordered<NPT>(s.rp, lane, W, mp, tp);
  wl::value_est_ordered<NPT>(s.rc, lane, W, mc, tc);
  wl::value_est_ordered<NPT>(s.yc, lane, W, my, ty);
  const float bp = wl::bits_est(mp, tp), bc = wl::bits_est(mc, tc);
  const float by = wl::bits_est(my, ty);
  const bool wf = lp.active && bc > lp.bits_stop && by < lp.y_cap;
  on = w && wf;
  moved = false;
  if (!on) {  // the identity matrix: one carry pass a row
    bool ch = carry_moved<NPT>(s.rp, lane, W);
    ch |= carry_moved<NPT>(s.rc, lane, W);
    ch |= carry_moved<NPT>(s.xp, lane, W);
    ch |= carry_moved<NPT>(s.xc, lane, W);
    ch |= carry_moved<NPT>(s.yp, lane, W);
    ch |= carry_moved<NPT>(s.yc, lane, W);
    moved = __any_sync(WL_FULL, ch);
    return wf;
  }
  if (bp - bc > 20.0f) {  // big: (rp, xp, yp) -= qd 2^(16 jj) (rc, xc, yc)
    int qd, jj;
    wl::digit_est_jax(mp, tp, fabsf(mc), tc, 24, qd, jj);
    qd = wl::mulw(qd, fsign(mc));
    submul_shift<NPT>(s.rp, s.rc, qd, jj, buf, lane, W);
    submul_shift<NPT>(s.xp, s.xc, qd, jj, buf, lane, W);
    submul_shift<NPT>(s.yp, s.yc, qd, jj, buf, lane, W);
    return wf;
  }
  // Lehmer group on ~27-bit top words at the larger row's scale
  const float sh = fmaxf(bp, bc) - 26.0f;
  int up = top_word(mp, tp, sh), vc = top_word(mc, tc, sh);
  int mp0 = 1, mp1 = 0, mc0 = 0, mc1 = 1, parg = 0;
  for (int k = 0; k < sim_steps; k++) {
    const int emax = max(abs(mc0), abs(mc1));
    const int epmx = max(abs(mp0), abs(mp1));
    const int qmax = wl::floordiv(kLim - epmx, max(emax, 1));
    if (!(abs(vc) > 32 && qmax > 0)) break;  // and so every later step
    int q = wl::floordiv(up, vc == 0 ? 1 : vc);
    q = min(max(q, -qmax), qmax);
    const int nv = up - wl::mulw(q, vc);
    up = vc;
    vc = nv;
    const int n0 = mp0 - wl::mulw(q, mc0), n1 = mp1 - wl::mulw(q, mc1);
    mp0 = mc0;
    mp1 = mc1;
    mc0 = n0;
    mc1 = n1;
    parg ^= 1;
  }
  apply2<NPT>(s.rp, s.rc, mp0, mp1, mc0, mc1, lane, W);
  apply2<NPT>(s.xp, s.xc, mp0, mp1, mc0, mc1, lane, W);
  apply2<NPT>(s.yp, s.yc, mp0, mp1, mc0, mc1, lane, W);
  s.par ^= parg;
  return wf;
}

// The lane's bits_stop, active and y_cap (from r0's ordered estimate).
template <int NPT>
__device__ __forceinline__ LaneParams lane_params(const int (&r0)[NPT],
                                                  const float* bits_stop,
                                                  const unsigned char* active,
                                                  int row, int lane, int W) {
  LaneParams lp;
  lp.bits_stop = bits_stop[row];
  lp.active = active == nullptr || active[row] != 0;
  float m0;
  int t0;
  wl::value_est_ordered<NPT>(r0, lane, W, m0, t0);
  lp.y_cap = wl::bits_est(m0, t0) - lp.bits_stop + 24.0f;
  return lp;
}

struct Out {
  int *rp, *rc, *xp, *xc, *yp, *yc, *par, *iters;
};

template <int NPT>
__device__ __forceinline__ void store(const Walk<NPT>& s, const Out& o,
                                      size_t off, int row, int count, int lane,
                                      int W) {
  wl::store_row<NPT>(s.rp, o.rp + off, W, lane);
  wl::store_row<NPT>(s.rc, o.rc + off, W, lane);
  wl::store_row<NPT>(s.xp, o.xp + off, W, lane);
  wl::store_row<NPT>(s.xc, o.xc + off, W, lane);
  wl::store_row<NPT>(s.yp, o.yp + off, W, lane);
  wl::store_row<NPT>(s.yc, o.yc + off, W, lane);
  if (lane == 0) {
    o.par[row] = s.par;
    if (o.iters != nullptr) o.iters[row] = count;
  }
}

// Kernel A: each lane from its entry until its flag drops or max_groups;
// work[row] = its stop group t, or -1 once it is a fixed point (or at the
// cap); work[B] = max t.
template <int NPT>
__global__ void __launch_bounds__(kWarps * 32)
    lehmer_euclid_walk_kernel(const int* __restrict__ r0, const int* __restrict__ r1,
                       const float* __restrict__ bits_stop,
                       const unsigned char* __restrict__ active, Out o,
                       int* __restrict__ work, int B, int L, int max_groups,
                       int sim_steps) {
  __shared__ int bufs[kWarps][32 * NPT];
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warp leaves together
  int* buf = bufs[threadIdx.x >> 5];
  const size_t off = (size_t)row * (size_t)L;
  Walk<NPT> s;
  wl::load_row<NPT>(s.rp, r0 + off, L, lane);
  wl::load_row<NPT>(s.rc, r1 + off, L, lane);
  const LaneParams lp = lane_params<NPT>(s.rp, bits_stop, active, row, lane, L);
  float m1;
  int t1;
  wl::value_est_ordered<NPT>(s.rc, lane, L, m1, t1);
  bool w = lp.active && wl::bits_est(m1, t1) > lp.bits_stop;
  wl::carry_pass<NPT>(s.rp, lane, L);
  wl::carry_pass<NPT>(s.rc, lane, L);
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int one = lane * NPT + j == 0 ? 1 : 0;
    s.xp[j] = one;
    s.xc[j] = 0;
    s.yp[j] = 0;
    s.yc[j] = one;
  }
  s.par = 0;
  int g = 0, count = 0;
  bool done = false;
  while (g < max_groups && w) {  // w is set here, so the lane works if w_f
    bool on, moved;
    w = group<NPT>(s, true, lp, sim_steps, buf, lane, L, on, moved);
    g++;
    if (on) count++;
    else done = !moved;  // idle on the rows it judged: a fixed point
  }
  if (g == max_groups) done = true;
  store<NPT>(s, o, off, row, count, lane, L);
  if (lane == 0) {
    work[row] = done ? -1 : g;
    atomicMax(work + B, g);
  }
}

// Kernel B: the groups t .. G - 1 of the lanes kernel A left before G =
// min(work[B], max_groups), from their stored rows, with w = false.
template <int NPT>
__global__ void __launch_bounds__(kWarps * 32)
    lehmer_euclid_finish_kernel(const int* __restrict__ r0,
                         const float* __restrict__ bits_stop,
                         const unsigned char* __restrict__ active, Out o,
                         const int* __restrict__ work, int B, int L,
                         int max_groups, int sim_steps) {
  __shared__ int bufs[kWarps][32 * NPT];
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const int t = work[row], G = min(work[B], max_groups);
  if (t < 0 || t >= G) return;  // uniform across the warp
  int* buf = bufs[threadIdx.x >> 5];
  const size_t off = (size_t)row * (size_t)L;
  Walk<NPT> s;
  wl::load_row<NPT>(s.rp, r0 + off, L, lane);
  const LaneParams lp = lane_params<NPT>(s.rp, bits_stop, active, row, lane, L);
  wl::load_row<NPT>(s.rp, o.rp + off, L, lane);
  wl::load_row<NPT>(s.rc, o.rc + off, L, lane);
  wl::load_row<NPT>(s.xp, o.xp + off, L, lane);
  wl::load_row<NPT>(s.xc, o.xc + off, L, lane);
  wl::load_row<NPT>(s.yp, o.yp + off, L, lane);
  wl::load_row<NPT>(s.yc, o.yc + off, L, lane);
  s.par = o.par[row];
  int count = o.iters != nullptr ? o.iters[row] : 0;
  bool w = false;
  for (int g = t; g < G; g++) {
    bool on, moved;
    const bool wf = group<NPT>(s, w, lp, sim_steps, buf, lane, L, on, moved);
    if (on) count++;
    if (!on && !moved && !wf) break;  // every later group is this one
    w = wf;
  }
  store<NPT>(s, o, off, row, count, lane, L);
}

template <int NPT>
void launch(const int* r0, const int* r1, const float* bits_stop,
            const unsigned char* active, const Out& o, int* work, int B, int L,
            int max_groups, int sim_steps, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  lehmer_euclid_walk_kernel<NPT><<<blocks, kWarps * 32, 0, stream>>>(
      r0, r1, bits_stop, active, o, work, B, L, max_groups, sim_steps);
  lehmer_euclid_finish_kernel<NPT><<<blocks, kWarps * 32, 0, stream>>>(
      r0, bits_stop, active, o, work, B, L, max_groups, sim_steps);
}

}  // namespace

// Plain C entry point (bound with ctypes). r0, r1: contiguous int32 (B, L)
// magnitudes on the device, L <= 288; bits_stop: (B,) f32; active: (B,)
// bool bytes, or null for every lane; outputs: the six (B, L) rows and
// par (B,); iters, when not null, receives each lane's working groups;
// work: (B + 1) int32 scratch (work[B] is zeroed here). Launches kernel A
// and kernel B on the stream and returns cudaGetLastError() (0 on
// success); 1 (cudaErrorInvalidValue) for an unsupported L.
extern "C" int lehmer_euclid_launch(const int* r0, const int* r1,
                                    const float* bits_stop,
                                    const unsigned char* active, int* rp,
                                    int* rc, int* xp, int* xc, int* yp,
                                    int* yc, int* par, int* iters, int* work,
                                    int B, int L, int max_groups,
                                    int sim_steps, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Out o{rp, rc, xp, xc, yp, yc, par, iters};
  const cudaError_t e = cudaMemsetAsync(work + B, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  switch ((L + 31) / 32) {
#define K7_CASE(n)                                                        \
  case n:                                                                 \
    launch<n>(r0, r1, bits_stop, active, o, work, B, L, max_groups,       \
              sim_steps, s);                                              \
    break;
    K7_CASE(1) K7_CASE(2) K7_CASE(3) K7_CASE(4) K7_CASE(5) K7_CASE(6)
    K7_CASE(7) K7_CASE(8) K7_CASE(9)
#undef K7_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
