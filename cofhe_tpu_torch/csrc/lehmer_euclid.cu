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
// A warp a lane, its six rows in registers, NPT = ceil(L / 32) limbs a
// thread, as in K3. A group:
//  1. ordered value estimates of rp, rc and yc side by side
//     (wl::value_est_ordered_rows: the plain version's f32 sums, term for
//     term, in XLA-CPU's order; the three top-limb maxima back to back,
//     the rows staged in this warp's shared memory and their eight
//     nonzero terms read by broadcast loads) and their bit lengths; the
//     fresh work flag w_f = active & bits(rc) > bits_stop & bits(yc) <
//     y_cap; the lane works if w & w_f;
//  2. a "big" lane (bits(rp) - bits(rc) > 20) takes one shifted ~24-bit
//     digit step (the JAX digit: exponent clamp 26, no cap on the shift)
//     on (rp, xp, yp), the limb shift through a row of shared memory;
//  3. otherwise up to sim_steps continued-fraction steps on ~27-bit top
//     words, run on every thread of the warp on the same integers (one
//     warp instruction either way, and no broadcast), with no integer
//     division on the common path: the quotient floor(up / vc) from an f32
//     estimate (up's float and vc's reciprocal taken a step ahead, MUFU.RCP
//     alone), floored by a magic-number add and corrected once by the
//     remainder (wl::floor_quot: exact below 2^19 in magnitude, and past
//     it large enough that the clip gives the same bound); the 2^13 clip
//     tested with one product (|q| emax > 2^13 - epmx) and its bound qmax
//     computed only where it binds (wl::quot_small), `can` (qmax > 0) one
//     comparison. The 2x2 matrix, entries up to 2^13, is applied once to
//     the six rows, their products and carry passes side by side
//     (wl::carry_pass_rows). Matrix entries <= 2^13 against balanced limbs
//     < 2^15.3 keep a0 p + a1 c below 2^29.3 (int32-exact); the digit step
//     splits its digit 12 + 12 against v and carry_pass(v << 12)
//     (products below 2^27.3 and 2^27.3), as the plain version does;
//  4. an idle lane (not w & w_f) runs the same matrix, the identity: its
//     six rows are carry-passed side by side and nothing else changes.
// Floats copy the plain version's arithmetic: rintf for torch.round
// (half to even), the top word's exponent clamped in f32 to [-126, 30]
// and truncated, _log2_f32 from the f32 bits, IEEE division in the
// digit, no FMA contraction (--fmad=false); the simulation's quotients
// equal its floor divisions.
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
// Launch: a warp a block. Kernel A runs min(B, resident blocks) of them:
// block b walks lane b and then, while lanes are left, the next one from
// an atomic counter (work[B + 1]); so 128 lanes run on 128 SMs, one warp
// each, and at 16384 lanes a warp that finishes a short lane takes another
// while a long one (up to ~160 groups against a mean of ~48) runs on.
// Kernel B gives a warp 32 lanes and works through those a ballot marks.
// (Blocks of four lanes whose simulations run on one warp's threads, a
// thread a lane, spend fewer issue slots but make the lanes wait for each
// other's simulations every group; on the card they were slower at 16384
// lanes.)
//
// What bounds it on this card: at 128 lanes, one warp on an SM, the
// latency of a lane's groups, one after another: the simulation's chain of
// up to eight quotients (reciprocal, product, floor, correction,
// remainder), the estimates' maxima, loads and ordered sums, the apply's
// carry shuffles. At 16384 lanes, the warp instructions a group issues
// (the simulation counts once a warp, not once a limb) against ~60 int32
// operations a working group and limb that the bound counts. The rows are
// read and written once. Build with -DK7_PHASES (tools/kernel_compare.py
// --k7-phases, chip_smoke.py) for each lane's cycles by phase.

#include "warp_limbs.cuh"

namespace {

constexpr int kLim = 8192;   // 2^13 matrix-entry bound
// the rows of a lane's walk, in Walk::r
enum { RP, RC, XP, XC, YP, YC, NROW };

// Phase clock (built only with -DK7_PHASES, by tools/kernel_compare.py
// --k7-phases; never on the main path): each lane's clock64() cycles in
// each phase of its groups, and its groups of each kind, added into
// k7_phase_out[row * K7_NPH + k].
enum { PH_EST, PH_SIM, PH_DIGIT, PH_APPLY, PH_IDLE, PH_OTHER, N_SIM, N_DIGIT,
       N_IDLE, K7_NPH };
#ifdef K7_PHASES
__device__ unsigned long long* k7_phase_out;
struct Clock {
  long long t;
  unsigned long long acc[K7_NPH];
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int k = 0; k < K7_NPH; k++) acc[k] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void mark(int ph) {
    const long long now = clock64();
    acc[ph] += (unsigned long long)(now - t);
    t = now;
  }
  __device__ __forceinline__ void count(int k) { acc[k]++; }
  __device__ __forceinline__ void flush(int row, int lane) {
    mark(PH_OTHER);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K7_NPH; k++) k7_phase_out[(size_t)row * K7_NPH + k] += acc[k];
    }
  }
};
#else
struct Clock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void flush(int, int) {}
};
#endif

struct LaneParams {
  float bits_stop, y_cap;
  bool active;
};

template <int NPT>
struct Walk {
  int r[NROW][NPT];
  int par;
};

// this warp's staged rows for the estimates (and the digit step's shift)
template <int NPT>
using Stage = int[3][8 + 32 * NPT];

__device__ __forceinline__ int fsign(float v) { return (v > 0.0f) - (v < 0.0f); }

// rl.lehmer_euclid's top_word: round(mant * 2^e), e = 16 top - sh clipped
// to [-126, 30] in f32 and truncated.
__device__ __forceinline__ int top_word(float mant, int top, float sh) {
  const float e = fminf(fmaxf((float)(16 * top) - sh, -126.0f), 30.0f);
  return (int)rintf(mant * wl::pow2f((int)e));
}

// x <- carry_pass(x - qd * v * 2^(16 jj)) (the plain version's
// submul_shift_red): qd split 12 + 12 against v and carry_pass(v << 12),
// each partial product carried, the limb shift through `buf` (a row of
// this warp's shared memory), limbs past the top dropped.
template <int NPT>
__device__ __forceinline__ void submul_shift(int (&x)[NPT], const int (&v)[NPT],
                                             int qd, int jj, int* buf,
                                             int lane, int W) {
  const int s = wl::sgn(qd), a = abs(qd);
  const int lo = (a & 0xFFF) * s, hi = (a >> 12) * s;
  int v12[NPT], p[2][NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) v12[j] = (int)((uint32_t)v[j] << 12);
  wl::carry_pass<NPT>(v12, lane, W);
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    p[0][j] = wl::mulw(lo, v[j]);
    p[1][j] = wl::mulw(hi, v12[j]);
  }
  wl::carry_pass_rows<NPT, 2>(p, lane, W);
  __syncwarp();  // the previous reads of buf are done
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    if (i < W) buf[i] = p[0][j] + p[1][j];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int src = lane * NPT + j - jj;
    if (lane * NPT + j < W && src >= 0) x[j] -= buf[src];
  }
  wl::carry_pass<NPT>(x, lane, W);
}

// One group on one lane with carried flag w. Returns the fresh flag w_f;
// `on`: the lane worked (w & w_f); `moved`: an idle group's carry passes
// changed a limb.
template <int NPT>
__device__ __forceinline__ bool group(Walk<NPT>& s, bool w, const LaneParams& lp,
                                      int sim_steps, Stage<NPT>& st, int lane,
                                      int W, bool& on, bool& moved, Clock& ck) {
  ck.mark(PH_OTHER);
  float m[3];
  int t[3];
  {
    int e[3][NPT];
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      e[0][j] = s.r[RP][j];
      e[1][j] = s.r[RC][j];
      e[2][j] = s.r[YC][j];
    }
    wl::value_est_ordered_rows<NPT, 3, true>(e, st, lane, W, m, t);
  }
  const float bp = wl::bits_est_magic(m[0], t[0]), bc = wl::bits_est_magic(m[1], t[1]);
  const float by = wl::bits_est_magic(m[2], t[2]);
  const bool wf = lp.active && bc > lp.bits_stop && by < lp.y_cap;
  on = w && wf;
  moved = false;
  ck.mark(PH_EST);
  if (!on) {  // the identity matrix: one carry pass a row
    int old[NROW][NPT];
#pragma unroll
    for (int r = 0; r < NROW; r++)
#pragma unroll
      for (int j = 0; j < NPT; j++) old[r][j] = s.r[r][j];
    wl::carry_pass_rows<NPT, NROW>(s.r, lane, W);
    bool ch = false;
#pragma unroll
    for (int r = 0; r < NROW; r++)
#pragma unroll
      for (int j = 0; j < NPT; j++) ch |= old[r][j] != s.r[r][j];
    moved = __any_sync(WL_FULL, ch);
    ck.mark(PH_IDLE);
    ck.count(N_IDLE);
    return wf;
  }
  if (bp - bc > 20.0f) {  // big: (rp, xp, yp) -= qd 2^(16 jj) (rc, xc, yc)
    int qd, jj;
    wl::digit_est_jax(m[0], t[0], fabsf(m[1]), t[1], 24, qd, jj);
    qd = wl::mulw(qd, fsign(m[1]));
    int* buf = st[0] + 8;
    submul_shift<NPT>(s.r[RP], s.r[RC], qd, jj, buf, lane, W);
    submul_shift<NPT>(s.r[XP], s.r[XC], qd, jj, buf, lane, W);
    submul_shift<NPT>(s.r[YP], s.r[YC], qd, jj, buf, lane, W);
    ck.mark(PH_DIGIT);
    ck.count(N_DIGIT);
    return wf;
  }
  // Lehmer group on ~27-bit top words at the larger row's scale: the
  // plain version's steps, qmax = floor((2^13 - epmx) / max(emax, 1)),
  // can = |vc| > 32 & qmax > 0, q = clip(floor(up / vc), +-qmax)
  const float sh = fmaxf(bp, bc) - 26.0f;
  int up = top_word(m[0], t[0], sh), vc = top_word(m[1], t[1], sh);
  int mp0 = 1, mp1 = 0, mc0 = 0, mc1 = 1, parg = 0;
  // up and vc as f32 and 1 / vc, each taken a step ahead (up's is the last
  // step's vc's), so that a step's chain is its quotient and its remainder
  float uf = (float)up, vf = (float)vc, rv = wl::rcp_f32(vf);
#pragma unroll 8
  for (int k = 0; k < sim_steps; k++) {
    const int emax = max(max(abs(mc0), abs(mc1)), 1);
    const int room = kLim - max(abs(mp0), abs(mp1));  // >= 0
    if (!(abs(vc) > 32 && room >= emax)) break;  // and so every later step
    const int sg = vc < 0 ? -1 : 1, nvc = -vc;
    int q = wl::floor_quot(sg * up, sg * nvc, uf * rv);
    int nv = up + wl::mulw(q, nvc);
    float nvf = (float)nv, rvn = wl::rcp_f32(nvf);
    if (min(abs(q), 16384) * emax > room) {  // |q| > qmax: the clip binds
      const int qmax = wl::quot_small(room, emax);
      q = q < 0 ? -qmax : qmax;
      nv = up + wl::mulw(q, nvc);
      nvf = (float)nv;
      rvn = wl::rcp_f32(nvf);
    }
    up = vc;
    uf = vf;
    vc = nv;
    vf = nvf;
    rv = rvn;
    const int n0 = mp0 - wl::mulw(q, mc0), n1 = mp1 - wl::mulw(q, mc1);
    mp0 = mc0;
    mp1 = mc1;
    mc0 = n0;
    mc1 = n1;
    parg ^= 1;
  }
  ck.mark(PH_SIM);
  {  // (p, c) <- (carry_pass(a0 p + a1 c), carry_pass(b0 p + b1 c)), each pair
    int n[NROW][NPT];
#pragma unroll
    for (int j = 0; j < NPT; j++) {
#pragma unroll
      for (int k = 0; k < NROW; k += 2) {
        const int p = s.r[k][j], c = s.r[k + 1][j];
        n[k][j] = wl::mulw(mp0, p) + wl::mulw(mp1, c);
        n[k + 1][j] = wl::mulw(mc0, p) + wl::mulw(mc1, c);
      }
    }
    wl::carry_pass_rows<NPT, NROW>(n, lane, W);
#pragma unroll
    for (int r = 0; r < NROW; r++)
#pragma unroll
      for (int j = 0; j < NPT; j++) s.r[r][j] = n[r][j];
  }
  s.par ^= parg;
  ck.mark(PH_APPLY);
  ck.count(N_SIM);
  return wf;
}

// The lane's bits_stop, active and y_cap (from r0's ordered estimate, as
// loaded), and, when N = 2, whether r1 (row 1, as loaded) starts the walk.
template <int NPT, int N>
__device__ __forceinline__ LaneParams lane_params(const int (&r)[N][NPT],
                                                  const float* bits_stop,
                                                  const unsigned char* active,
                                                  int row, Stage<NPT>& st,
                                                  int lane, int W, bool& w) {
  LaneParams lp;
  lp.bits_stop = bits_stop[row];
  lp.active = active == nullptr || active[row] != 0;
  float m[N];
  int t[N];
  wl::value_est_ordered_rows<NPT, N, false>(r, st, lane, W, m, t);
  lp.y_cap = wl::bits_est(m[0], t[0]) - lp.bits_stop + 24.0f;
  w = N == 2 && lp.active && wl::bits_est(m[N - 1], t[N - 1]) > lp.bits_stop;
  return lp;
}

struct Out {
  int *rp, *rc, *xp, *xc, *yp, *yc, *par, *iters;
};

template <int NPT>
__device__ __forceinline__ void store(const Walk<NPT>& s, const Out& o,
                                      size_t off, int row, int count, int lane,
                                      int W) {
  int* dst[NROW] = {o.rp, o.rc, o.xp, o.xc, o.yp, o.yc};
#pragma unroll
  for (int r = 0; r < NROW; r++) wl::store_row<NPT>(s.r[r], dst[r] + off, W, lane);
  if (lane == 0) {
    o.par[row] = s.par;
    if (o.iters != nullptr) o.iters[row] = count;
  }
}

// The stage's first 8 words of each row stay 0 (limbs below 0); the
// estimates' first __syncwarp orders these stores before any read.
template <int NPT>
__device__ __forceinline__ void stage_init(Stage<NPT>& st, int lane) {
  if (lane < 8) st[0][lane] = st[1][lane] = st[2][lane] = 0;
}

// Kernel A's walk of one lane from its entry until its flag drops or
// max_groups; work[row] = its stop group t, or -1 once it is a fixed point
// (or at the cap); work[B] = max t.
template <int NPT>
__device__ __forceinline__ void walk_row(const int* r0, const int* r1,
                                         const float* bits_stop,
                                         const unsigned char* active,
                                         const Out& o, int* work, int row,
                                         int B, int L, int max_groups,
                                         int sim_steps, Stage<NPT>& st,
                                         int lane) {
  const size_t off = (size_t)row * (size_t)L;
  Clock ck;
  ck.start();
  int e[2][NPT];
  wl::load_row<NPT>(e[0], r0 + off, L, lane);
  wl::load_row<NPT>(e[1], r1 + off, L, lane);
  bool w;
  const LaneParams lp = lane_params<NPT, 2>(e, bits_stop, active, row, st, lane, L, w);
  wl::carry_pass_rows<NPT, 2>(e, lane, L);
  Walk<NPT> s;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int one = lane * NPT + j == 0 ? 1 : 0;
    s.r[RP][j] = e[0][j];
    s.r[RC][j] = e[1][j];
    s.r[XP][j] = one;
    s.r[XC][j] = 0;
    s.r[YP][j] = 0;
    s.r[YC][j] = one;
  }
  s.par = 0;
  int g = 0, count = 0;
  bool done = false;
  while (g < max_groups && w) {  // w is set here, so the lane works if w_f
    bool on, moved;
    w = group<NPT>(s, true, lp, sim_steps, st, lane, L, on, moved, ck);
    g++;
    if (on) count++;
    else done = !moved;  // idle on the rows it judged: a fixed point
  }
  if (g == max_groups) done = true;
  store<NPT>(s, o, off, row, count, lane, L);
  ck.flush(row, lane);
  if (lane == 0) {
    work[row] = done ? -1 : g;
    atomicMax(work + B, g);
  }
}

// Kernel B's groups t .. G - 1 of one lane kernel A left before G, from its
// stored rows, with w = false.
template <int NPT>
__device__ __forceinline__ void finish_row(const int* r0, const float* bits_stop,
                                           const unsigned char* active,
                                           const Out& o, int row, int t, int G,
                                           int L, int sim_steps, Stage<NPT>& st,
                                           int lane) {
  const size_t off = (size_t)row * (size_t)L;
  Clock ck;
  ck.start();
  Walk<NPT> s;
  bool w;
  int e0[1][NPT];
  wl::load_row<NPT>(e0[0], r0 + off, L, lane);
  const LaneParams lp = lane_params<NPT, 1>(e0, bits_stop, active, row, st, lane, L, w);
  const int* src[NROW] = {o.rp, o.rc, o.xp, o.xc, o.yp, o.yc};
#pragma unroll
  for (int r = 0; r < NROW; r++) wl::load_row<NPT>(s.r[r], src[r] + off, L, lane);
  s.par = o.par[row];
  int count = o.iters != nullptr ? o.iters[row] : 0;
  w = false;
  for (int g = t; g < G; g++) {
    bool on, moved;
    const bool wf = group<NPT>(s, w, lp, sim_steps, st, lane, L, on, moved, ck);
    if (on) count++;
    if (!on && !moved && !wf) break;  // every later group is this one
    w = wf;
  }
  store<NPT>(s, o, off, row, count, lane, L);
  ck.flush(row, lane);
}

// Kernel A: block b walks lane b, then the lanes past the grid from the
// counter work[B + 1].
template <int NPT>
__global__ void __launch_bounds__(32)
    lehmer_euclid_walk_kernel(const int* __restrict__ r0, const int* __restrict__ r1,
                              const float* __restrict__ bits_stop,
                              const unsigned char* __restrict__ active, Out o,
                              int* __restrict__ work, int B, int L, int max_groups,
                              int sim_steps) {
  __shared__ Stage<NPT> st;
  const int lane = threadIdx.x;
  stage_init<NPT>(st, lane);
  for (int row = blockIdx.x; row < B;) {
    walk_row<NPT>(r0, r1, bits_stop, active, o, work, row, B, L, max_groups,
                  sim_steps, st, lane);
    if ((int)gridDim.x >= B) break;
    int next = 0;
    if (lane == 0) next = (int)gridDim.x + atomicAdd(work + B + 1, 1);
    row = __shfl_sync(WL_FULL, next, 0);
  }
}

// Kernel B: the groups t .. G - 1 of the lanes kernel A left before G =
// min(work[B], max_groups); block b takes lanes 32 b .. 32 b + 31.
template <int NPT>
__global__ void __launch_bounds__(32)
    lehmer_euclid_finish_kernel(const int* __restrict__ r0,
                                const float* __restrict__ bits_stop,
                                const unsigned char* __restrict__ active, Out o,
                                const int* __restrict__ work, int B, int L,
                                int max_groups, int sim_steps) {
  __shared__ Stage<NPT> st;
  const int lane = threadIdx.x;
  const int first = blockIdx.x * 32, mine = first + lane;
  const int G = min(work[B], max_groups);
  const int t = mine < B ? work[mine] : -1;
  uint32_t todo = __ballot_sync(WL_FULL, t >= 0 && t < G);
  if (todo == 0) return;  // uniform across the warp
  stage_init<NPT>(st, lane);
  while (todo) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    finish_row<NPT>(r0, bits_stop, active, o, first + k, __shfl_sync(WL_FULL, t, k),
                    G, L, sim_steps, st, lane);
  }
}

template <int NPT>
int launch(const int* r0, const int* r1, const float* bits_stop,
           const unsigned char* active, const Out& o, int* work, int B, int L,
           int max_groups, int sim_steps, cudaStream_t stream) {
  static int per_sm = 0;  // resident walk blocks an SM (host calls only)
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lehmer_euclid_walk_kernel<NPT>, 32, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = B < resident ? B : resident;
  lehmer_euclid_walk_kernel<NPT><<<blocks, 32, 0, stream>>>(
      r0, r1, bits_stop, active, o, work, B, L, max_groups, sim_steps);
  lehmer_euclid_finish_kernel<NPT><<<(B + 31) / 32, 32, 0, stream>>>(
      r0, bits_stop, active, o, work, B, L, max_groups, sim_steps);
  return 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). r0, r1: contiguous int32 (B, L)
// magnitudes on the device, L <= 288; bits_stop: (B,) f32; active: (B,)
// bool bytes, or null for every lane; outputs: the six (B, L) rows and
// par (B,); iters, when not null, receives each lane's working groups;
// work: (B + 2) int32 scratch (work[B], the batch's groups, and work[B +
// 1], kernel A's lane counter, are zeroed here). Launches kernel A and
// kernel B on the stream and returns cudaGetLastError() (0 on success); 1
// (cudaErrorInvalidValue) for an unsupported L.
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
  cudaError_t e = cudaMemsetAsync(work + B, 0, 2 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  int rc_ = 0;
  switch ((L + 31) / 32) {
#define K7_CASE(n)                                                        \
  case n:                                                                 \
    rc_ = launch<n>(r0, r1, bits_stop, active, o, work, B, L, max_groups, \
                    sim_steps, s);                                        \
    break;
    K7_CASE(1) K7_CASE(2) K7_CASE(3) K7_CASE(4) K7_CASE(5) K7_CASE(6)
    K7_CASE(7) K7_CASE(8) K7_CASE(9)
#undef K7_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc_ != 0) return rc_;
  return (int)cudaGetLastError();
}

#ifdef K7_PHASES
// lehmer_euclid_launch with the phase clock: phases, (B, K7_NPH) uint64 on
// the device, zeroed by the caller, receives each lane's cycles by phase
// and its groups by kind (the enum above).
extern "C" int lehmer_euclid_phases_launch(
    const int* r0, const int* r1, const float* bits_stop,
    const unsigned char* active, int* rp, int* rc, int* xp, int* xc, int* yp,
    int* yc, int* par, int* iters, int* work, int B, int L, int max_groups,
    int sim_steps, unsigned long long* phases, void* stream) {
  const cudaError_t e = cudaMemcpyToSymbolAsync(
      k7_phase_out, &phases, sizeof(phases), 0, cudaMemcpyHostToDevice,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return lehmer_euclid_launch(r0, r1, bits_stop, active, rp, rc, xp, xc, yp,
                              yc, par, iters, work, B, L, max_groups,
                              sim_steps, stream);
}
#endif
