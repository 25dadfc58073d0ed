// KT: the exact tail of the form reduction on Hopper (sm_90a).
//
// Replaces the XLA while loop of cofhe_tpu/ops/forms.py::reduce_batch (not
// a Pallas kernel in the JAX package; in eager PyTorch it was a host-tested
// loop of ~40 small ops an iteration, one host sync each). Its plain torch
// version is cuda_group.reduce_exact_plain: canonicalize K3's redundant
// (a, b, c), then cofhe_tpu_torch/ops/forms.py::reduce_batch. Each warp
// takes one lane from K3's redundant output to the unique reduced form:
//
//   canonicalize a, b (signed), c;
//   loop while not reduced (forms._is_reduced: |b| <= a <= c, b >= 0 when
//   |b| = a or a = c), at most max_iters times:
//     rho (a, b, c) -> (c, -b, a) when the form is normal (forms._is_normal);
//     then, when it is not normal, one translation b -> b - 2 a q,
//     c -> c + q (a q - b), with q = sign(b) qd 2^(16 s);
//     b = -a becomes +a (same c).
//
// The quotient is the kernel's own: qd < 2^40 and the limb shift s come
// from float64 estimates of a and b (the top four limbs, wl::value_est_wide)
// so that q is round(b / 2a) when that is below 2^39 (one step, or one more
// of q = +-1 after a last-ulp miss), and its top ~24-40 bits otherwise (a
// giant quotient of an inverse pair or a power of f falls 24+ bits a step).
// Any integer q is a unimodular translation and reduced forms are unique,
// so the output equals the reference's bit for bit although the step
// sequence differs; q >= 1 whenever |b| >= a, so every step moves. A lane
// still unreduced after max_iters steps reports max_iters + 1 in `iters`.
//
// What bounds it on this card: the latency of one warp's chain of
// collectives. The bytes (three rows in, three rows and a sign out) are
// 0.00013 ms at 128 lanes; at the main path's 128-256 lanes a lane takes
// 0.00-0.03 steps, so its time is the entry: load, canonicalize, compare,
// store. A step (deep-tail lanes) is two 64-bit products through a limb
// shift, two 4-digit spreads with carry passes, canonicalizations (warp
// scans) and compares, ~130 int32 operations a limb.
//
// The design cuts the collectives on that chain (the kernel's first
// version ran every canonicalization and compare one after another):
// - one canonicalization pass for several rows (wl::canonicalize_rows): a,
//   b and c at entry, nb and t in a step; their floor passes, map scans
//   and sign shuffles run side by side, the negation is a select, and a
//   row's nonzero ballot gives both the negation and the sign;
// - a carry map is three 2-bit fields of one int (wl::map_compose), a few
//   shifts and masks where a base-3 code took integer divisions by 3 and 9
//   on each of the scan's five levels and each limb of a thread;
// - a compare (wl::mag_cmp) is two independent ballots and no shuffle; the
//   three compares a step needs (b : a, a : c and, for the rho's new a,
//   b : c) run together at the top of the loop, where b = -a -> +a after a
//   translation also reads b : a;
// - a and c live in shared rows as well once a lane takes its first
//   translation (a rho swaps the rows' roles): the product a |q| reads a
//   shifted by s limbs straight from its row, with no store and sync on
//   the chain; t takes one store, then its product reads it shifted;
// - the two value estimates of the quotient run side by side
//   (wl::value_est_wide reads the top limbs with a fixed number of
//   shuffles).
// The quotient rule is the first version's, and so are the steps and
// `iters`. Every row stays in registers (blocked limbs, wl::); no division
// in the limbs.
// Tensor cores and TMA do not fit: a different scalar per lane times one
// row, read once. Launch shape: four lanes a block, as K2 and K3.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;    // lanes (warps) a block
constexpr int kQBits = 40;   // a translation's digit stays below 2^kQBits

// out = x * qd * 2^(16 s) as balanced redundant limbs, x canonical in the
// warp's shared row `row` (zeros past W; 0 < qd < 2^kQBits: each product
// is below 2^56), read shifted by s limbs
template <int NPT>
__device__ __forceinline__ void mul_shifted(const int* row, long long qd,
                                            int s, int (&out)[NPT], int lane,
                                            int W) {
  long long p[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    p[j] = (long long)(i < W && i >= s ? row[i - s] : 0) * qd;
  }
  __syncwarp();  // the row may be written again after this
  wl::spread_carry<NPT, 4>(p, out, lane, W);
  wl::carry_pass<NPT>(out, lane, W);
}

template <int NPT>
__device__ __forceinline__ void store_limbs(const int (&x)[NPT], int* row,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < NPT; j++) row[lane * NPT + j] = x[j];
}

// |q| = qd * 2^(16 s) ~ |b| / 2a from float64 estimates (|b| >= a > 0)
template <int NPT>
__device__ __forceinline__ void quotient(const int (&a)[NPT],
                                         const int (&b)[NPT], int lane,
                                         long long& qd, int& s) {
  double ma, mb;
  int ta, tb;
  wl::value_est_wide<NPT>(a, lane, ma, ta);
  wl::value_est_wide<NPT>(b, lane, mb, tb);
  s = 0;
  qd = 1;
  if (ma <= 0.0) return;  // a = 0: not a form; the cap ends the loop
  const double rr = mb / (2.0 * ma);        // |b| / 2a = rr * 2^e2
  const int e2 = 16 * (tb - ta);
  const int lg = ilogb(rr) + e2;            // floor(log2(|b| / 2a))
  if (lg >= kQBits - 1) s = (lg - (kQBits - 1) + 15) / 16;
  const long long q = llrint(rr * wl::pow2d(e2 - 16 * s));
  qd = q < 1 ? 1 : q;
}

template <int NPT>
__global__ void __launch_bounds__(kWarps * 32)
    reduce_exact_kernel(const int* __restrict__ a_in,
                        const int* __restrict__ b_in,
                        const int* __restrict__ c_in, int* __restrict__ a_out,
                        int* __restrict__ bs_out, int* __restrict__ b_out,
                        int* __restrict__ c_out, int* __restrict__ iters_out,
                        int B, int L, int max_iters) {
  __shared__ int rows[kWarps][3][32 * NPT];  // a, c and t of each lane
  const int warp = threadIdx.x >> 5;
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warp leaves together
  int* ra = rows[warp][0];  // a's row (once stored); a rho swaps ra, rc
  int* rc = rows[warp][1];
  int* rt = rows[warp][2];
  const size_t off = (size_t)row * (size_t)L;

  int x[3][NPT], sg[3];
  wl::load_row<NPT>(x[0], a_in + off, L, lane);
  wl::load_row<NPT>(x[1], b_in + off, L, lane);
  wl::load_row<NPT>(x[2], c_in + off, L, lane);
  wl::canonicalize_rows<NPT, 3>(x, sg, lane, L);
  int(&a)[NPT] = x[0];
  int(&b)[NPT] = x[1];
  int(&c)[NPT] = x[2];
  int bs = sg[1];

  int it = 0;
  bool reduced = false, translated = false, stored = false;
  for (;;) {
    const int cba = wl::mag_cmp<NPT>(b, a, lane), cac = wl::mag_cmp<NPT>(a, c, lane),
              cbc = wl::mag_cmp<NPT>(b, c, lane);
    if (translated && bs < 0 && cba == 0) bs = 1;  // b = -a -> +a
    bool normal = cba < 0 || (cba == 0 && bs >= 0);
    reduced = normal && (cac < 0 || (cac == 0 && bs >= 0));
    if (reduced || it >= max_iters) break;
    it++;
    translated = false;
    if (normal) {  // rho: (a, b, c) -> (c, -b, a)
#pragma unroll
      for (int j = 0; j < NPT; j++) {
        const int t = a[j];
        a[j] = c[j];
        c[j] = t;
      }
      int* t = ra;
      ra = rc;
      rc = t;
      bs = -bs;
      normal = cbc < 0 || (cbc == 0 && bs >= 0);
    }
    if (normal) continue;
    if (!stored) {  // a lane's first translation: a and c into their rows
      store_limbs<NPT>(a, ra, lane);
      store_limbs<NPT>(c, rc, lane);
      __syncwarp();
      stored = true;
    }
    // translation by q = sq * qd * 2^(16 s), sq = sign(b)
    long long qd;
    int s;
    quotient<NPT>(a, b, lane, qd, s);
    const int sq = bs;
    int aq[NPT], u[NPT], v[2][NPT], vs[2];
    mul_shifted<NPT>(ra, qd, s, aq, lane, L);  // a |q|
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      v[0][j] = bs * b[j] - 2 * sq * aq[j];  // nb = b - 2 a q
      v[1][j] = sq * aq[j] - bs * b[j];      // t = a q - b
    }
    wl::canonicalize_rows<NPT, 2>(v, vs, lane, L);
    store_limbs<NPT>(v[1], rt, lane);
    __syncwarp();
    mul_shifted<NPT>(rt, qd, s, u, lane, L);  // |a q - b| |q|
#pragma unroll
    for (int j = 0; j < NPT; j++) c[j] += sq * vs[1] * u[j];
    wl::canonicalize<NPT>(c, lane, L);
    store_limbs<NPT>(c, rc, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NPT; j++) b[j] = v[0][j];
    bs = vs[0];
    translated = true;
  }
  if (iters_out != nullptr && lane == 0)
    iters_out[row] = reduced ? it : max_iters + 1;
  if (lane == 0) bs_out[row] = bs;
  wl::store_row<NPT>(a, a_out + off, L, lane);
  wl::store_row<NPT>(b, b_out + off, L, lane);
  wl::store_row<NPT>(c, c_out + off, L, lane);
}

template <int NPT>
void launch(const int* a, const int* b, const int* c, int* ao, int* bso,
            int* bo, int* co, int* iters, int B, int L, int max_iters,
            cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  reduce_exact_kernel<NPT><<<blocks, kWarps * 32, 0, stream>>>(
      a, b, c, ao, bso, bo, co, iters, B, L, max_iters);
}

}  // namespace

// Plain C entry point (bound with ctypes). a, b, c: contiguous int32 (B, L)
// redundant rows on the device (a, c positive, b signed), L <= 288; ao, bo,
// co (B, L) and bso (B,) receive the canonical reduced form (a, b_sign, b,
// c); iters, when not null, each row's number of steps (max_iters + 1 for
// a row still unreduced at the cap). Returns cudaGetLastError() after the
// launch (0 on success); 1 (cudaErrorInvalidValue) for an unsupported L.
extern "C" int reduce_exact_launch(const int* a, const int* b, const int* c,
                                   int* ao, int* bso, int* bo, int* co,
                                   int* iters, int B, int L, int max_iters,
                                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 31) / 32) {
#define KT_CASE(n)                                                          \
  case n:                                                                   \
    launch<n>(a, b, c, ao, bso, bo, co, iters, B, L, max_iters, s);         \
    break;
    KT_CASE(1) KT_CASE(2) KT_CASE(3) KT_CASE(4) KT_CASE(5) KT_CASE(6)
    KT_CASE(7) KT_CASE(8) KT_CASE(9)
#undef KT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
