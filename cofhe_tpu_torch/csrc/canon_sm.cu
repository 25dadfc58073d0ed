// K6a: signed sums to canonical sign-magnitude on Hopper (sm_90a).
//
// Replaces cofhe_tpu/ops/limb.py::canonicalize_fast (113-139; XLA, not
// Pallas) where compose2 applies it to a short signed sum:
// limb.sm_add / sm_sub (cofhe_tpu/ops/limb.py:261-271) at
// cofhe_tpu/ops/forms2.py:593 (xi's numerator g - eta0 |s|), 613
// (m2x2 = 2 m2), 633 (b3 = b1 + a1g mu, with b3 / 2 cut to Lsq limbs) and
// 637 (csum = sq + |Delta| / 4), and the NUCOMP tail's canonicalizations
// of the Lehmer cofactors and of its form values. Its plain version is
// cofhe_tpu_torch/ops/cuda_group.py::canon_sm_plain (the sum in torch ops,
// then limb.canonicalize_fast).
//
//   row r:  v = sum_t k_t * s_t[b] * m_t[b]     (m_t zero-extended or cut
//                                                 to W limbs, s_t = 1 when
//                                                 absent)
//   out:    sign(v) in {-1, 0, 1}, |v| as W canonical limbs and, when
//           asked, (|v| >> shr) cut to Wshr limbs (limb.mag_shr_bits and
//           limb.resize)
//
// for |v| < 2^(16 W), W <= 320. The sum is formed in registers, limb by
// limb in the int32 arithmetic of the plain version (wrapping, as torch's
// int32 tensors do), and canonicalized by wl::canonicalize_rows, whose
// floor passes, carry maps, sign and negation are those of
// limb.canonicalize_fast step for step, so the outputs equal the plain
// version's bit for bit on any input whose limbs stay inside int32.
//
// One warp a batch row, its limbs blocked over the 32 threads (NPT a
// thread), four rows a block. One launch takes one or two independent
// sums a row (R = 1, 2); the two rows' floor passes, map scans and ballots
// run side by side, one shuffle level for both (as KT's). A term may be a
// single row read by every batch row (row stride 0: the |Delta| / 4
// constant of csum).
//
// What bounds it on this card: its bytes at 16384 rows (each term read
// once, the outputs written once; a few int32 operations a limb); at the
// main path's 128-256 rows, one warp's latency through two floor passes,
// a five-level map scan and the sign's shuffle and ballot, about a
// microsecond, where the torch ops it replaces took ~100 launches each.
// No tensor cores (no products), no shared memory.
//
// Two classes of instance, the same code: NPT <= 9 (W <= 288, every k=128
// sum) and NPT = 10 (289 <= W <= 320: compose2's csum at k=256, sq (B,
// 296) + |Delta| / 4 at W = 296 from a (1, 320) row). NPT, the first
// template argument, names the class in the profiler (canon_sm_kernel<10,
// ...> is wide). Nothing bounds the width but the registers: the sums
// wrap as the plain version's int32 sums do, and the floor passes and
// the carry-map scan take rows of any width.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;  // batch rows (warps) a block
constexpr int kTerms = 3;  // terms a sum at most
constexpr int kRows = 2;   // sums a batch row at most

struct Term {
  const int* mag;    // (rows, L) int32 at row stride `stride`; null: absent
  const int* sign;   // (B,) int32 multiplier, or null for 1
  long long stride;  // 0: one row read by every batch row
  int L;             // limbs of the row; min(L, W) are read
  int k;             // constant multiplier
};

struct Row {
  Term t[kTerms];
  int* sign;  // (B,) out
  int* mag;   // (B, W) out
  int* shr;   // (B, Wshr) out of mag >> shr_bits, or null
};

struct Params {
  Row r[kRows];
  int B, W, shr_bits, Wshr;
};

template <int NPT, int R>
__global__ void __launch_bounds__(32 * kWarps) canon_sm_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= p.B) return;
  int x[R][NPT], sg[R];
#pragma unroll
  for (int r = 0; r < R; r++) {
#pragma unroll
    for (int j = 0; j < NPT; j++) x[r][j] = 0;
#pragma unroll
    for (int t = 0; t < kTerms; t++) {
      const Term& tm = p.r[r].t[t];
      if (tm.mag == nullptr) continue;  // the same on every thread
      const int s = wl::mulw(tm.sign == nullptr ? 1 : tm.sign[b], tm.k);
      const int* row = tm.mag + b * tm.stride;
      const int n = min(tm.L, p.W);
#pragma unroll
      for (int j = 0; j < NPT; j++) {
        const int i = lane * NPT + j;
        if (i < n) x[r][j] = (int)((uint32_t)x[r][j] + (uint32_t)wl::mulw(s, row[i]));
      }
    }
  }
  wl::canonicalize_rows<NPT, R>(x, sg, lane, p.W);
#pragma unroll
  for (int r = 0; r < R; r++) {
    const Row& o = p.r[r];
    if (lane == 0) o.sign[b] = sg[r];
    wl::store_row<NPT>(x[r], o.mag + b * p.W, p.W, lane);
    if (o.shr != nullptr) {
      int y[NPT];
      wl::shr_bits<NPT>(x[r], y, p.shr_bits, lane);
      wl::store_row<NPT>(y, o.shr + b * p.Wshr, p.Wshr, lane);
    }
  }
}

template <int NPT>
void launch(const Params& p, int rows, cudaStream_t s) {
  const int blocks = (p.B + kWarps - 1) / kWarps;
  if (rows == 1)
    canon_sm_kernel<NPT, 1><<<blocks, 32 * kWarps, 0, s>>>(p);
  else
    canon_sm_kernel<NPT, 2><<<blocks, 32 * kWarps, 0, s>>>(p);
}

}  // namespace

// Plain C entry point (bound with ctypes). For each of `rows` (1 or 2)
// sums: ptrs[9 r ..] = three terms' (mag, sign) device pointers (a term
// with a null mag is absent; the first must be present), then the sign,
// mag and shr outputs (shr null: not written); ints[9 r ..] = three terms'
// (L, k, row stride). Every term's limbs have unit stride; the outputs
// are contiguous (B,), (B, W) and (B, Wshr) int32. 1 <= W <= 320, 0 <=
// shr_bits < 16, Wshr <= W. Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for arguments outside that.
extern "C" int canon_sm_launch(void* const* ptrs, const long long* ints,
                               int rows, int B, int W, int shr_bits, int Wshr,
                               void* stream) {
  if (B <= 0) return 0;
  if (rows < 1 || rows > kRows || W < 1 || W > 320 || shr_bits < 0 ||
      shr_bits > 15 || Wshr < 0 || Wshr > W)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.B = B;
  p.W = W;
  p.shr_bits = shr_bits;
  p.Wshr = Wshr;
  for (int r = 0; r < rows; r++) {
    void* const* q = ptrs + 9 * r;
    const long long* n = ints + 9 * r;
    for (int t = 0; t < kTerms; t++) {
      Term& tm = p.r[r].t[t];
      tm.mag = (const int*)q[2 * t];
      tm.sign = (const int*)q[2 * t + 1];
      tm.L = (int)n[3 * t];
      tm.k = (int)n[3 * t + 1];
      tm.stride = n[3 * t + 2];
    }
    if (p.r[r].t[0].mag == nullptr || q[6] == nullptr || q[7] == nullptr)
      return (int)cudaErrorInvalidValue;
    p.r[r].sign = (int*)q[6];
    p.r[r].mag = (int*)q[7];
    p.r[r].shr = (int*)q[8];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch ((W + 31) / 32) {
#define K6A_CASE(n)          \
  case n:                    \
    launch<n>(p, rows, s);   \
    break;
    K6A_CASE(1) K6A_CASE(2) K6A_CASE(3) K6A_CASE(4) K6A_CASE(5) K6A_CASE(6)
    K6A_CASE(7) K6A_CASE(8) K6A_CASE(9) K6A_CASE(10)
#undef K6A_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
