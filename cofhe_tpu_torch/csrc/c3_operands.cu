// K6e: c3's operands in compose2's epilogue on Hopper (sm_90a).
//
// Replaces cofhe_tpu/ops/forms2.py::CG.compose2_unreduced 638-641 (XLA,
// not Pallas): limb.mag_v2 and the two limb.mag_shr_bits_dyn before c3's
// exact quotient. Its plain version is
// cofhe_tpu_torch/ops/forms2.py::c3_operands_plain, about 30 torch ops
// with two gathers of (B, Lm) indices each:
//
//   e       = v2(a3), the trailing zero bits of a3; 16 L for a zero a3
//   a3_odd  = a3 >> e, cut or zero-extended to Lm limbs
//   csum_sh = csum >> min(e, 16 Lm - 1)
//
// each shift as limb.shr_limbs_dyn / mag_shr_bits_dyn make it: with q =
// bits / 16 and r = bits % 16, limb i is (x[i + q] >> r) | ((x[i + q + 1]
// << (16 - r)) & 0xFFFF), limbs past the row read as 0 (so r = 0 gives
// x[i + q]). c3 = csum_sh / a3_odd stays K5d's.
//
// One warp a batch row, four rows a block. The shift is one count across
// the whole row, so a limb's source may sit anywhere in it: both rows are
// staged in the warp's shared memory (lane-strided, coalesced loads), e
// comes from a warp minimum over the threads' lowest nonzero limbs and the
// trailing zeros of that limb (__ffs), and each thread writes the limbs
// lane, lane + 32, ... from two shared-memory reads each.
//
// What bounds it on this card: its bytes (a3 and csum read once, two Lm
// rows written), a few operations a limb; at the main path's 128-256
// rows one launch, where the torch ops took ~30.
//
// Two classes of instance, the same code: rows staged for 288 limbs
// (NPT = 9 limbs a thread; L, Lm <= 288, every k=128 width) and for 320
// (NPT = 10: compose2 at k=256, a3 (B, 160) and csum (B, 296)). The
// template argument names the class in the profiler
// (c3_operands_kernel<10> is wide); a narrow instance keeps its 9 KB of
// shared memory, a wide one takes 10 KB. The shift counts stay below
// 16 * 320 and every limb is read from shared memory, so nothing else
// depends on the width.

#include <cstdint>
#include <cuda_runtime.h>

#define WL_FULL 0xffffffffu

namespace {

constexpr int kWarps = 4;  // batch rows (warps) a block
constexpr int kNarrow = 9; // limbs a thread of the narrow class: rows <= 288
constexpr int kWide = 10;  // and of the wide one: rows <= 320

struct Params {
  const int* a3;    // (B, L)
  const int* csum;  // (B, Lm)
  int* csum_sh;     // (B, Lm)
  int* a3_odd;      // (B, Lm)
  int B, L, Lm;
};

// out[i] = limb i of (the n-limb row s) >> bits, for i < w
__device__ __forceinline__ void shr_dyn(const int* s, int n, int bits, int* out,
                                        int w, int lane) {
  const int q = bits >> 4, r = bits & 15;
  for (int i = lane; i < w; i += 32) {
    const int k = i + q;
    const int lo = k < n ? s[k] : 0, up = k + 1 < n ? s[k + 1] : 0;
    out[i] = (lo >> r) | (int)(((uint32_t)up << (16 - r)) & 0xFFFFu);
  }
}

template <int NPT>
__global__ void __launch_bounds__(32 * kWarps) c3_operands_kernel(const Params p) {
  __shared__ int stage[kWarps][2][32 * NPT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= p.B) return;
  const int L = p.L, Lm = p.Lm;
  int* sa = stage[warp][0];
  int* sc = stage[warp][1];
  const int* a3 = p.a3 + b * L;
  const int* cs = p.csum + b * Lm;
  int first = L;  // this thread's lowest nonzero limb of a3
  for (int i = lane; i < L; i += 32) {
    const int v = a3[i];
    sa[i] = v;
    if (v != 0 && first == L) first = i;
  }
  for (int i = lane; i < Lm; i += 32) sc[i] = cs[i];
  first = __reduce_min_sync(WL_FULL, first);
  __syncwarp();
  const int e = first < L ? 16 * first + __ffs(sa[first]) - 1 : 16 * L;
  shr_dyn(sa, L, e, p.a3_odd + b * Lm, Lm, lane);
  shr_dyn(sc, Lm, min(e, 16 * Lm - 1), p.csum_sh + b * Lm, Lm, lane);
}

}  // namespace

// Plain C entry point (bound with ctypes): a3 ((B, L) int32), csum ((B,
// Lm) int32), then the outputs csum_sh and a3_odd ((B, Lm) int32), all
// contiguous device rows of canonical limbs. 1 <= L, Lm <= 320 (the wide
// class where either passes 288). Returns cudaGetLastError() after the
// launch; cudaErrorInvalidValue for sizes outside that.
extern "C" int c3_operands_launch(const int* a3, const int* csum, int* csum_sh,
                                  int* a3_odd, int B, int L, int Lm, void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || L > 32 * kWide || Lm < 1 || Lm > 32 * kWide)
    return (int)cudaErrorInvalidValue;
  const Params p{a3, csum, csum_sh, a3_odd, B, L, Lm};
  const int blocks = (B + kWarps - 1) / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (L > 32 * kNarrow || Lm > 32 * kNarrow)
    c3_operands_kernel<kWide><<<blocks, 32 * kWarps, 0, s>>>(p);
  else
    c3_operands_kernel<kNarrow><<<blocks, 32 * kWarps, 0, s>>>(p);
  return (int)cudaGetLastError();
}
