// K6d: compose2's second gcd, its two pipelines merged, on Hopper
// (sm_90a).
//
// Replaces the last selects of the second gcd in
// cofhe_tpu/ops/forms2.py::CG.compose2_unreduced (588-589; XLA, not
// Pallas). Its plain version is
// cofhe_tpu_torch/ops/forms2.py::gcd2_merge_plain, six torch ops:
//
//   g    = g8 (W8 = 8 limbs, zero-extended to Lh) where fits8, else gF
//   eta0 = eta0_8 (zero-extended) where fits8, else eta0F
//
// The two ops before the rare pipeline's K1 (rp_m[..., :8] made
// contiguous for the width-8 K1, and where(rare, rpF_m, 0)) sit between a
// K4 and a K1 that this kernel cannot reach, and stay torch ops.
//
// One warp a batch row, four rows a block, each thread the limbs lane,
// lane + 32, ...: every load and store of a row's limbs is coalesced, and
// each output limb reads only the pipeline that fits8 picks.
//
// What bounds it on this card: its bytes (two Lh rows written, two rows
// read from one pipeline), a few operations a limb; at the main path's
// 128-256 rows one launch, where the torch ops took six.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // batch rows (warps) a block

struct Params {
  const int* g8;  // (B, W8)
  const int* eta0_8;
  const int* gF;  // (B, Lh)
  const int* eta0F;
  const unsigned char* fits8;  // (B,)
  int* g;                      // (B, Lh)
  int* eta0;
  int B, W8, Lh;
};

__global__ void __launch_bounds__(32 * kWarps) gcd2_merge_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;  // B * Lh < 2^31 (the launcher)
  if (b >= p.B) return;
  const int W8 = p.W8, Lh = p.Lh, off8 = b * W8, off = b * Lh;
  if (p.fits8[b]) {
    for (int i = lane; i < Lh; i += 32) {
      p.g[off + i] = i < W8 ? p.g8[off8 + i] : 0;
      p.eta0[off + i] = i < W8 ? p.eta0_8[off8 + i] : 0;
    }
  } else {
    for (int i = lane; i < Lh; i += 32) {
      p.g[off + i] = p.gF[off + i];
      p.eta0[off + i] = p.eta0F[off + i];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). in: 5 device pointers, g8,
// eta0_8 ((B, W8) int32), gF, eta0F ((B, Lh) int32), fits8 ((B,) bool);
// out: 2 device pointers, g, eta0 ((B, Lh) int32). Rows contiguous; 1 <=
// W8 <= Lh <= 288, B Lh < 2^31. Returns cudaGetLastError() after the
// launch; cudaErrorInvalidValue for sizes outside that.
extern "C" int gcd2_merge_launch(void* const* in, void* const* out, int B, int W8,
                                 int Lh, void* stream) {
  if (B <= 0) return 0;
  if (W8 < 1 || W8 > Lh || Lh > 288 || (long long)B * Lh >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.g8 = (const int*)in[0];
  p.eta0_8 = (const int*)in[1];
  p.gF = (const int*)in[2];
  p.eta0F = (const int*)in[3];
  p.fits8 = (const unsigned char*)in[4];
  p.g = (int*)out[0];
  p.eta0 = (int*)out[1];
  p.B = B;
  p.W8 = W8;
  p.Lh = Lh;
  const int blocks = (B + kWarps - 1) / kWarps;
  gcd2_merge_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
