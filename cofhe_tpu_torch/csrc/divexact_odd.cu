// K5d: the exact quotient by an odd divisor on Hopper (sm_90a).
//
// Replaces cofhe_tpu/ops/limb.py::mag_divexact_odd (566-593; XLA, not
// Pallas: an LSB-first Hensel scan over the quotient's limbs). Its plain
// torch version is cofhe_tpu_torch/ops/limb.py::mag_divexact_odd_plain
// (a product with the 2-adic Newton inverse of y, limb.inv_pow2).
//
//   q = x * y^-1 mod 2^(16 Lo)   for odd y (Lo <= x's width)
//
// which is x / y whenever y | x and the quotient fits Lo limbs. Like the
// JAX scan, the kernel needs only the inverse of y's low limb mod 2^16,
// which it takes itself (wl::modinv16): digit k is the low 16 bits of
// what is left at limb k times that inverse, and d_k * y is taken off
// limbs k.. Only the low Lo limbs of x and y count, each read as its low
// 16 bits, as in the plain version.
//
// One warp a row (four rows a block). Thread t holds limbs
// [t*NPT, t*NPT + NPT) of the remainder as 64-bit sums that are never
// shifted, and wl::hensel_steps (shared with K4) runs the digits: step k
// folds the carry of limb k-1 (a multiple of 2^16 by then) into limb k,
// the owner of limb k takes the digit and broadcasts it, and every thread
// subtracts d_k * y[i - k] from its limbs i in [k, Lo), with y in shared
// memory. A limb's sum stays within 2^41 of 0.
//
// What bounds it on this card: the Lo steps run one after another, each a
// shuffle, a digit and a shuffle before its Lo - k products, so at the
// main path's 128-256 rows the time is one warp's latency through Lo
// dependent steps. The function's own bound is its bytes (two rows in,
// one out): its Lo (Lo + 1) / 2 limb products, done as products with
// y^-1, would fit the int8 tensor cores in a small fraction of that.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;    // rows (warps) a block
constexpr int kMax = 288;    // limbs a row at most (9 a thread)

template <int NPT>
__global__ void __launch_bounds__(32 * kWarps)
divexact_odd_kernel(const int* __restrict__ x, const int* __restrict__ y,
                    int* __restrict__ q, int B, int Ly, int sx, int sy,
                    int Lo) {
  __shared__ uint32_t s_y[kWarps][kMax];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= B) return;
  const int* px = x + row * sx;
  const int* py = y + row * sy;
  const int ny = min(Ly, Lo);
  uint32_t* yy = s_y[warp];
  for (int i = lane; i < ny; i += 32) yy[i] = (uint32_t)py[i] & 0xFFFFu;
  long long r[NPT];
  int qd[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    r[j] = i < Lo ? (long long)((uint32_t)px[i] & 0xFFFFu) : 0;
    qd[j] = 0;
  }
  __syncwarp();
  const uint32_t yinv = (uint32_t)wl::modinv16((int)yy[0]);
  wl::hensel_steps<NPT, true>(r, qd, yy, ny, Lo, yinv, true, Lo, lane);
  wl::store_row<NPT>(qd, q + row * Lo, Lo, lane);
}

template <int NPT>
void launch(const int* x, const int* y, int* q, int B, int Ly, int sx,
            int sy, int Lo, cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  divexact_odd_kernel<NPT><<<blocks, 32 * kWarps, 0, s>>>(x, y, q, B, Ly, sx,
                                                          sy, Lo);
}

}  // namespace

// x: (B, Lx) and y: (B, Ly) int32 rows at row strides sx, sy (unit limb
// stride), y odd; q: (B, Lo) contiguous. 1 <= Lo <= min(Lx, 288).
extern "C" int divexact_odd_launch(const int* x, const int* y, int* q, int B,
                                   int Lx, int Ly, int sx, int sy, int Lo,
                                   void* stream) {
  if (B <= 0) return 0;
  if (Lo > Lx) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((Lo + 31) / 32) {
#define K5D_CASE(n)                                 \
  case n:                                           \
    launch<n>(x, y, q, B, Ly, sx, sy, Lo, s);       \
    break;
    K5D_CASE(1) K5D_CASE(2) K5D_CASE(3) K5D_CASE(4) K5D_CASE(5) K5D_CASE(6)
    K5D_CASE(7) K5D_CASE(8) K5D_CASE(9)
#undef K5D_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
