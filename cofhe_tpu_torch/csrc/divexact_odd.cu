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
// which it takes itself (wl::modinv16), and makes the quotient's limbs
// LSB first, but in the Montgomery form K4 uses: digit k is the low 16
// bits of what is left at limb k times -y^-1 mod 2^16 and d_k * y is
// added at limbs k.., so the digits are Q = -x y^-1 mod 2^(16 Lo) and q =
// 2^(16 Lo) - Q, the same integer. Only the low Lo limbs of x and y count,
// each read as its low 16 bits, as in the plain version.
//
// One warp a row (four rows a block). Thread t holds limbs
// [t*NPT, t*NPT + NPT) of x + Q y as 64-bit sums that are never shifted,
// and wl::hensel_steps (shared with K4) runs the digits in blocks of NPT:
// step o belongs to thread o, which folds the carry from below into its
// limbs and takes their NPT digits one after another in registers, hands
// them to the warp by ceil(NPT / 2) + 1 shuffles, and every thread above
// it within reach of y adds d_k * y[i - k] to its limbs i, with y in
// shared memory. y's significant limbs (a warp max over its nonzero limbs)
// bound the products: compose2 divides by g and d1, almost always of one
// limb, and by a3's odd part (c3). A limb's sum stays below 2^41. The
// negation is one ballot (wl::negate_canonical).
//
// What bounds it on this card: the chain, ceil(Lo / NPT) hand-overs (29
// at compose2's 144 digits, 24 at its 72) and Lo digits of a few
// dependent integer operations on one thread each, so at the main path's
// 128-256 rows the time is one warp's latency through that chain. With a
// one-limb y no thread but the owner multiplies, so even at 16384 rows
// the chain, not the products, is the work there. The function's own
// bound is its bytes (two rows in, one out): its limb products, done as
// products with y^-1, would fit the int8 tensor cores in a small fraction
// of that.

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
  uint32_t* yy = s_y[warp];
  const int ny = wl::load_divisor(yy, py, min(Ly, Lo), lane);
  unsigned long long r[NPT];
  int qd[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    r[j] = i < Lo ? ((uint32_t)px[i] & 0xFFFFu) : 0u;
    qd[j] = 0;
  }
  const uint32_t minv = (0x10000u - (uint32_t)wl::modinv16((int)yy[0])) & 0xFFFFu;
  wl::hensel_steps<NPT>(r, qd, yy, ny, minv, Lo, lane);
  wl::negate_canonical<NPT>(qd, lane, Lo);
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
