// K4: Montgomery reduction into [0, d) on Hopper (sm_90a).
//
// Replaces cofhe_tpu/ops/rl.py::redc_pow16 (486-523; XLA, not Pallas: a
// limb-by-limb Montgomery loop) together with the port's final
// subtraction, forms2.py::CG._redc_mod. Its plain torch version is
// cofhe_tpu_torch/ops/rl.py::redc_mod (rl.redc_pow16's one-shot step with
// a 2-adic inverse, canonicalization, one conditional subtraction of d).
//
//   R = (x + Q d) / 2^(16 steps),  Q = -x d^-1 mod 2^(16 steps) on active
//   rows and 0 on the others;  out = R - d if R >= d else R,  Lx limbs
//
// for odd d and canonical x. Q is built limb by limb as in the JAX loop,
// t_k = (limb k) * (-d^-1 mod 2^16) mod 2^16 with the kernel's own 16-bit
// inverse (wl::modinv16), so it is the plain version's Q and R is the
// plain version's R. For x < 2^(16 steps) (the compose's calls: Lx <=
// steps), R <= d and out = x 2^(-16 steps) mod d. A row outside `active`
// gets floor(x / 2^(16 steps)) reduced once by d, as the plain version
// writes there. R is cut to Lx limbs before the comparison, as the plain
// version cuts it.
//
// One warp a row (four rows a block). Thread t holds positions
// [t*NPT, t*NPT + NPT) of x + Q d as 64-bit sums over N = max(Lx, steps +
// Ld) + 1 positions, never shifted, and wl::hensel_steps (shared with K5d)
// runs the digits in blocks of NPT: step o belongs to thread o, which folds
// the carry from below into its positions and takes their NPT digits t_k
// one after another in registers, hands them to the warp by ceil(NPT / 2)
// + 1 shuffles, and every thread above it within reach of d adds t_k *
// d[i - k] to its positions i, with d in shared memory. d's significant
// limbs (a warp max over its nonzero limbs) bound the products. A row
// outside `active` takes no digit step: its positions are x's limbs, below
// 2^16, so they carry nothing and the positions from `steps` on are
// floor(x / 2^(16 steps)) as they stand, for any Lx. Then positions below
// steps - 1 (spent sums, their carries moved up) are cleared, and the
// positions from `steps` on are R: split, carried (wl::split_u64,
// wl::carry_nonneg), compared with d and, when R >= d, d is taken off and
// the row canonicalized.
//
// What bounds it on this card: on active rows the chain, ceil(steps /
// NPT) hand-overs (15 at compose2's width 72, where N = 145 and NPT = 5;
// 24 at width 8, N = 81, NPT = 3) and `steps` digits of a few dependent
// integer operations on one thread each, so at the main path's 128-256
// rows the time is one warp's latency through that chain; with a one-limb
// d no thread but the owner multiplies. An inactive row costs its loads,
// carries and comparison. The function's steps * Ld limb products would
// fit the int8 tensor cores in a small fraction of its bytes (two rows and
// a flag in, one row out); its carries, comparison and subtraction on CUDA
// cores set its bound.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;    // rows (warps) a block
constexpr int kMax = 288;    // limbs a row at most (9 a thread)

template <int NPT>
__global__ void __launch_bounds__(32 * kWarps)
redc_mod_kernel(const int* __restrict__ x, const int* __restrict__ d,
                const unsigned char* __restrict__ active, int* __restrict__ out,
                int B, int Lx, int Ld, int sx, int sd, int steps) {
  __shared__ uint32_t s_d[kWarps][kMax];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= B) return;
  const int N = max(Lx, steps + Ld) + 1;
  const int* px = x + row * sx;
  const int* pd = d + row * sd;
  uint32_t* dd = s_d[warp];
  const int nd = wl::load_divisor(dd, pd, Ld, lane);
  unsigned long long r[NPT];
  int unused[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    r[j] = i < Lx ? ((uint32_t)px[i] & 0xFFFFu) : 0u;
  }
  if (active == nullptr || active[row] != 0) {  // warp-uniform
    const uint32_t minv =
        (0x10000u - (uint32_t)wl::modinv16((int)dd[0])) & 0xFFFFu;
    wl::hensel_steps<NPT>(r, unused, dd, nd, minv, steps, lane);
  }
#pragma unroll
  for (int j = 0; j < NPT; j++)
    if (lane * NPT + j < steps - 1) r[j] = 0;

  // R at positions [steps, N): canonical, cut to Lx limbs, compared with d
  int v[NPT];
  wl::split_u64<NPT>(r, v, lane, N);
  wl::carry_nonneg<NPT>(v, lane, N);
  int res = 0;
  int dv[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int m = lane * NPT + j - steps;
    if (m >= Lx) v[j] = 0;
    dv[j] = (m >= 0 && m < Ld) ? (int)dd[m] : 0;
    if (v[j] != dv[j]) res = v[j] > dv[j] ? 1 : -1;  // highest slot wins
  }
  const uint32_t has = __ballot_sync(WL_FULL, res != 0);
  const int cmp = has ? __shfl_sync(WL_FULL, res, 31 - __clz(has)) : 0;
  if (cmp >= 0) {  // warp-uniform
#pragma unroll
    for (int j = 0; j < NPT; j++) v[j] -= dv[j];
    wl::canonicalize<NPT>(v, lane, N);
  }
  int* po = out + row * Lx;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int m = lane * NPT + j - steps;
    if (m >= 0 && m < Lx) po[m] = v[j];
  }
  for (int m = 32 * NPT - steps + lane; m < Lx; m += 32) po[m] = 0;
}

template <int NPT>
void launch(const int* x, const int* d, const unsigned char* active, int* out,
            int B, int Lx, int Ld, int sx, int sd, int steps, cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  redc_mod_kernel<NPT><<<blocks, 32 * kWarps, 0, s>>>(x, d, active, out, B, Lx,
                                                      Ld, sx, sd, steps);
}

}  // namespace

// x: (B, Lx) canonical and d: (B, Ld) odd int32 rows at row strides sx, sd
// (unit limb stride); active: (B,) bytes or null (every row); out: (B, Lx)
// contiguous. 1 <= Ld <= Lx, max(Lx, steps + Ld) + 1 <= 288.
extern "C" int redc_mod_launch(const int* x, const int* d,
                               const unsigned char* active, int* out, int B,
                               int Lx, int Ld, int sx, int sd, int steps,
                               void* stream) {
  if (B <= 0) return 0;
  const int N = (Lx > steps + Ld ? Lx : steps + Ld) + 1;
  if (Ld < 1 || Ld > Lx || steps < 0 || N > kMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((N + 31) / 32) {
#define K4_CASE(n)                                              \
  case n:                                                       \
    launch<n>(x, d, active, out, B, Lx, Ld, sx, sd, steps, s);  \
    break;
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4) K4_CASE(5) K4_CASE(6)
    K4_CASE(7) K4_CASE(8) K4_CASE(9)
#undef K4_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
