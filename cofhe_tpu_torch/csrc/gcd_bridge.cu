// K6c: compose2's bridge from the first gcd to the second on Hopper
// (sm_90a).
//
// Replaces the selects of cofhe_tpu/ops/forms2.py::CG.compose2_unreduced
// between its two gcds (536-537, 544-547, 549 and 570-572; XLA, not
// Pallas). Its plain version is
// cofhe_tpu_torch/ops/forms2.py::gcd_bridge_plain, about 25 torch ops:
//
//   d1, beta = (d1_n, beta_n) zero-extended to L where fx, else
//              (d1_w, beta_w)              (the first gcd's two passes)
//   fits8    = bitlen(d1) <= 120                      (limb.mag_bitlen)
//   rare     = !fits8 and neither operand is the identity
//   d1_8     = d1 cut to 8 limbs where fits8, else 1; also zero-extended
//              to Lh (K4's d)
//   d1h      = d1 cut to Lh limbs on the rare lanes, else 1
//
// Without the narrow pass (Lxn = 0: the narrow width is not below L) d1
// and beta are the wide pass's rows and are not written. On canonical d1
// (K1's output), bitlen <= 120 is no nonzero limb from 8 on and limb 7
// below 2^8: one ballot.
//
// One warp a batch row, four rows a block; d1's limbs blocked over the
// threads (NPT = ceil(L / 32)), read from the one pass that fx picks, and
// beta copied from the same pass.
//
// What bounds it on this card: its bytes at 16384 rows (d1 and beta read
// from one pass and written at L, three short rows written); at the main
// path's 128-256 rows one warp's latency through a load, a ballot and the
// stores, where the torch ops it replaces took ~25 launches.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;  // batch rows (warps) a block

struct Params {
  const int* d1_w;  // (B, L): the full-width pass
  const int* beta_w;
  const unsigned char* id1;  // (B,)
  const unsigned char* id2;
  const int* d1_n;  // (B, Lxn): the narrow pass, null without one
  const int* beta_n;
  const unsigned char* fx;  // (B,)
  int* d1;                  // (B, L), null without the narrow pass
  int* beta;
  unsigned char* fits8;  // (B,)
  unsigned char* rare;
  int* d1_8;   // (B, 8)
  int* d1_8h;  // (B, Lh)
  int* d1h;    // (B, Lh)
  int B, L, Lxn, Lh;
};

template <int NPT>
__global__ void __launch_bounds__(32 * kWarps) gcd_bridge_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;  // B * L < 2^31 (the launcher)
  if (b >= p.B) return;
  const int L = p.L, Lxn = p.Lxn, Lh = p.Lh, off = b * L;
  const bool nar = Lxn > 0 && p.fx[b];
  int x[NPT];
  if (nar)
    wl::load_row<NPT>(x, p.d1_n + b * Lxn, Lxn, lane);
  else
    wl::load_row<NPT>(x, p.d1_w + off, L, lane);
  if (Lxn > 0) {
    wl::store_row<NPT>(x, p.d1 + off, L, lane);
    int y[NPT];
    if (nar)
      wl::load_row<NPT>(y, p.beta_n + b * Lxn, Lxn, lane);
    else
      wl::load_row<NPT>(y, p.beta_w + off, L, lane);
    wl::store_row<NPT>(y, p.beta + off, L, lane);
  }
  bool big = false;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j;
    big |= (i >= 8 && x[j] != 0) || (i == 7 && x[j] >= 256);
  }
  const bool fits8 = !__any_sync(WL_FULL, big);
  const bool rare = !fits8 && !(p.id1[b] || p.id2[b]);
  if (lane == 0) {
    p.fits8[b] = fits8;
    p.rare[b] = rare;
  }
  const int hoff = b * Lh;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j, one = i == 0;
    const int v8 = fits8 ? (i < 8 ? x[j] : 0) : one;
    if (i < 8) p.d1_8[b * 8 + i] = v8;
    if (i < Lh) {
      p.d1_8h[hoff + i] = v8;
      p.d1h[hoff + i] = rare ? x[j] : one;
    }
  }
}

template <int NPT>
void launch(const Params& p, cudaStream_t s) {
  const int blocks = (p.B + kWarps - 1) / kWarps;
  gcd_bridge_kernel<NPT><<<blocks, 32 * kWarps, 0, s>>>(p);
}

}  // namespace

// Plain C entry point (bound with ctypes). in: 7 device pointers, d1_w,
// beta_w ((B, L) int32), id1, id2 ((B,) bool) and, with Lxn > 0, d1_n,
// beta_n ((B, Lxn) int32) and fx ((B,) bool); out: 7 device pointers, d1,
// beta ((B, L) int32, written only with Lxn > 0), fits8, rare ((B,) bool),
// d1_8 ((B, 8) int32), d1_8 at Lh and d1h ((B, Lh) int32). Rows
// contiguous; 8 <= Lh <= L <= 288, 0 <= Lxn <= L, B L < 2^31. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for sizes
// outside that.
extern "C" int gcd_bridge_launch(void* const* in, void* const* out, int B, int L,
                                 int Lxn, int Lh, void* stream) {
  if (B <= 0) return 0;
  if (L < 8 || L > 288 || Lh < 8 || Lh > L || Lxn < 0 || Lxn > L ||
      (long long)B * L >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.d1_w = (const int*)in[0];
  p.beta_w = (const int*)in[1];
  p.id1 = (const unsigned char*)in[2];
  p.id2 = (const unsigned char*)in[3];
  if (Lxn > 0) {
    p.d1_n = (const int*)in[4];
    p.beta_n = (const int*)in[5];
    p.fx = (const unsigned char*)in[6];
    p.d1 = (int*)out[0];
    p.beta = (int*)out[1];
  }
  p.fits8 = (unsigned char*)out[2];
  p.rare = (unsigned char*)out[3];
  p.d1_8 = (int*)out[4];
  p.d1_8h = (int*)out[5];
  p.d1h = (int*)out[6];
  p.B = B;
  p.L = L;
  p.Lxn = Lxn;
  p.Lh = Lh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 31) / 32) {
#define K6C_CASE(n)   \
  case n:             \
    launch<n>(p, s);  \
    break;
    K6C_CASE(1) K6C_CASE(2) K6C_CASE(3) K6C_CASE(4) K6C_CASE(5) K6C_CASE(6)
    K6C_CASE(7) K6C_CASE(8) K6C_CASE(9)
#undef K6C_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
