// K5m: the magnitude product mod 2^(16 L_out) on Hopper (sm_90a).
//
// Replaces cofhe_tpu/ops/limb.py::_poly_mul8 / mag_mul (330-364; XLA, not
// Pallas: a grouped conv_general_dilated of 8-bit limbs on the TPU's
// matrix unit). Its plain torch version is cofhe_tpu_torch/ops/limb.py::
// mag_mul_plain (a float64 FFT of 8-bit limbs, ~67 torch kernels a call).
//
//   out = a * b mod 2^(16 Lo), canonical (Lo limbs)
//
// Only the low limbs of a and b below Lo count, and each is read as its
// low 16 bits (the plain version's 8-bit split reads the same bits), so
// the output equals the plain version's for any int32 input; canonical
// inputs in [0, 2^16) are the contract.
//
// One warp a row (four rows a block). The two operands are staged in
// shared memory; thread t owns output columns [t*NPT, t*NPT + NPT) and
// accumulates each column's products (16 x 16 -> 32 bits) in a 64-bit
// sum, the shorter operand driving the loop: a column of at most 288
// products stays below 2^41. The sums are split into 16-bit pieces that
// move one limb up (wl::split_u64) and the carries are resolved by two
// floor passes and a ballot scan (wl::carry_nonneg), which also drops what
// passes limb Lo - 1.
//
// What bounds it on this card: the function's bytes (two rows in, one
// out). Its limb products (min(La, Lo) x min(Lb, Lo) less the truncated
// triangle, four 8-bit products each) fit the int8 tensor cores in a
// tenth of that time; this first version does them on CUDA cores, one
// 32-bit product and one 64-bit add a pair, from shared memory, which is
// several times the bytes' time. At the main path's 128-256 rows one warp
// a row leaves most of the card idle, and the time is one warp's latency
// through its products. Tensor cores (u8 limbs through mma / wgmma) are
// the next step.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;    // rows (warps) a block
constexpr int kMax = 288;    // limbs a row at most (9 a thread)

template <int NPT>
__global__ void __launch_bounds__(32 * kWarps)
mag_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ out, int B, int La, int Lb, int sa, int sb,
               int Lo) {
  __shared__ uint32_t s_short[kWarps][kMax];
  __shared__ uint32_t s_long[kWarps][kMax];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= B) return;
  const int* pa = a + row * sa;
  const int* pb = b + row * sb;
  int na = min(La, Lo), nb = min(Lb, Lo);
  if (nb < na) {  // the shorter operand drives the loop
    const int* t = pa;
    pa = pb;
    pb = t;
    const int n = na;
    na = nb;
    nb = n;
  }
  uint32_t* x = s_short[warp];
  uint32_t* y = s_long[warp];
  for (int i = lane; i < na; i += 32) x[i] = (uint32_t)pa[i] & 0xFFFFu;
  for (int i = lane; i < nb; i += 32) y[i] = (uint32_t)pb[i] & 0xFFFFu;
  __syncwarp();

  unsigned long long s[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) s[j] = 0;
  for (int k = 0; k < na; k++) {
    const uint32_t xk = x[k];
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      const int m = lane * NPT + j - k;
      if (m >= 0 && m < nb) s[j] += (unsigned long long)(xk * y[m]);
    }
  }
  int r[NPT];
  wl::split_u64<NPT>(s, r, lane, Lo);
  wl::carry_nonneg<NPT>(r, lane, Lo);
  wl::store_row<NPT>(r, out + row * Lo, Lo, lane);
}

template <int NPT>
void launch(const int* a, const int* b, int* out, int B, int La, int Lb,
            int sa, int sb, int Lo, cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  mag_mul_kernel<NPT><<<blocks, 32 * kWarps, 0, s>>>(a, b, out, B, La, Lb,
                                                     sa, sb, Lo);
}

}  // namespace

// a: (B, La) and b: (B, Lb) int32 rows at row strides sa, sb (unit limb
// stride); out: (B, Lo) contiguous. 1 <= Lo <= 288.
extern "C" int mag_mul_launch(const int* a, const int* b, int* out, int B,
                              int La, int Lb, int sa, int sb, int Lo,
                              void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((Lo + 31) / 32) {
#define K5M_CASE(n)                                          \
  case n:                                                    \
    launch<n>(a, b, out, B, La, Lb, sa, sb, Lo, s);          \
    break;
    K5M_CASE(1) K5M_CASE(2) K5M_CASE(3) K5M_CASE(4) K5M_CASE(5) K5M_CASE(6)
    K5M_CASE(7) K5M_CASE(8) K5M_CASE(9)
#undef K5M_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
