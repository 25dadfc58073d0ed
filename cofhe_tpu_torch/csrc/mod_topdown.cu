// K2: batched x mod m on Hopper (sm_90a).
//
// Replaces the TPU kernel cofhe_tpu/ops/pallas_group.py::mod_topdown (its
// body is cofhe_tpu/ops/rl.py::mod_topdown): x mod m into [0, m) for signed
// redundant x (B, Lx) and canonical m (B, Lm), Lm < Lx. Same algorithm as
// the plain version cofhe_tpu_torch/ops/rl.py::mod_topdown: a copy of m
// shifted to 8-24 bits below x, one ~24-bit f32-estimated digit per
// iteration applied 12+12 against (m<<wleft, m<<12<<wleft), a walk of the
// shift down by at most two limbs per iteration, then an exact tail of at
// most two fixes.
//
// What bounds it on this card: integer operations — per iteration and lane
// ~10 passes over Lx limbs (two products, two carry passes, one value
// estimate, two masked shifts) for ~(bits(x) - bits(m)) / 24 iterations;
// the bytes (x and m read once, the result written once) are small beside
// them. The design keeps the per-lane state (x, m<<wleft, m<<12<<wleft, m)
// in registers: one warp per lane with its limbs spread in blocked order
// (Lx=264 -> 9 limbs a thread), the one dynamic limb shift (the initial
// alignment) through a per-warp row of shared memory, carries as a
// neighbour shuffle per pass, the top-limb search as a warp max and the f32
// sum as a butterfly; each lane leaves its loop as soon as its x is below
// m. Later work: staging rows with cp.async/TMA and fusing K1 -> K2 -> the
// reduction.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;      // lanes (warps) per block
constexpr int kMaxLimbs = 288; // 9 limbs x 32 threads

template <int NPT>
__global__ void __launch_bounds__(kWarps * 32)
    mod_topdown_kernel(const int* __restrict__ x_in,
                       const int* __restrict__ m_in, int* __restrict__ out,
                       int* __restrict__ iters_out, int B, int L, int Lm,
                       int max_iters) {
  __shared__ int rowbuf[kWarps][kMaxLimbs];
  const int warp_in_block = threadIdx.x >> 5;
  const int row = (int)(blockIdx.x * kWarps + warp_in_block);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warp leaves together
  int* sh = rowbuf[warp_in_block];

  int x[NPT], m[NPT], msh[NPT], m12sh[NPT];
  wl::load_row<NPT>(x, x_in + (size_t)row * L, L, lane);
  wl::load_row<NPT>(m, m_in + (size_t)row * Lm, Lm, lane);

  float mant_m;
  int top_m;
  wl::value_est<NPT>(m, lane, mant_m, top_m);
  const float bits_m = wl::bits_est(mant_m, top_m);

  wl::carry_pass<NPT>(x, lane, L);
  wl::carry_pass<NPT>(x, lane, L);
  float mant_x;
  int top_x;
  wl::value_est<NPT>(x, lane, mant_x, top_x);
  float bx = wl::bits_est(mant_x, top_x);
  bool w = bx > bits_m - 0.75f;

  const int wmax = L - 2 - top_m;
  int wleft = (int)((bx - bits_m - 8.0f) / 16.0f);
  wleft = wleft < 0 ? 0 : (wleft > wmax ? wmax : wleft);

  // msh = m << (16 wleft) and m12sh = (m << 12) << (16 wleft), limbs that
  // would pass the top dropped (rl.shl_limbs_take)
  int m12[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) m12[j] = m[j] << 12;  // canonical m < 2^16
  wl::canonicalize<NPT>(m12, lane, L);
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
#pragma unroll
    for (int j = 0; j < NPT; j++) sh[lane * NPT + j] = pass == 0 ? m[j] : m12[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      int i = lane * NPT + j;
      int src = i - wleft;
      int v = (i < L && src >= 0) ? sh[src] : 0;
      if (pass == 0) msh[j] = v; else m12sh[j] = v;
    }
    __syncwarp();
  }

  int it = 0;
  for (; it < max_iters && w; it++) {
    const int top_s = top_m + wleft;
    float ratio = mant_x / fmaxf(mant_m, 1e-30f);
    int e = 16 * (top_x - top_s);
    e = e < -126 ? -126 : (e > 60 ? 60 : e);
    float qf = rintf(ratio * wl::pow2f(e));
    qf = fminf(fmaxf(qf, -16777215.0f), 16777215.0f);
    int qd = (int)qf;
    int s = wl::sgn(qd);
    int a = qd < 0 ? -qd : qd;
    int lo = (a & 0xFFF) * s;
    int hi = (a >> 12) * s;
#pragma unroll
    for (int j = 0; j < NPT; j++) x[j] = x[j] - lo * msh[j] - hi * m12sh[j];
    wl::carry_pass<NPT>(x, lane, L);
    wl::carry_pass<NPT>(x, lane, L);
    wl::value_est<NPT>(x, lane, mant_x, top_x);
    bx = wl::bits_est(mant_x, top_x);
    w = bx > bits_m - 0.75f;
    // hold bits(msh) ~8-24 below bits(x): walk down <= 2 limbs
#pragma unroll
    for (int rep = 0; rep < 2; rep++) {
      if (wleft > 0 && bits_m + 16.0f * (float)wleft > bx - 8.0f) {
        wl::shift_down1<NPT>(msh, lane, L);
        wl::shift_down1<NPT>(m12sh, lane, L);
        wleft -= 1;
      }
    }
  }

  if (iters_out != nullptr && lane == 0) iters_out[row] = it;

  // exact tail: |x| <~ 2m; canonicalize, then fold the sign / subtract m
  int sg = wl::canonicalize<NPT>(x, lane, L);
  for (int rep = 0; rep < 2; rep++) {
    bool ge = sg > 0 && wl::mag_cmp<NPT>(x, m, lane) >= 0;
    bool neg = sg < 0;
#pragma unroll
    for (int j = 0; j < NPT; j++)
      x[j] = sg * x[j] + (neg ? m[j] : 0) - (ge ? m[j] : 0);
    sg = wl::canonicalize<NPT>(x, lane, L);
  }
  wl::store_row<NPT>(x, out + (size_t)row * L, L, lane);
}

template <int NPT>
void launch(const int* x, const int* m, int* out, int* iters, int B, int L,
            int Lm, int max_iters, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  mod_topdown_kernel<NPT>
      <<<blocks, kWarps * 32, 0, stream>>>(x, m, out, iters, B, L, Lm, max_iters);
}

}  // namespace

// Plain C entry point (bound with ctypes). x: contiguous int32 (B, L) on the
// device, m: contiguous int32 (B, Lm) with Lm < L <= 288; out: (B, L);
// iters, when not null, receives each row's number of loop iterations.
// Returns cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for unsupported widths.
extern "C" int mod_topdown_launch(const int* x, const int* m, int* out,
                                  int* iters, int B, int L, int Lm,
                                  int max_iters, void* stream) {
  if (B <= 0) return 0;
  if (Lm >= L || L > kMaxLimbs) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 31) / 32) {
    case 1: launch<1>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 2: launch<2>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 3: launch<3>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 4: launch<4>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 5: launch<5>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 6: launch<6>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 7: launch<7>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 8: launch<8>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    case 9: launch<9>(x, m, out, iters, B, L, Lm, max_iters, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
