// K1: batched Bezout-coefficient xgcd on Hopper (sm_90a).
//
// Replaces the TPU kernel cofhe_tpu/ops/pallas_group.py::xgcd_coeff_g (its
// body is cofhe_tpu/ops/xgcd2.py::xgcd_coeff_g). For odd f and m | f0 it
// returns d = gcd(f, g) and the canonical cg in [0, m) with
// cg * g0 ≡ d (mod m); with need_u also cu with cu*f0 + cg*g0 ≡ d (mod m).
// Its plain version is cofhe_tpu_torch/ops/xgcd2.py::xgcd_coeff_g; the two
// compute the same limbs group for group.
//
// What bounded the earlier design: it kept the JAX package's 13-divstep
// groups (|matrix entries| <= 2^13 keeps int32 products exact on a TPU)
// and its f32-estimated quotient per Bezout row. At the main path's 128-256
// lanes the time is one warp's loop, and each 13-step group was a chain of
// ~40-45 dependent warp shuffles: a shr_w and carry pass on f and g, then
// per Bezout row three carry passes, a value estimate (warp max and f32
// butterfly), a limb-0 broadcast, a shift and one more carry pass. At
// W=88 and 128 lanes it ran its lanes' maximum of 169 groups in 0.217 ms
// (H100 80GB HBM3, 700 W), ~1.28 us a group.
//
// What this design does about it:
// * 30 divsteps a group, simulated by every thread on the low 32 bits of f
//   and g (limb 0 + limb 1 << 16 mod 2^32, exact for redundant limbs), as
//   masks (no branches). The matrix entries stay within 2^30 (each row's
//   |u| + |v| at most doubles a step); the two columns follow one rule, so
//   even threads track (u, q) and odd threads (v, r): 20 int ops a step.
// * The matrix is applied with one 32x32->64 product (IMAD.WIDE) per
//   coefficient and limb, |u f_j + v g_j| < 2^46. The exact division by
//   2^30 is one limb offset and a 14-bit shift on the int64 sums (shr30:
//   two shuffles from the next thread, independent of each other), then
//   a 16-bit split and one balanced carry pass.
// * The Bezout rows take the safegcd update of libsecp256k1
//   (secp256k1_modinv32_update_de_30, doc/safegcd_implementation.md):
//   from the rows' signs alone (one warp max each), md = (u if Q < 0) +
//   (v if S < 0), less (m^-1 (u Q + v S) + md) mod 2^30 from the rows'
//   low words, so u Q + v S + md m is a multiple of 2^30. Range: for odd
//   m, rows in (-2m, m] and |u| + |v| <= 2^30, adding m to a negative row
//   bounds |u Q + v S + m (u[Q<0] + v[S<0])| by 2^30 m, the correction
//   subtracts k m with 0 <= k < 2^30, and the quotient by 2^30 is again in
//   (-2m, m]; the final into_range then needs at most two fixes. No value
//   estimate and no quotient subtraction.
// * Software-pipelined: the next group's low words come from the shifted
//   sums of f and g, and its simulation sits in one basic block with the
//   split, carry and Bezout update of this group, so the compiler can
//   interleave the scalar chain with the rows' shuffles.
// * One warp per lane, four lanes a block, limbs in blocked order; each
//   lane leaves its loop once its g is zero.
//
// Why the outputs are unchanged: the divstep sequence is the JAX
// package's (delta from 1, the same step rule; each decision is the parity
// of g after the steps before it, which the low bits fix). Each row holds
// its residue times 2^-n mod m after n divsteps however the steps are
// grouped, and steps past g = 0 leave f and the f-row residues (Q, P) as
// they are, so d and the residues of cg and cu are the 13-step schedule's;
// both are written canonical.
//
// What bounds it on this card: at 128-256 lanes each warp is alone on its
// scheduler, so a group costs its instruction count (the 30-step chain is
// ~600 of them, run by every thread) plus the shuffle latencies the
// interleaving does not hide; at 16384 lanes, integer issue. Its bytes are
// the 3 input and 2-3 output rows, read and written once. ptxas -v
// (sm_90a, CUDA 12.8), registers a thread without / with need_u: 32 / 35
// at one limb a thread (W <= 32), 53 / 64 at two, 72 / 92 at three
// (W = 72, 88), 80 / 93 at four, 96 / 112 at five (W = 144), 109 / 140 at
// six, up to 139 / 192 at nine; no spills at any width.

#include "warp_limbs.cuh"

namespace {

constexpr int kSteps = 30;
constexpr uint32_t kM30 = (1u << kSteps) - 1u;

// xgcd2.low32: the row's value mod 2^32, in every thread.
template <int NPT>
__device__ __forceinline__ uint32_t low32(const int (&x)[NPT]) {
  if constexpr (NPT >= 2) {
    uint32_t mine = (uint32_t)x[0] + ((uint32_t)x[1] << 16);
    return __shfl_sync(WL_FULL, mine, 0);
  } else {
    uint32_t a = __shfl_sync(WL_FULL, (uint32_t)x[0], 0);
    uint32_t b = __shfl_sync(WL_FULL, (uint32_t)x[0], 1);
    return a + (b << 16);
  }
}

// xgcd2.divstep_group: kSteps divsteps on the low words, computed by
// every thread; the same delta rule as the JAX package, as masks, with
// zeta = -delta. [f'; g'] = [[u, v], [q, r]] [f; g] / 2^kSteps. f and g
// wrap mod 2^32: step k reads bit 0 of g, which the low 32 - k bits fix.
// The two matrix columns follow one rule, so even threads track (u, q)
// and odd threads (v, r) as (a, b), and four shuffles gather them.
__device__ __forceinline__ void divstep_group(int& zeta, uint32_t f, uint32_t g,
                                              int lane, int& u, int& v, int& q,
                                              int& r) {
  int a = (lane & 1) ? 0 : 1, b = (lane & 1) ? 1 : 0;
#pragma unroll
  for (int i = 0; i < kSteps; i++) {
    const int c1 = zeta >> 31;           // all ones when delta > 0
    const int c2 = -(int)(g & 1u);       // all ones when g is odd
    const uint32_t x = (f ^ (uint32_t)c1) - (uint32_t)c1;  // -f if delta > 0
    const int y = (a ^ c1) - c1;
    g += x & (uint32_t)c2;               // g odd: g -/+ f
    b += y & c2;
    const int sw = c1 & c2;              // the swap: delta > 0 and g odd
    zeta = (zeta ^ sw) - 1 - sw;         // delta' = 1 - delta or 1 + delta
    f += g & (uint32_t)sw;               // swap: f <- the old g
    a += b & sw;
    g >>= 1;
    a *= 2;
  }
  u = __shfl_sync(WL_FULL, a, 0);
  q = __shfl_sync(WL_FULL, b, 0);
  v = __shfl_sync(WL_FULL, a, 1);
  r = __shfl_sync(WL_FULL, b, 1);
}

// xgcd2._shr30: s / 2^30 for int64 limb sums whose value is a multiple of
// 2^30. Limb 0 is then a multiple of 2^16 and folds into limb 1; limb i of
// the quotient is (s[i+1] >> 14) + ((s[i+2] & (2^14 - 1)) << 2). Limbs
// past the row are zero in every thread (every helper keeps them so), so
// only the shuffles from past lane 31 need masking.
template <int NPT>
__device__ __forceinline__ void shr30(long long (&s)[NPT], int lane) {
  constexpr int kD1 = NPT >= 2 ? 1 : 2;  // the lane that holds s[i + 2]
  long long n0 = __shfl_down_sync(WL_FULL, s[0], 1);
  long long n1 = __shfl_down_sync(WL_FULL, s[NPT >= 2 ? 1 : 0], kD1);
  if (lane == 31) n0 = 0;
  if (lane >= 32 - kD1) n1 = 0;
  long long y[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    long long a = j + 1 < NPT ? s[j + 1] : n0;
    const long long b = j + 2 < NPT ? s[j + 2] : (j + 2 - NPT == 0 ? n0 : n1);
    if (j == 0 && lane == 0) a += s[0] >> 16;
    y[j] = (a >> 14) + ((b & 0x3FFF) << 2);
  }
#pragma unroll
  for (int j = 0; j < NPT; j++) s[j] = y[j];
}

// xgcd2.low32 of shifted int64 sums (any limb split of one value).
template <int NPT>
__device__ __forceinline__ uint32_t low32(const long long (&y)[NPT]) {
  if constexpr (NPT >= 2) {
    return __shfl_sync(WL_FULL, (uint32_t)y[0] + ((uint32_t)y[1] << 16), 0);
  } else {
    const uint32_t l0 = __shfl_sync(WL_FULL, (uint32_t)y[0], 0);
    return l0 + (__shfl_sync(WL_FULL, (uint32_t)y[0], 1) << 16);
  }
}

// The rest of xgcd2._normalize after the shift: each quotient limb's low
// 16 bits plus the rest of the limb below, then one carry pass. The top
// limb keeps its whole value, which is 0 unless the row has one limb.
template <int NPT>
__device__ __forceinline__ void split_carry(const long long (&y)[NPT], int (&out)[NPT],
                                            int lane, int W) {
  int hi[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    out[j] = (int)(y[j] & 0xFFFF);
    hi[j] = (int)(y[j] >> 16);
  }
  if (W == 1) out[0] = (int)y[0];
  int hin = __shfl_up_sync(WL_FULL, hi[NPT - 1], 1);
  if (lane == 0) hin = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) out[j] += j == 0 ? hin : hi[j - 1];
  wl::carry_pass<NPT>(out, lane, W);
}

// xgcd2.row_sign: value < 0, from the top nonzero limb (balanced limbs).
template <int NPT>
__device__ __forceinline__ bool row_neg(const int (&x)[NPT], int lane) {
  int key = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++)
    if (x[j] != 0) key = ((lane * NPT + j + 1) << 1) | (x[j] < 0 ? 1 : 0);
  return __reduce_max_sync(WL_FULL, key) & 1;
}

// xgcd2.bezout_update: the safegcd update of the row pair (X, Y).
template <int NPT>
__device__ __forceinline__ void bezout_update(int (&X)[NPT], int (&Y)[NPT],
                                              const int (&m)[NPT], int u, int v,
                                              int q, int r, uint32_t minv,
                                              int lane, int W) {
  const bool xn = row_neg<NPT>(X, lane), yn = row_neg<NPT>(Y, lane);
  const uint32_t xlo = low32<NPT>(X), ylo = low32<NPT>(Y);
  int md = (xn ? u : 0) + (yn ? v : 0);
  int me = (xn ? q : 0) + (yn ? r : 0);
  const uint32_t cd = (uint32_t)u * xlo + (uint32_t)v * ylo;
  const uint32_t ce = (uint32_t)q * xlo + (uint32_t)r * ylo;
  md -= (int)((minv * cd + (uint32_t)md) & kM30);
  me -= (int)((minv * ce + (uint32_t)me) & kM30);
  long long s1[NPT], s2[NPT];
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    s1[j] = (long long)u * X[j] + (long long)v * Y[j] + (long long)md * m[j];
    s2[j] = (long long)q * X[j] + (long long)r * Y[j] + (long long)me * m[j];
  }
  shr30<NPT>(s1, lane);
  shr30<NPT>(s2, lane);
  split_carry<NPT>(s1, X, lane, W);
  split_carry<NPT>(s2, Y, lane, W);
}

// xgcd2.xgcd_coeff_g.into_range (== rl.exact_mod_tail after the sign
// normalization): canonical x mod m in [0, m).
template <int NPT>
__device__ __forceinline__ void into_range(int (&x)[NPT], const int (&m)[NPT],
                                           int sf, int lane, int W) {
  int s = wl::canonicalize<NPT>(x, lane, W);
  if (sf < 0) s = -s;
  // exact tail: canonicalize, then fold the sign / subtract m twice
#pragma unroll
  for (int j = 0; j < NPT; j++) x[j] = s * x[j];
  s = wl::canonicalize<NPT>(x, lane, W);
  for (int rep = 0; rep < 2; rep++) {
    bool ge = s > 0 && wl::mag_cmp<NPT>(x, m, lane) >= 0;
    bool neg = s < 0;
#pragma unroll
    for (int j = 0; j < NPT; j++)
      x[j] = s * x[j] + (neg ? m[j] : 0) - (ge ? m[j] : 0);
    s = wl::canonicalize<NPT>(x, lane, W);
  }
}

template <int NPT, bool NEED_U>
__global__ void __launch_bounds__(128)
    xgcd_coeff_g_kernel(const int* __restrict__ f_in,
                        const int* __restrict__ g_in,
                        const int* __restrict__ m_in, int* __restrict__ d_out,
                        int* __restrict__ cg_out, int* __restrict__ cu_out,
                        int* __restrict__ iters_out, int B, int W,
                        int groups) {
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warp leaves together
  const size_t off = (size_t)row * (size_t)W;

  int f[NPT], g[NPT], m[NPT], Q[NPT], S[NPT], P[NPT], R[NPT];
  wl::load_row<NPT>(f, f_in + off, W, lane);
  wl::load_row<NPT>(g, g_in + off, W, lane);
  wl::load_row<NPT>(m, m_in + off, W, lane);

  // xgcd2.modinv30: m^-1 mod 2^30, modinv16 and one more Newton step
  const uint32_t mlo = low32<NPT>(m);
  uint32_t minv = (uint32_t)wl::modinv16((int)(mlo & 0xFFFFu));
  minv = (minv * (2u - mlo * minv)) & kM30;

  wl::carry_pass<NPT>(f, lane, W);
  wl::carry_pass<NPT>(g, lane, W);
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    int one = (lane == 0 && j == 0) ? 1 : 0;
    Q[j] = 0;
    S[j] = one;
    P[j] = one;
    R[j] = 0;
  }

  // Software-pipelined: a group applies the matrix simulated before it,
  // then simulates the next group's matrix from the new low words while
  // it updates the Bezout rows (independent work the compiler can
  // interleave). Groups past g = 0 never run: each lane stops on its own.
  int zeta = -1;  // -delta
  bool live = false;
#pragma unroll
  for (int j = 0; j < NPT; j++) live |= g[j] != 0;
  live = __any_sync(WL_FULL, live);
  int u = 0, v = 0, q = 0, r = 0;
  if (live) divstep_group(zeta, low32<NPT>(f), low32<NPT>(g), lane, u, v, q, r);
  int grp = 0;
  for (; grp < groups && live; grp++) {
    long long s1[NPT], s2[NPT];
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      s1[j] = (long long)u * f[j] + (long long)v * g[j];
      s2[j] = (long long)q * f[j] + (long long)r * g[j];
    }
    shr30<NPT>(s1, lane);
    shr30<NPT>(s2, lane);
    // the next group's low words come from the shifted sums, so its
    // simulation need not wait for the split and carry pass
    int u2, v2, q2, r2;
    divstep_group(zeta, low32<NPT>(s1), low32<NPT>(s2), lane, u2, v2, q2, r2);
    split_carry<NPT>(s1, f, lane, W);
    split_carry<NPT>(s2, g, lane, W);
    bezout_update<NPT>(Q, S, m, u, v, q, r, minv, lane, W);
    if (NEED_U) bezout_update<NPT>(P, R, m, u, v, q, r, minv, lane, W);
    u = u2;
    v = v2;
    q = q2;
    r = r2;
    bool gnz = false;
#pragma unroll
    for (int j = 0; j < NPT; j++) gnz |= g[j] != 0;
    live = __any_sync(WL_FULL, gnz);
  }

  if (iters_out != nullptr && lane == 0) iters_out[row] = grp;
  int sf = wl::canonicalize<NPT>(f, lane, W);
  wl::store_row<NPT>(f, d_out + off, W, lane);
  into_range<NPT>(Q, m, sf, lane, W);
  wl::store_row<NPT>(Q, cg_out + off, W, lane);
  if (NEED_U) {
    into_range<NPT>(P, m, sf, lane, W);
    wl::store_row<NPT>(P, cu_out + off, W, lane);
  }
}

template <int NPT>
void launch(const int* f, const int* g, const int* m, int* d, int* cg,
            int* cu, int* iters, int B, int W, int groups, int need_u,
            cudaStream_t stream) {
  const int threads = 128;  // 4 lanes (warps) per block
  const int blocks = (B + 3) / 4;
  if (need_u)
    xgcd_coeff_g_kernel<NPT, true>
        <<<blocks, threads, 0, stream>>>(f, g, m, d, cg, cu, iters, B, W, groups);
  else
    xgcd_coeff_g_kernel<NPT, false>
        <<<blocks, threads, 0, stream>>>(f, g, m, d, cg, cu, iters, B, W, groups);
}

}  // namespace

// Plain C entry point (bound with ctypes). Rows are contiguous int32 (B, W)
// arrays on the device; W <= 288; m canonical and odd. `groups` caps the
// loop in groups of 30 divsteps (xgcd2.groups_for_bits). cu may be null
// without need_u; iters, when not null, receives each row's number of
// groups. Returns cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for an unsupported W.
extern "C" int xgcd_coeff_g_launch(const int* f, const int* g, const int* m,
                                   int* d, int* cg, int* cu, int* iters,
                                   int B, int W, int groups, int need_u,
                                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((W + 31) / 32) {
    case 1: launch<1>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 2: launch<2>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 3: launch<3>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 4: launch<4>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 5: launch<5>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 6: launch<6>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 7: launch<7>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 8: launch<8>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    case 9: launch<9>(f, g, m, d, cg, cu, iters, B, W, groups, need_u, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
