// K6b: compose2's prologue on Hopper (sm_90a).
//
// Replaces the start of cofhe_tpu/ops/forms2.py::CG.compose2 (478-507;
// XLA, not Pallas), up to s and dd. Its plain version is
// cofhe_tpu_torch/ops/forms2.py::compose2_prologue_plain, about 75 torch
// ops:
//
//   id1, id2   = a1 == 1, a2 == 1                       (CG._is_one)
//   F1b, F2b   = (h, h^2) where id1 | id2, else (F1, F2)
//   swap       = a(F1b) > a(F2b)                       (limb.mag_cmp)
//   F1n, F2n   = (F2b, F1b) where swap, else (F1b, F2b)
//   F2n        = (c, -b, a) where a(F2n) is even       (forms.rotate_to_odd)
//   s          = (b1 + b2) / 2,  dd = b2 - b1   on b's cut to Lh limbs
//                (limb.sm_add, mag_shr_bits by 1, limb.sm_sub)
//
// and writes a1, b1s, b1m, c1, a2, b2s, b2m, c2 (the forms' rows at width
// L), ss, sm (s's sign and |s| >> 1 at Lh), dds, ddm and the identity
// masks id1, id2 (bool), all as the torch code makes them. With a narrow
// width Lxn < L it also writes the first gcd's operands
// (cofhe_tpu/ops/forms2.py:522-533; forms2.first_gcd_operands):
//
//   fx         = bitlen(a2) <= nb and bitlen(a1) <= nb,  nb = 16 Lxn - 32
//   a2_n, a1_n = (a2, a1) cut to Lxn limbs where fx, else (1, 0)
//   a2_w, a1_w = (1, 0) at L limbs where fx, else (a2, a1)
//
// where, on canonical rows, bitlen <= 16 (Lxn - 2) is no nonzero limb
// from Lxn - 2 on: one ballot over both a rows, which the kernel holds in
// registers as it writes them. The cut of b1,
// b2 to Lh limbs is lb.resize's, on the guarantee that the b of a reduced
// form fits Lh; the kernel checks no more than the torch code does.
//
// One warp a batch row, four rows a block. The two a rows are read into
// registers (limbs blocked over the threads, NPT = ceil(L / 32)); the
// identity tests are a warp sum and a shuffle, the swap one
// wl::mag_cmp (two ballots), and each output form row is copied from the
// row the selects pick, read once. s and dd are K6a's two-row canonicalization
// (wl::canonicalize_rows with both rows side by side) and wl::shr_bits.
//
// What bounds it on this card: its bytes at 16384 rows (the six form rows
// and, with Lxn, the first gcd's four operand rows written at width L or
// Lxn, the picked rows read once); at the main path's 128-256 rows one
// warp's latency through the compare and the canonicalization, where the
// torch ops took ~75 launches, and the first gcd's operands ~20 more.

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;  // batch rows (warps) a block

struct Form {
  const int* a;
  const int* bs;
  const int* b;
  const int* c;
};

struct Params {
  Form f1, f2, h, h2;  // f1, f2: (B, L) rows and (B,) signs; h, h2: one row
  int* a1;
  int* b1s;
  int* b1;
  int* c1;
  int* a2;
  int* b2s;
  int* b2;
  int* c2;
  int* ss;
  int* sm;
  int* dds;
  int* ddm;
  unsigned char* id1;
  unsigned char* id2;
  unsigned char* fx;  // the first gcd's operands, written where Lxn > 0
  int* a2n;
  int* a1n;
  int* a2w;
  int* a1w;
  int B, L, Lh, Lxn;
};

// CG._is_one of a canonical row: limb 0 is 1 and the limbs sum to 1
template <int NPT>
__device__ __forceinline__ bool is_one(const int (&x)[NPT]) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < NPT; j++) s += x[j];
  s = __reduce_add_sync(WL_FULL, s);
  return __shfl_sync(WL_FULL, x[0], 0) == 1 && s == 1;
}

// dst <- src, L limbs, each thread its NPT limbs
template <int NPT>
__device__ __forceinline__ void copy_row(int* dst, const int* src, int L,
                                         int lane) {
  int x[NPT];
  wl::load_row<NPT>(x, src, L, lane);
  wl::store_row<NPT>(x, dst, L, lane);
}

__device__ __forceinline__ const int* pick(const int* f1, const int* f2,
                                           const int* h, const int* h2,
                                           bool right, bool sub) {
  return sub ? (right ? h2 : h) : (right ? f2 : f1);
}

// A pointer into one of the forms (field: 0 a, 1 b, 2 c, 3 b's sign): the
// left form (F1, or h where `sub`) or the right one (F2, or h^2), `off`
// ints into F1's or F2's array (h's single row has no offset). Selected
// by value, field by field: no address of the parameters is taken.
__device__ __forceinline__ const int* form_row(const Params& p, bool right,
                                               bool sub, int field, int off) {
  const int* r;
  switch (field) {
    case 0: r = pick(p.f1.a, p.f2.a, p.h.a, p.h2.a, right, sub); break;
    case 1: r = pick(p.f1.b, p.f2.b, p.h.b, p.h2.b, right, sub); break;
    case 2: r = pick(p.f1.c, p.f2.c, p.h.c, p.h2.c, right, sub); break;
    default: r = pick(p.f1.bs, p.f2.bs, p.h.bs, p.h2.bs, right, sub); break;
  }
  return sub ? r : r + off;
}

// forms2.first_gcd_operands of the canonical rows a1 (x1) and a2 (x2) of
// batch row b: fx from one ballot, then the narrow and wide rows
template <int NPT>
__device__ __forceinline__ void first_gcd_operands(const Params& p,
                                                   const int (&x1)[NPT],
                                                   const int (&x2)[NPT], int b,
                                                   int lane) {
  const int L = p.L, Ln = p.Lxn, off = b * L, noff = b * Ln;
  bool wide = false;
#pragma unroll
  for (int j = 0; j < NPT; j++)
    wide |= lane * NPT + j >= Ln - 2 && (x1[j] | x2[j]) != 0;
  const bool fx = !__any_sync(WL_FULL, wide);
  if (lane == 0) p.fx[b] = fx;
#pragma unroll
  for (int j = 0; j < NPT; j++) {
    const int i = lane * NPT + j, one = i == 0;
    if (i < Ln) {
      p.a2n[noff + i] = fx ? x2[j] : one;
      p.a1n[noff + i] = fx ? x1[j] : 0;
    }
    if (i < L) {
      p.a2w[off + i] = fx ? one : x2[j];
      p.a1w[off + i] = fx ? 0 : x1[j];
    }
  }
}

template <int NPT>
__global__ void __launch_bounds__(32 * kWarps)
compose_prologue_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;  // B * L < 2^31 (the launcher)
  if (b >= p.B) return;
  const int L = p.L, Lh = p.Lh, off = b * L;
  // the masks, the swap and the rotation, kept as flags
  bool sub, swap, even;
  {
    int x1[NPT], x2[NPT];
    wl::load_row<NPT>(x1, p.f1.a + off, L, lane);
    wl::load_row<NPT>(x2, p.f2.a + off, L, lane);
    const bool id1 = is_one<NPT>(x1), id2 = is_one<NPT>(x2);
    if (lane == 0) {
      p.id1[b] = id1;
      p.id2[b] = id2;
    }
    sub = id1 || id2;
    if (sub) {
      wl::load_row<NPT>(x1, p.h.a, L, lane);
      wl::load_row<NPT>(x2, p.h2.a, L, lane);
    }
    swap = wl::mag_cmp<NPT>(x1, x2, lane) > 0;  // then a1 <= a2
    even = (__shfl_sync(WL_FULL, swap ? x1[0] : x2[0], 0) & 1) == 0;
  }
  // F1n is the right form where swapped; F2n the other, (c, -b, a) if even
  const bool r1 = swap, r2 = !swap;
  // s = b1 + b2 and dd = b2 - b1 on Lh limbs, side by side
  int v[2][NPT], sg[2];
  {
    const int s1 = *form_row(p, r1, sub, 3, b), s2t = *form_row(p, r2, sub, 3, b);
    const int s2 = even ? -s2t : s2t;
    if (lane == 0) {
      p.b1s[b] = s1;
      p.b2s[b] = s2;
    }
    int y1[NPT], y2[NPT];
    wl::load_row<NPT>(y1, form_row(p, r1, sub, 1, off), Lh, lane);
    wl::load_row<NPT>(y2, form_row(p, r2, sub, 1, off), Lh, lane);
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      const uint32_t u1 = (uint32_t)wl::mulw(s1, y1[j]),
                     u2 = (uint32_t)wl::mulw(s2, y2[j]);
      v[0][j] = (int)(u1 + u2);
      v[1][j] = (int)(u2 - u1);
    }
  }
  wl::canonicalize_rows<NPT, 2>(v, sg, lane, Lh);
  const int hoff = b * Lh;
  if (lane == 0) {
    p.ss[b] = sg[0];
    p.dds[b] = sg[1];
  }
  wl::store_row<NPT>(v[1], p.ddm + hoff, Lh, lane);
  wl::shr_bits<NPT>(v[0], v[1], 1, lane);
  wl::store_row<NPT>(v[1], p.sm + hoff, Lh, lane);
  // the forms' rows, each read once where the selects pick it; a1 and a2
  // last, both held for the first gcd's operands
  const int *a2 = form_row(p, r2, sub, 0, off), *c2 = form_row(p, r2, sub, 2, off);
  copy_row<NPT>(p.b1 + off, form_row(p, r1, sub, 1, off), L, lane);
  copy_row<NPT>(p.c1 + off, form_row(p, r1, sub, 2, off), L, lane);
  copy_row<NPT>(p.b2 + off, form_row(p, r2, sub, 1, off), L, lane);
  copy_row<NPT>(p.c2 + off, even ? a2 : c2, L, lane);
  int x1[NPT], x2[NPT];
  wl::load_row<NPT>(x1, form_row(p, r1, sub, 0, off), L, lane);
  wl::load_row<NPT>(x2, even ? c2 : a2, L, lane);
  wl::store_row<NPT>(x1, p.a1 + off, L, lane);
  wl::store_row<NPT>(x2, p.a2 + off, L, lane);
  if (p.Lxn > 0) first_gcd_operands<NPT>(p, x1, x2, b, lane);
}

template <int NPT>
void launch(const Params& p, cudaStream_t s) {
  const int blocks = (p.B + kWarps - 1) / kWarps;
  compose_prologue_kernel<NPT><<<blocks, 32 * kWarps, 0, s>>>(p);
}

}  // namespace

// Plain C entry point (bound with ctypes). in: 16 device pointers, the
// (a, b_sign, b, c) of F1 and F2 (contiguous (B, L) int32 rows, (B,)
// int32 signs) and of h and h^2 (one row each, L limbs, and one sign);
// out: 14 device pointers, a1, b1s, b1m, c1, a2, b2s, b2m, c2 ((B, L) and
// (B,) int32), ss, sm, dds, ddm ((B,) and (B, Lh) int32) and id1, id2
// ((B,) bool), and with Lxn > 0 five more, fx ((B,) bool), a2_n, a1_n
// ((B, Lxn) int32), a2_w, a1_w ((B, L) int32). 1 <= Lh <= L <= 288, Lxn
// 0 or in [2, L), and B L < 2^31. Returns cudaGetLastError() after the
// launch; cudaErrorInvalidValue for sizes outside that.
extern "C" int compose_prologue_launch(void* const* in, void* const* out, int B,
                                       int L, int Lh, int Lxn, void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || L > 288 || Lh < 1 || Lh > L || (long long)B * L >= (1LL << 31) ||
      Lxn < 0 || Lxn == 1 || Lxn >= L)
    return (int)cudaErrorInvalidValue;
  Params p{};
  Form* forms[4] = {&p.f1, &p.f2, &p.h, &p.h2};
  for (int f = 0; f < 4; f++) {
    forms[f]->a = (const int*)in[4 * f];
    forms[f]->bs = (const int*)in[4 * f + 1];
    forms[f]->b = (const int*)in[4 * f + 2];
    forms[f]->c = (const int*)in[4 * f + 3];
  }
  int** rows[12] = {&p.a1, &p.b1s, &p.b1, &p.c1, &p.a2, &p.b2s,
                    &p.b2, &p.c2,  &p.ss, &p.sm, &p.dds, &p.ddm};
  for (int i = 0; i < 12; i++) *rows[i] = (int*)out[i];
  p.id1 = (unsigned char*)out[12];
  p.id2 = (unsigned char*)out[13];
  if (Lxn > 0) {
    p.fx = (unsigned char*)out[14];
    int** first[4] = {&p.a2n, &p.a1n, &p.a2w, &p.a1w};
    for (int i = 0; i < 4; i++) *first[i] = (int*)out[15 + i];
  }
  p.B = B;
  p.L = L;
  p.Lh = Lh;
  p.Lxn = Lxn;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 31) / 32) {
#define K6B_CASE(n)   \
  case n:             \
    launch<n>(p, s);  \
    break;
    K6B_CASE(1) K6B_CASE(2) K6B_CASE(3) K6B_CASE(4) K6B_CASE(5) K6B_CASE(6)
    K6B_CASE(7) K6B_CASE(8) K6B_CASE(9)
#undef K6B_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
