// K5m: the magnitude product mod 2^(16 L_out) on Hopper (sm_90a), its
// limb products on the tensor cores.
//
// Replaces cofhe_tpu/ops/limb.py::_poly_mul8 / mag_mul (330-364; XLA, not
// Pallas: a grouped conv_general_dilated of 8-bit limbs on the TPU's
// matrix unit). Its plain torch version is cofhe_tpu_torch/ops/limb.py::
// mag_mul_plain (a float64 FFT of 8-bit limbs, ~67 torch kernels a call).
//
//   out = a * b mod 2^(16 Lo), canonical (Lo limbs)
//
// Only the limbs of a and b below Lo count, and each is read as its low 16
// bits (the plain version's 8-bit split reads the same bits), so the output
// equals the plain version's for any int32 input; canonical inputs in
// [0, 2^16) are the contract.
//
// The product as integer MMA, the 8-bit convolution the JAX package ran on
// the TPU's matrix unit. Both operands are read as 8-bit limbs (a8, b8).
// The shorter one (s8) is cut into 32-byte blocks beta_J, the N columns;
// the longer one (l8) is a Toeplitz matrix A[m, t] = l8[m - t], rows m the
// output offsets (M), t < 32 the depth (K). Then
//
//   P[m, J] = sum_t l8[m - t] beta_J[t]      (one mma.sync m16n8k32
//   c8[k]   = sum_J P[k - 32 J, J]            .s32.u8.u8.s32 a 16 x 8 tile)
//
// and the 16-bit limb l is c8[2l] + ((c8[2l+1] & 0xFF) << 8) + (c8[2l-1]
// >> 8) (the JAX package's _from8). A product is at most 255^2 and a
// column sums at most 576 of them (2 x 288 bytes of the shorter row;
// 640 = 2 x 320 in the wide instances: 640 x 255^2 < 4.2e7), below 2^26,
// so P, the columns and the s32 accumulators are exact, and every
// recombined limb is below 2^26 + 2^24 < 2^27, nonnegative:
// wl::carry_nonneg then gives the canonical limbs and drops what passes
// limb Lo - 1.
//
// Fragments (PTX ISA, mma.m16n8k32 with .u8; g = lane / 4, q = lane % 4):
// - B: register r holds rows k = 4q + i (+ 16 for r = 1), column n = g:
//   one aligned 32-bit word of the packed shorter row (two 16-bit limbs,
//   little-endian), word 8 J + q (+ 4).
// - A: register r holds row g (+ 8 for r = 1, 3), columns 4q .. 4q + 3
//   (+ 16 for r = 2, 3): the four descending bytes l8[x], l8[x-1],
//   l8[x-2], l8[x-3] at x = m - 4q (- 16). The longer row is staged
//   reversed in shared memory with kPad zero bytes on each side, so each
//   register is a 4-byte window at one byte offset: two aligned loads and
//   a funnel shift, the four registers of a tile from eight consecutive
//   words at one shift.
// - C: register r holds row g (+ 8 for r >= 2), column 2q + (r & 1); it is
//   added (a shared-memory atomic) into the row's int32 column k = m0 +
//   row + 32 J when k < 2 Lo, the truncated triangle exactly. The lanes
//   of one register meet four to a bank (k differs by 64 across q);
//   padding the columns to spread them timed slower on an H100 at 128
//   rows and at compose2's 72-limb shapes at 16384 rows.
// A tile (16 rows from m0, 8 blocks from J0) is skipped when every k it
// holds is at or past 2 Lo (m0 + 32 J0 >= 2 Lo) or its A is zero (m0 - 31
// past the longer row), so an n8 tile has ceil(min(2 nl + 31, 2 Lo - 32
// J0) / 16) m-tiles. At compose2's shapes: 72x72->144 11 tiles,
// 72x144->144 18, 72x144->200 20, 200x72->264 27, 136x136->264 36 (two n8
// tiles); 288x288->288 60 (three). At k=256 (L = 160): 80x80->160 12,
// 80x160->160 20, 80x160->224 22, 224x80->296 30, 152x152->296 42 (two
// n8 tiles, 21 each); 320x320->320 72 (three).
//
// Why mma.sync and not wgmma: a row has 11-60 tiles of 16 x 8 x 32 and the
// rows are independent; wgmma's 64-row warpgroup tiles and shared-memory
// descriptors buy nothing at this size, and the bound is bytes.
//
// Launch shape (chosen in the launcher by the batch B): a row gets WPR
// warps that split its m-tiles, kWarps / WPR rows a block of kWarps warps;
// after a __syncthreads the row's first warp recombines and carries it.
// WPR = 4 while B <= kSplitRows, else 2. Timed on an H100 (chip_smoke.py's
// "launch shapes", WPR = 1, 2, 4): at 128 and 1001 rows, where time is
// latency (at 128 a block has an SM to itself), four warps a row beat one
// by 1.2-1.7x (sq's 36 tiles are at most 9 MMAs a warp); at 16384 rows, where
// the grid is full, two warps a row beat one by 2-5% on four of compose2's
// five shapes (3% slower on 72x72) and beat four by up to 25%. kSplitRows
// lies between the batches measured; mag_mul_launch_split takes WPR
// explicitly for that measurement.
//
// Two classes of instance, the same code: NPT <= 9 output limbs a thread
// (Lo <= 288, every k=128 product) with rows staged for 288 limbs, and
// NPT = 10 (289 <= Lo <= 320: compose2's t1 and sq at k=256, Lo = 296)
// with rows staged for 320; the template's first argument, NPT, names
// the class in the profiler (mag_mul_kernel<10, ...> is wide).
//
// What bounds it on this card: the function's bytes (two rows in, one
// out); its 8-bit products at the int8 tensor-core rate take a tenth of
// that. Shared memory: 3776 bytes a row, 15 KB a block (narrow); 4096
// bytes a row, 16 KB a block (wide).

#include "warp_limbs.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kNarrow = 288;              // limbs a row at most, NPT <= 9
constexpr int kWide = 320;                // and with NPT = 10
constexpr int kPad = 64;                  // zero bytes each side of the long row
constexpr int kShortWords = 3 * 64;       // three n8 tiles of eight 32-byte blocks
constexpr int kSplitRows = 4096;          // WPR = 4 up to this many rows, else 2

// the rows of an instance with NPT output limbs a thread: kMax limbs each
template <int kMax>
struct RowSmem {
  uint32_t lng[(2 * kMax + 2 * kPad) / 4];  // byte kPad + 2 nl - 1 - y holds l8[y]
  uint32_t sht[kShortWords];  // word w holds limbs 2w, 2w + 1 of the shorter row
  int col[2 * kMax];          // the 8-bit columns c8[k], k < 2 Lo
};

// D = A B on the tensor cores, 8-bit unsigned inputs, s32 sums (IMMA)
__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(0), "r"(0),
        "r"(0), "r"(0));
}

template <int NPT, int WPR>
__global__ void __launch_bounds__(32 * kWarps)
mag_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ out, int B, int La, int Lb, int sa, int sb,
               int Lo) {
  constexpr int kRows = kWarps / WPR;
  using Smem = RowSmem<NPT <= 9 ? kNarrow : kWide>;
  __shared__ Smem sm[kRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wi = warp % WPR;          // this warp's index among its row's
  const int tid = wi * 32 + lane;     // thread index among its row's
  const long long row = (long long)blockIdx.x * kRows + warp / WPR;
  const bool live = row < B;          // uniform over the row's warps
  Smem& s = sm[warp / WPR];

  int na = min(La, Lo), nb = min(Lb, Lo);
  const int* pl = a + row * sa;
  const int* ps = b + row * sb;
  if (na < nb) {  // pl: the longer operand (the Toeplitz side)
    const int* t = pl;
    pl = ps;
    ps = t;
  }
  const int nl = max(na, nb), ns = min(na, nb);
  const int n8l = 2 * nl;
  const int NT = ((2 * ns + 31) / 32 + 7) / 8;  // n8 tiles of blocks
  if (live) {
    for (int w = tid; w < (n8l + 2 * kPad) / 4; w += 32 * WPR) {
      // bytes 4w .. 4w + 3: l8[2i + 1], l8[2i], l8[2i - 1], l8[2i - 2]
      const int i = kPad / 2 + nl - 1 - 2 * w;
      const uint32_t hi = i >= 0 && i < nl ? (uint32_t)pl[i] : 0u;
      const uint32_t lo = i >= 1 && i - 1 < nl ? (uint32_t)pl[i - 1] : 0u;
      s.lng[w] = __byte_perm(hi, lo, 0x4501);
    }
    for (int w = tid; w < 64 * NT; w += 32 * WPR) {
      const uint32_t x0 = 2 * w < ns ? (uint32_t)ps[2 * w] : 0u;
      const uint32_t x1 = 2 * w + 1 < ns ? (uint32_t)ps[2 * w + 1] : 0u;
      s.sht[w] = __byte_perm(x0, x1, 0x5410);
    }
    for (int k = tid; k < 2 * Lo; k += 32 * WPR) s.col[k] = 0;
  }
  __syncthreads();

  if (live) {
    const int g = lane >> 2, q = lane & 3;
    int before = 0;  // tiles of the earlier n8 tiles (spreads them over warps)
    for (int T = 0; T < NT; T++) {
      const int J0 = 8 * T;
      const int mend = min(n8l + 31, 2 * Lo - 32 * J0);
      const int tiles = mend > 0 ? (mend + 15) / 16 : 0;
      const uint32_t b0 = s.sht[8 * (J0 + g) + q];
      const uint32_t b1 = s.sht[8 * (J0 + g) + 4 + q];
      const int first = ((wi - before) % WPR + WPR) % WPR;
#pragma unroll 2
      for (int i = first; i < tiles; i += WPR) {
        const int m0 = 16 * i;
        const int base = kPad + n8l - 1 - (m0 + g - 4 * q);  // window of x = m - 4q
        const int w0 = base >> 2, sh = 8 * (base & 3);
        const uint32_t* L = s.lng + w0;
        int d[4];
        mma_u8(d, __funnelshift_r(L[0], L[1], sh),    // row g
               __funnelshift_r(L[-2], L[-1], sh),     // row g + 8
               __funnelshift_r(L[4], L[5], sh),       // row g, t + 16
               __funnelshift_r(L[2], L[3], sh),       // row g + 8, t + 16
               b0, b1);
        const int k0 = m0 + g + 32 * (J0 + 2 * q);
#pragma unroll
        for (int r = 0; r < 4; r++) {
          const int k = k0 + 8 * (r >> 1) + 32 * (r & 1);
          if (k < 2 * Lo) atomicAdd(&s.col[k], d[r]);
        }
      }
      before += tiles;
    }
  }
  __syncthreads();

  if (live && wi == 0) {
    int x[NPT];
#pragma unroll
    for (int j = 0; j < NPT; j++) {
      const int l = lane * NPT + j;
      x[j] = l < Lo ? s.col[2 * l] + ((s.col[2 * l + 1] & 0xFF) << 8) +
                          (l > 0 ? s.col[2 * l - 1] >> 8 : 0)
                    : 0;
    }
    wl::carry_nonneg<NPT>(x, lane, Lo);
    wl::store_row<NPT>(x, out + row * Lo, Lo, lane);
  }
}

template <int NPT>
int launch(const int* a, const int* b, int* out, int B, int La, int Lb,
           int sa, int sb, int Lo, int wpr, cudaStream_t s) {
  const int rows = kWarps / wpr;
  const int blocks = (B + rows - 1) / rows;
  switch (wpr) {
    case 1:
      mag_mul_kernel<NPT, 1><<<blocks, 32 * kWarps, 0, s>>>(a, b, out, B, La, Lb,
                                                            sa, sb, Lo);
      break;
    case 2:
      mag_mul_kernel<NPT, 2><<<blocks, 32 * kWarps, 0, s>>>(a, b, out, B, La, Lb,
                                                            sa, sb, Lo);
      break;
    case 4:
      mag_mul_kernel<NPT, 4><<<blocks, 32 * kWarps, 0, s>>>(a, b, out, B, La, Lb,
                                                            sa, sb, Lo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// a: (B, La) and b: (B, Lb) int32 rows at row strides sa, sb (unit limb
// stride, any 4-byte alignment, 0 for a broadcast operand); out: (B, Lo)
// contiguous. 1 <= Lo <= 320 (the wide class, NPT = 10, where Lo > 288);
// La, Lb >= 1, of which min(La, Lo) and min(Lb, Lo) limbs are read. wpr:
// warps a row, 1, 2 or 4.
extern "C" int mag_mul_launch_split(const int* a, const int* b, int* out, int B,
                                    int La, int Lb, int sa, int sb, int Lo,
                                    int wpr, void* stream) {
  if (B <= 0) return 0;
  if (La < 1 || Lb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch ((Lo + 31) / 32) {
#define K5M_CASE(n)                                                  \
  case n:                                                            \
    rc = launch<n>(a, b, out, B, La, Lb, sa, sb, Lo, wpr, s);        \
    break;
    K5M_CASE(1) K5M_CASE(2) K5M_CASE(3) K5M_CASE(4) K5M_CASE(5) K5M_CASE(6)
    K5M_CASE(7) K5M_CASE(8) K5M_CASE(9) K5M_CASE(10)
#undef K5M_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// The same with the launch shape chosen by the batch: four warps a row up
// to kSplitRows rows, two above.
extern "C" int mag_mul_launch(const int* a, const int* b, int* out, int B,
                              int La, int Lb, int sa, int sb, int Lo,
                              void* stream) {
  return mag_mul_launch_split(a, b, out, B, La, Lb, sa, sb, Lo,
                              B <= kSplitRows ? 4 : 2, stream);
}
