// bf16 products on Hopper's tensor cores for the window-attention kernels'
// bfloat16 paths (window_attn.cu, window_attn_bwd.cu): `mma.sync` m16n8k16
// and m16n8k8 with bf16 operands and float32 accumulators, `ldmatrix` from
// bf16 tiles staged as they are, and the two-term split of a float32
// operand.
//
// A product of two bf16 values is exact in float32, so where both operands
// are bf16 (q k^T, g v^T and their transposes) one mma computes what the
// float32 kernels' widened products do. Where one operand is float32 (p,
// ds), it is split into hi = bf16(x) and lo = bf16(x - hi), both rounded
// to nearest, and the product accumulates a_lo b, then a_hi b: hi + lo
// keeps about 2^-17 of x, inside the kernels' 1e-4 limit; hi alone (2^-9)
// misses it (tests/test_torch_window_attn.py emulates both).
//
// Fragments (g = lane / 4, t = lane % 4; a 32-bit register holds two bf16,
// the lower column in its low half):
//   A [16 x 16] of m16n8k16: a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                            a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9)
//   B [16 x 8]:              b[0] = (k = 2t..2t+1, n = g), b[1] = (k = 2t+8..2t+9, n = g)
//   A [16 x 8] of m16n8k8:   a[0], a[1]; B [8 x 8]: b[0]
//   C [16 x 8]:              c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
// So the C fragments of two adjacent n-tiles are, as they stand, the A
// fragment of a k16 step over their 16 columns (a_from_c2): no shuffle and
// no trip through shared memory.
//
// An operand over head_dim (D, zero-padded to a multiple of 8: kPad) is
// held per 8-column block cb: an A operand as a[cb][h] = (row g + 8h,
// columns 8cb + 2t..), a B operand as b[cb] = (k = 8cb + 2t.., n = g); a
// k16 mma takes two blocks, an odd last block a k8 mma (mma_dims).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_tiles.cuh"  // kTile, cp_async8, cp_async16

namespace {

template <int D>
struct Bf16Dims {
  static constexpr int kPad = (D + 7) / 8 * 8;   // head_dim padded to 8
  static constexpr int kBlocks = kPad / 8;       // 8-column blocks
  // bf16 per staged row: an odd number of 16-byte units, so the 8 rows an
  // ldmatrix reads start in 8 different groups of 4 banks
  static constexpr int kStride = kBlocks % 2 ? kPad : kPad + 8;
  static constexpr int kTileElems = kTile * kStride;   // one staged tile
};

__device__ __forceinline__ void mma_k16(float c[4], const uint32_t a[4],
                                        const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_k8(float c[4], const uint32_t a[2],
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// c += a b over the padded head_dim: a k16 mma for each pair of column
// blocks, a k8 mma for an odd last block
template <int CB>
__device__ __forceinline__ void mma_dims(float c[4], const uint32_t a[CB][2],
                                         const uint32_t b[CB]) {
#pragma unroll
  for (int cb = 0; cb + 1 < CB; cb += 2) {
    const uint32_t aa[4] = {a[cb][0], a[cb][1], a[cb + 1][0], a[cb + 1][1]};
    const uint32_t bb[2] = {b[cb], b[cb + 1]};
    mma_k16(c, aa, bb);
  }
  if (CB % 2) mma_k8(c, a[CB - 1], b[CB - 1]);
}

// R (2 or 4) 8x8 bf16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8. Without Trans lane (g, t) receives
// (row g, columns 2t, 2t+1) of each, with Trans (rows 2t, 2t+1, column g).
template <int R, bool Trans>
__device__ __forceinline__ void ldsm(uint32_t* r, const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (R == 4 && !Trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  else if constexpr (R == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  else if constexpr (R == 2 && !Trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(s));
  else if constexpr (R == 2)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
        : "=r"(r[0]), "=r"(r[1]) : "r"(s));
  else
    static_assert(R == 2 || R == 4, "ldsm takes 2 or 4 matrices");
}

// M (even) 8x8 matrices of a staged tile [64][Stride] into r[0 .. M-1]:
// matrix m has its top-left corner at row at(m).x, column at(m).y; four at
// a time from matrix M0 on, the last two as a pair
template <int M, int Stride, bool Trans, int M0 = 0, typename At>
__device__ __forceinline__ void load_mats(uint32_t* r, const bf16* tile,
                                          int lane, At at) {
  static_assert(M % 2 == 0, "load_mats takes an even number of matrices");
  if constexpr (M - M0 >= 4) {
    const int2 rc = at(M0 + lane / 8);
    ldsm<4, Trans>(r + M0, tile + (rc.x + lane % 8) * Stride + rc.y);
    load_mats<M, Stride, Trans, M0 + 4>(r, tile, lane, at);
  } else if constexpr (M - M0 == 2) {
    const int2 rc = at(M0 + lane / 8 % 2);
    ldsm<2, Trans>(r + M0, tile + (rc.x + lane % 8) * Stride + rc.y);
  }
}

// B operands of x y^T with y staged: b[nt][cb] for the 8 staged rows
// r0 + 8 nt .. + 7 (the mma's n) over the padded head_dim (its k)
template <int D>
__device__ __forceinline__ void b_rows_bf16(
    uint32_t b[2][Bf16Dims<D>::kBlocks], const bf16* tile, int r0, int lane) {
  using C = Bf16Dims<D>;
  load_mats<2 * C::kBlocks, C::kStride, false>(
      &b[0][0], tile, lane, [=](int m) {
        return make_int2(r0 + 8 * (m / C::kBlocks), 8 * (m % C::kBlocks));
      });
}

// A operand of the 16 staged rows r0 .. r0+15 over the padded head_dim:
// a[cb][h] = (row r0 + g + 8h, columns 8cb + 2t..)
template <int D>
__device__ __forceinline__ void a_rows_bf16(
    uint32_t a[Bf16Dims<D>::kBlocks][2], const bf16* tile, int r0, int lane) {
  using C = Bf16Dims<D>;
  load_mats<2 * C::kBlocks, C::kStride, false>(
      &a[0][0], tile, lane,
      [=](int m) { return make_int2(r0 + 8 * (m % 2), 8 * (m / 2)); });
}

// B operands of p y with p from C fragments over 16 staged rows r0 ..
// r0+15 (the mma's k): b[nd][h] = (k = r0 + 8h + 2t.., n = head_dim column
// 8nd + g), by ldmatrix.trans
template <int D>
__device__ __forceinline__ void b_trans_bf16(
    uint32_t b[Bf16Dims<D>::kBlocks][2], const bf16* tile, int r0, int lane) {
  using C = Bf16Dims<D>;
  load_mats<2 * C::kBlocks, C::kStride, true>(
      &b[0][0], tile, lane,
      [=](int m) { return make_int2(r0 + 8 * (m % 2), 8 * (m / 2)); });
}

// A operand straight from device memory: rows r0 .. r0+15 of x [N, D]
// (bf16, unscaled), zero past row N-1 and column D-1
template <int D>
__device__ __forceinline__ void a_global_bf16(
    uint32_t a[Bf16Dims<D>::kBlocks][2], const bf16* x, int r0, int N, int g,
    int t) {
#pragma unroll
  for (int cb = 0; cb < Bf16Dims<D>::kBlocks; ++cb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const int d = 8 * cb + 2 * t;   // even, and D % 4 == 0: d + 1 < D
      a[cb][h] = r < N && d < D
                     ? __ldg(reinterpret_cast<const unsigned int*>(
                           x + (long long)r * D + d))
                     : 0u;
    }
}

// two floats as a bf16 pair, each rounded to nearest (ties to even), the
// first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 = hi + lo: hi = bf16(x), lo = bf16(x - hi); x - hi is exact
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// the C fragments of two adjacent n-tiles (16 columns) as the split A
// operand of a k16 step over those columns
__device__ __forceinline__ void a_from_c2(const float c0[4],
                                          const float c1[4], uint32_t hi[4],
                                          uint32_t lo[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// c += (hi + lo) b: the small term first
__device__ __forceinline__ void mma_split(float c[4], const uint32_t hi[4],
                                          const uint32_t lo[4],
                                          const uint32_t b[2]) {
  mma_k16(c, lo, b);
  mma_k16(c, hi, b);
}

// rows i0 .. i0+63 of x [N, D] (bf16) into dst [64][kStride] as they are,
// zero past row N-1; only the D columns are written (pad_tile sets the
// rest once). 16-byte copies where a row is a whole number of them (D % 8
// == 0), else 8-byte ones: a row of D = 20 is 40 bytes.
template <int D, int Threads>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* x, int i0,
                                           int N, int tid = threadIdx.x) {
  constexpr int kPer = D % 8 == 0 ? 8 : 4;   // elements a copy
  constexpr int kCopies = D / kPer;          // copies a row
  const bf16* src = x + (long long)i0 * D;
  for (int e = tid; e < kTile * kCopies; e += Threads) {
    const int r = e / kCopies, c = kPer * (e % kCopies);
    const bool ok = i0 + r < N;
    bf16* d = dst + r * Bf16Dims<D>::kStride + c;
    const bf16* s = ok ? src + r * D + c : x;
    if constexpr (kPer == 8)
      cp_async16(d, s, ok);
    else
      cp_async8(d, s, ok);
  }
}

// the padding columns D .. kStride-1 of a staged tile: zero, and with Ones
// a 1 in column D (D % 8 != 0), so that a product with the tile also sums
// the other operand's rows there
template <int D, int Threads, bool Ones = false>
__device__ __forceinline__ void pad_tile(bf16* dst) {
  constexpr int P = Bf16Dims<D>::kStride - D;
  for (int e = threadIdx.x; e < kTile * P; e += Threads) {
    const int r = e / P, c = D + e % P;
    dst[r * Bf16Dims<D>::kStride + c] =
        __float2bfloat16_rn(Ones && c == D ? 1.f : 0.f);
  }
}

}  // namespace
