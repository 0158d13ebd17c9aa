// (Shifted-)window attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_pallas_attention` in
// dl_swin_gan_tpu/kernels/window_attn.py (body `_fwd_kernel`). For every
// window w and head h it computes
//
//     s   = (q[w,h] * scale) k[w,h]^T + bias[h] (+ mask[w % nW])
//     p   = softmax(s) over the keys, the row max subtracted, in float32
//     out = p v[w,h]
//
// Layout, all contiguous:
//   q, k, v, out  [W, H, N, D]    W = batch * windows, D % 4 == 0, D <= 32;
//                                 float32 (window_attn_launch) or bfloat16
//                                 (window_attn_bf16_launch)
//   bias          [H, N, N]       float32 relative-position bias, per head
//   mask          [nW, N, N]      float32 0 / -100 shift mask, or null
//   lse           [W, H, N]       float32 row log-sum-exp, or null; written
//                                 for the backward (window_attn_bwd.cu)
//   out32         [W, H, N, D]    bf16 only: the output in float32 as well,
//                                 or null; the backward's delta reads it
//
// bfloat16 is the Pallas kernel's bf16 contract: q, k and v are widened to
// float32 exactly, everything after runs as in float32, and only the stored
// output rounds to bf16. The backward's delta = rowsum(g o out) would lose
// about 8 bits if it read that rounded output, where the Pallas backward's
// rowsum(dp o p) is float32 throughout; so when the backward will run, the
// forward also writes out32 (4 more bytes per element) and the backward
// reads that.
//
// Arithmetic, float32: both products run on the tensor cores as 3xTF32
// (`mma.sync.m16n8k8`, mma_tf32.cuh), as in the backward: each float32
// operand is split into hi = tf32(x) and lo = tf32(x - hi), rounded to
// nearest, and a product accumulates a_hi b_lo + a_lo b_hi, then a_hi b_hi,
// in float32. That is about as accurate as float32 FMA; plain TF32 would
// miss the 1e-4 limit (tests/test_torch_window_attn.py emulates both).
// head_dim is zero-padded to a multiple of 8 (20 -> 24); only the real D
// columns are stored. The softmax is float32; exp(s - m) is taken as
// 2^(s log2 e - m log2 e) on ex2.approx.
//
// Bound: 4*W*H*N^2*D FLOP (the two products) against about 4*(4*W*H*N*D +
// H*N^2 + nW*N^2) bytes. At the Swin denoiser's full width (N = 448,
// D = 20, H = 8, W = 12 per slice) that is 1.54 GFLOP against 30 MB: at
// 3xTF32 (495 TFLOP/s of TF32 / 3) the operations bound it at 0.0093 ms
// per slice, ahead of the bytes (0.0090 ms at 3.35 TB/s). mma.sync itself
// reaches about 300 TFLOP/s of TF32 on the H100 (compare_attn_fwd.py
// --probe), and the padding to 24 adds a fifth: 0.018 ms. Every block also
// reads its rows of bias[h] and mask[w % nW] through L2: 77 MB of each per
// slice (16 MB distinct).
//
// Arithmetic, bf16 (window_attn_fwd_bf16_kernel): a product of two bf16
// values is exact in float32, so s = q k^T is one bf16 tensor-core product
// (`mma.sync.m16n8k16` with bf16 operands and float32 accumulators, plus
// one m16n8k8 where head_dim 20 pads to 24; mma_bf16.cuh), on q unscaled,
// the scale then applied to s in float32. p is float32: it is split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), and o += p_lo v + p_hi v, two
// bf16 products that keep about 2^-17 of p (p_hi alone, 2^-9, would miss
// the 1e-4 limit; tests/test_torch_window_attn.py emulates both). The
// softmax, the bias and mask reads and the stores are the float32
// kernel's. Bound: q, k, v and out move half the bytes (23 MB per slice:
// 0.0068 ms), and at the bf16 tensor-core rate (989 TFLOP/s) the products
// take 0.0016 ms: the bytes bound it. What the design does about that: K
// and V are staged as they are (bf16, no widening, no hi and lo planes:
// 12 KB of shared memory a block at head_dim 20 against 38 KB), read by
// `ldmatrix` (V by `ldmatrix.trans`) at a row stride of an odd number of
// 16-byte units, free of bank conflicts; a chunk of 16 keys costs 10 bf16
// mma per 16 rows where 3xTF32 took 36 TF32 ones; and p's C fragments are
// the A operand as they stand (two adjacent n-tiles make one k16 step), so
// no column permutation is needed.
//
// Design, the backward's kv pass mirrored (window_attn_bwd.cu). A block
// takes one (window, head) and kRows = 128 query rows: 4 warps of two
// 16-row groups, each group's rows held, pre-scaled, as split A fragments
// in registers. At N = 448 that is 4 tiles per window and head (the last
// one's two upper warps hold no row and only stage), 384 blocks per slice:
// one wave at 3 blocks per SM, which 168 registers a thread allow. K and V
// stream through the block in 64-key tiles: cp.async brings tile j+1 in raw
// while tile j is in use (double-buffered), and each staged tile is split
// once into hi and lo planes (attn_tiles.cuh), so shared memory does not
// grow with N. For every chunk of 16 keys a warp computes s = q k^T on the
// mma, each B fragment read once from the K planes for both of its groups;
// adds the bias and mask at the C fragments' positions (8-byte loads from
// row offsets taken once, issued a chunk ahead of their use); and runs the
// online softmax on the fragments: a row lives in one quad of lanes, so its
// chunk max takes two shuffles. p goes back into the mma as the A operand
// with its columns permuted (its split on the integer pipes) and V's rows
// are read in the same order (load_b_perm): o += p v with no trip through
// shared memory. Where D % 8 != 0, V's first padding column holds ones, so
// that product also sums p's rows; else each lane sums its share. At the
// end each row is divided by its sum. Keys past N get p = 0; a chunk wholly
// past N is skipped; query rows past N read zeros (and a clamped bias row)
// and store nothing. The bf16 kernel has the same blocks, warps, chunks and
// softmax, its tiles staged raw as above (the ones column in V's padding
// too). Measured against the fp32-FMA kernel it replaces, SDPA, the 3xTF32
// bf16 kernel before it and the designs tried on the way: PERF.md,
// Findings.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tiles.cuh"  // Dims, tiles and fragments, kTile
#include "mma_bf16.cuh"    // Bf16Dims, bf16 tiles, mma_dims, mma_split
#include "mma_tf32.cuh"    // AFrag, BFrag, mma3

namespace {

constexpr int kWarps = 4;                   // warps per block
constexpr int kGroups = 2;                  // 16-row query groups per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kGroups * kWarps;   // query rows per block
constexpr int kChunk = 16;                  // keys per online-softmax step
constexpr int kChunkTiles = kChunk / 8;     // n-tiles of m16n8k8 per chunk
constexpr float kLog2e = 1.4426950408889634f;

// blocks per SM the registers must allow: 3 up to head_dim 20 (3 blocks of
// 128 threads cap a thread at 168 registers), 2 for wider heads, whose
// fragments outgrow that cap
constexpr int min_blocks(int D) { return D <= 20 ? 3 : 2; }

// dynamic shared memory of a block, in bytes: two raw (K, V) stages and
// the split K and V planes
template <int D>
constexpr size_t fwd_smem() {
  using C = Dims<D>;
  return sizeof(float) * (2 * 2 * C::kRaw + 4 * C::kPlane);
}
// it depends on head_dim only, and the widest fits a Hopper block's opt-in
static_assert(fwd_smem<32>() <= 232448, "shared memory past the opt-in");

__device__ __forceinline__ float ex2(float x) {   // 2^x, approximate
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one 16-row group's chunk of s (+ bias, + mask; -inf past key N - 1 where
// the chunk is ragged) -> p = exp(s - m) in place; the group's running max
// m updated and its accumulator rescaled by exp(m_old - m_new). With Sum,
// this lane's share of each row's sum is kept in sum (rescaled with it);
// else the sum is the accumulator's column of V's ones. j is the lane's
// first key in the chunk.
template <int Steps, bool Sum>
__device__ __forceinline__ void online_softmax(
    float sc[kChunkTiles][4], const float bm[kChunkTiles][4],
    const float mk[kChunkTiles][4], float mx[2], float sum[2],
    float acc[Steps][4], int j, bool ragged, int N) {
#pragma unroll
  for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = (sc[n][e] + bm[n][e]) + mk[n][e];
  if (ragged) {   // the last chunk: -inf past key N - 1
#pragma unroll
    for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + 8 * n + (e & 1) >= N) sc[n][e] = -CUDART_INF_F;
  }
  // the chunk's row maxima; a row lives in the four lanes of one mma group
  float top[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) top[e >> 1] = fmaxf(top[e >> 1], sc[n][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 1));
    top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 2));
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = fmaxf(mx[r], top[r]);
    alpha[r] = ex2((mx[r] - m) * kLog2e);   // 0 at the first chunk
    mx[r] = m;
    if (Sum) sum[r] *= alpha[r];
  }
#pragma unroll
  for (int nd = 0; nd < Steps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
  const float ml[2] = {mx[0] * kLog2e, mx[1] * kLog2e};
#pragma unroll
  for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = ex2(fmaf(sc[n][e], kLog2e, -ml[e >> 1]));
      if (Sum) sum[e >> 1] += sc[n][e];
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
window_attn_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask,
                       float* __restrict__ out, float* __restrict__ lse,
                       int H, int N, int nW, float scale) {
  using C = Dims<D>;
  // the row sums come out of the p v product where V has a padding column
  constexpr bool kOnes = D % 8 != 0;
  constexpr int kStage = 2 * C::kRaw;   // raw k, v
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);
  uint32_t* kpl = reinterpret_cast<uint32_t*>(raw + 2 * kStage);
  uint32_t* vpl = kpl + 2 * C::kPlane;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tc = lane % 4;   // the mma's group, thread in group
  const int h = blockIdx.y, w = blockIdx.z;
  const long long rows = ((long long)w * H + h) * N;   // row 0 of (w, h)
  const float* bh = bias + (long long)h * N * N;
  const float* mw = mask ? mask + (long long)(w % nW) * N * N : nullptr;
  // this warp's first query row; group gi takes rows i0 + 16 gi .. + 15
  const int i0 = blockIdx.x * kRows + 16 * kGroups * warp;
  const bool live = i0 < N;   // a warp wholly past N only stages tiles

  AFrag qf[kGroups][C::kSteps];
  float acc[kGroups][C::kSteps][4] = {};
  // rows g and g + 8 of each group: running max, this lane's share of sum
  float mx[kGroups][2], sum[kGroups][2] = {};
  // offsets of the rows g and g + 8 of each group in bias[h] and mask[w],
  // and their values at the next chunk, loaded a chunk ahead of their use
  int bo[kGroups][2];
  float nb[kGroups][kChunkTiles][4], nm[kGroups][kChunkTiles][4] = {};
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int r0 = i0 + 16 * gi;
    load_a_global<D>(qf[gi], q + rows * D, r0, N, scale, gr, tc);
    mx[gi][0] = mx[gi][1] = -CUDART_INF_F;
    bo[gi][0] = bias_row_offset(r0 + gr, tc, N);
    bo[gi][1] = bias_row_offset(r0 + gr + 8, tc, N);
    load_bias_rows<kChunkTiles>(nb[gi], bh, bo[gi][0], bo[gi][1], 0, tc, N);
    if (mw)
      load_bias_rows<kChunkTiles>(nm[gi], mw, bo[gi][0], bo[gi][1], 0, tc, N);
  }

  const int tiles = (N + kTile - 1) / kTile;
  auto prefetch = [&](int jt) {
    float* st = raw + (jt & 1) * kStage;
    stage_raw<D, kThreads>(st, k + rows * D, jt * kTile, N);
    stage_raw<D, kThreads>(st + C::kRaw, v + rows * D, jt * kTile, N);
  };
  prefetch(0);
  cp_async_commit();
  for (int jt = 0; jt < tiles; ++jt) {
    __syncthreads();                 // every warp is done with tile jt - 1
    if (jt + 1 < tiles) prefetch(jt + 1);
    cp_async_commit();
    cp_async_wait_one();             // tile jt has landed
    __syncthreads();
    const float* st = raw + (jt & 1) * kStage;
    split_tile<D, kThreads>(kpl, st, 1.f);
    split_tile<D, kThreads, kOnes>(vpl, st + C::kRaw, 1.f);
    __syncthreads();

    const int j0 = jt * kTile;
#pragma unroll 1
    for (int c = 0; live && c < kTile && j0 + c < N; c += kChunk) {
      // s = (q * scale) k^T over the chunk's keys, each B for every group
      float sc[kGroups][kChunkTiles][4] = {};
#pragma unroll
      for (int ks = 0; ks < C::kSteps; ++ks)
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
          const BFrag b = load_b_rows<D>(kpl, c + 8 * n, ks, gr, tc);
#pragma unroll
          for (int gi = 0; gi < kGroups; ++gi) mma3(sc[gi][n], qf[gi][ks], b);
        }
      const bool ragged = j0 + c + kChunk > N;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        online_softmax<C::kSteps, !kOnes>(sc[gi], nb[gi], nm[gi], mx[gi],
                                          sum[gi], acc[gi], j0 + c + 2 * tc,
                                          ragged, N);
        // the next chunk's bias and mask, in flight during this one's p v
        const int next = j0 + c + kChunk;
        load_bias_rows<kChunkTiles>(nb[gi], bh, bo[gi][0], bo[gi][1], next,
                                    tc, N);
        if (mw)
          load_bias_rows<kChunkTiles>(nm[gi], mw, bo[gi][0], bo[gi][1], next,
                                      tc, N);
      }
      // o += p v over the chunk's keys, each B for every group
#pragma unroll
      for (int kk = 0; kk < kChunkTiles; ++kk) {
        AFrag pa[kGroups];
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi)
          pa[gi] = a_from_c<true>(sc[gi][kk]);
#pragma unroll
        for (int nd = 0; nd < C::kSteps; ++nd) {
          const BFrag b = load_b_perm<D>(vpl, c + 8 * kk, nd, gr, tc);
#pragma unroll
          for (int gi = 0; gi < kGroups; ++gi) mma3(acc[gi][nd], pa[gi], b);
        }
      }
    }
  }

  // each row's sum (V's ones column, or the four lanes' shares); out =
  // acc / sum, and the rows' log-sum-exp when the backward asked for it
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t;
      if (kOnes) {   // column D of the accumulator, on lane (g, (D % 8) / 2)
        t = __shfl_sync(0xffffffffu, acc[gi][D / 8][2 * r],
                        (lane & ~3) | (D % 8) / 2);
      } else {
        t = sum[gi][r];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
      }
      const int i = i0 + 16 * gi + gr + 8 * r;
      if (i >= N) continue;
#pragma unroll
      for (int nd = 0; nd < C::kSteps; ++nd) {
        const int d = 8 * nd + 2 * tc;   // even, and D % 4 == 0: d + 1 < D
        if (d < D) {
          const float a = acc[gi][nd][2 * r] / t;
          const float b = acc[gi][nd][2 * r + 1] / t;
          store2(out + (rows + i) * D + d, a, b);
        }
      }
      if (lse != nullptr && tc == 0) lse[rows + i] = mx[gi][r] + logf(t);
    }
}

// The bf16 path: q, k and v as they are, exact bf16 products. A block takes
// one (window, head) and kRows query rows as the float32 kernel does, each
// 16-row group's rows held unscaled as bf16 A fragments; K and V tiles are
// staged raw (bf16, [64][kStride], mma_bf16.cuh) and read by ldmatrix.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
window_attn_fwd_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            bf16* __restrict__ out, float* __restrict__ out32,
                            float* __restrict__ lse, int H, int N, int nW,
                            float scale) {
  using C = Bf16Dims<D>;
  constexpr int CB = C::kBlocks;
  // the row sums come out of the p v product where V has a padding column
  constexpr bool kOnes = D % 8 != 0;
  extern __shared__ float4 smem4[];
  bf16* stg = reinterpret_cast<bf16*>(smem4);   // [stage][K, V] tiles
  for (int st = 0; st < 2; ++st) {   // padding columns, set once
    pad_tile<D, kThreads>(stg + 2 * st * C::kTileElems);
    pad_tile<D, kThreads, kOnes>(stg + (2 * st + 1) * C::kTileElems);
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tc = lane % 4;   // the mma's group, thread in group
  const int h = blockIdx.y, w = blockIdx.z;
  const long long rows = ((long long)w * H + h) * N;   // row 0 of (w, h)
  const float* bh = bias + (long long)h * N * N;
  const float* mw = mask ? mask + (long long)(w % nW) * N * N : nullptr;
  const int i0 = blockIdx.x * kRows + 16 * kGroups * warp;
  const bool live = i0 < N;   // a warp wholly past N only stages tiles

  uint32_t qa[kGroups][CB][2];
  float acc[kGroups][CB][4] = {};
  float mx[kGroups][2], sum[kGroups][2] = {};
  int bo[kGroups][2];
  float nb[kGroups][kChunkTiles][4], nm[kGroups][kChunkTiles][4] = {};
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int r0 = i0 + 16 * gi;
    a_global_bf16<D>(qa[gi], q + rows * D, r0, N, gr, tc);
    mx[gi][0] = mx[gi][1] = -CUDART_INF_F;
    bo[gi][0] = bias_row_offset(r0 + gr, tc, N);
    bo[gi][1] = bias_row_offset(r0 + gr + 8, tc, N);
    load_bias_rows<kChunkTiles>(nb[gi], bh, bo[gi][0], bo[gi][1], 0, tc, N);
    if (mw)
      load_bias_rows<kChunkTiles>(nm[gi], mw, bo[gi][0], bo[gi][1], 0, tc, N);
  }

  const int tiles = (N + kTile - 1) / kTile;
  auto prefetch = [&](int jt) {
    bf16* st = stg + 2 * (jt & 1) * C::kTileElems;
    stage_bf16<D, kThreads>(st, k + rows * D, jt * kTile, N);
    stage_bf16<D, kThreads>(st + C::kTileElems, v + rows * D, jt * kTile, N);
  };
  prefetch(0);
  cp_async_commit();
  for (int jt = 0; jt < tiles; ++jt) {
    __syncthreads();                 // every warp is done with tile jt - 1
    if (jt + 1 < tiles) prefetch(jt + 1);
    cp_async_commit();
    cp_async_wait_one();             // tile jt has landed
    __syncthreads();
    const bf16* kt = stg + 2 * (jt & 1) * C::kTileElems;
    const bf16* vt = kt + C::kTileElems;

    const int j0 = jt * kTile;
#pragma unroll 1
    for (int c = 0; live && c < kTile && j0 + c < N; c += kChunk) {
      // s = q k^T over the chunk's keys, exact; then times the scale
      uint32_t kb[kChunkTiles][CB];
      b_rows_bf16<D>(kb, kt, c, lane);
      float sc[kGroups][kChunkTiles][4] = {};
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
          mma_dims<CB>(sc[gi][n], qa[gi], kb[n]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[gi][n][e] *= scale;
        }
      const bool ragged = j0 + c + kChunk > N;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        online_softmax<CB, !kOnes>(sc[gi], nb[gi], nm[gi], mx[gi], sum[gi],
                                   acc[gi], j0 + c + 2 * tc, ragged, N);
        const int next = j0 + c + kChunk;
        load_bias_rows<kChunkTiles>(nb[gi], bh, bo[gi][0], bo[gi][1], next,
                                    tc, N);
        if (mw)
          load_bias_rows<kChunkTiles>(nm[gi], mw, bo[gi][0], bo[gi][1], next,
                                      tc, N);
      }
      // o += (p_hi + p_lo) v over the chunk's keys: p's C fragments are the
      // A operand as they stand, V's B fragments come by ldmatrix.trans
      uint32_t vb[CB][2];
      b_trans_bf16<D>(vb, vt, c, lane);
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        uint32_t ph[4], pl[4];
        a_from_c2(sc[gi][0], sc[gi][1], ph, pl);
#pragma unroll
        for (int nd = 0; nd < CB; ++nd) mma_split(acc[gi][nd], ph, pl, vb[nd]);
      }
    }
  }

  // each row's sum (V's ones column, or the four lanes' shares); out =
  // acc / sum, and the rows' log-sum-exp when the backward asked for it
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t;
      if (kOnes) {   // column D of the accumulator, on lane (g, (D % 8) / 2)
        t = __shfl_sync(0xffffffffu, acc[gi][D / 8][2 * r],
                        (lane & ~3) | (D % 8) / 2);
      } else {
        t = sum[gi][r];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
      }
      const int i = i0 + 16 * gi + gr + 8 * r;
      if (i >= N) continue;
#pragma unroll
      for (int nd = 0; nd < CB; ++nd) {
        const int d = 8 * nd + 2 * tc;   // even, and D % 4 == 0: d + 1 < D
        if (d < D) {
          const float a = acc[gi][nd][2 * r] / t;
          const float b = acc[gi][nd][2 * r + 1] / t;
          store2(out + (rows + i) * D + d, a, b);
          if (out32 != nullptr) store2(out32 + (rows + i) * D + d, a, b);
        }
      }
      if (lse != nullptr && tc == 0) lse[rows + i] = mx[gi][r] + logf(t);
    }
}

template <int D>
constexpr size_t fwd_bf16_smem() {   // two stages of K and V tiles
  return sizeof(bf16) * 2 * 2 * Bf16Dims<D>::kTileElems;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* bias,
                const void* mask, void* out, void* out32, void* lse, int W,
                int H, int N, int nW, float scale, cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows, H, W);
  window_attn_fwd_bf16_kernel<D><<<grid, kThreads, fwd_bf16_smem<D>(),
                                   stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(out32), static_cast<float*>(lse), H, N, nW, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int blocks_per_sm_bf16() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, window_attn_fwd_bf16_kernel<D>, kThreads, fwd_bf16_smem<D>()) !=
      cudaSuccess)
    return -1;
  return n;
}

template <int D>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(window_attn_fwd_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(fwd_smem<D>()));
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* mask, void* out, void* lse, int W, int H, int N,
           int nW, float scale, cudaStream_t stream) {
  const cudaError_t err = set_smem<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, H, W);
  window_attn_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out),
      static_cast<float*>(lse), H, N, nW, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int blocks_per_sm() {
  int n = 0;
  if (set_smem<D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, window_attn_fwd_kernel<D>, kThreads, fwd_smem<D>()) !=
          cudaSuccess)
    return -1;
  return n;
}

// f(std::integral_constant<int, D>()) for the head_dims the kernel is
// built for (multiples of 4 up to 32); `otherwise` for any other
template <typename F>
long long with_head_dim(int D, F f, long long otherwise) {
  switch (D) {
#define WINDOW_ATTN_CASE(DIM) \
    case DIM:                 \
      return f(std::integral_constant<int, DIM>());
    WINDOW_ATTN_CASE(4)
    WINDOW_ATTN_CASE(8)
    WINDOW_ATTN_CASE(12)
    WINDOW_ATTN_CASE(16)
    WINDOW_ATTN_CASE(20)
    WINDOW_ATTN_CASE(24)
    WINDOW_ATTN_CASE(28)
    WINDOW_ATTN_CASE(32)
#undef WINDOW_ATTN_CASE
    default:
      return otherwise;
  }
}

}  // namespace

extern "C" {

// Blocks that fit one SM at head_dim D (registers, threads and shared
// memory) with float32 I/O, or -1 on a CUDA error or a head_dim the kernel
// is not built for.
int window_attn_blocks_per_sm(int D) {
  return static_cast<int>(with_head_dim(
      D,
      [](auto d) {
        return (long long)blocks_per_sm<decltype(d)::value>();
      },
      -1));
}

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// q, k, v and out are float32. `mask` may be null (then nW is not read).
// `lse` may be null; otherwise it receives each row's log-sum-exp
// [W, H, N], which the backward (window_attn_bwd.cu) reads. D is a
// multiple of 4 up to 32; any other head_dim returns cudaErrorInvalidValue.
int window_attn_launch(const void* q, const void* k, const void* v,
                       const void* bias, const void* mask, void* out,
                       void* lse, int W, int H, int N, int D, int nW,
                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_head_dim(
      D,
      [&](auto d) {
        return static_cast<long long>(launch<decltype(d)::value>(
            q, k, v, bias, mask, out, lse, W, H, N, nW, scale, s));
      },
      cudaErrorInvalidValue));
}

// The same with q, k, v and out bfloat16 (bias, mask and lse float32);
// `out32` may be null, else it receives the output in float32 too (the
// backward's delta reads it).
int window_attn_bf16_launch(const void* q, const void* k, const void* v,
                            const void* bias, const void* mask, void* out,
                            void* out32, void* lse, int W, int H, int N,
                            int D, int nW, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_head_dim(
      D,
      [&](auto d) {
        return static_cast<long long>(launch_bf16<decltype(d)::value>(
            q, k, v, bias, mask, out, out32, lse, W, H, N, nW, scale, s));
      },
      cudaErrorInvalidValue));
}

// Blocks of the bf16 kernel that fit one SM at head_dim D, or -1 as above.
int window_attn_bf16_blocks_per_sm(int D) {
  return static_cast<int>(with_head_dim(
      D,
      [](auto d) {
        return (long long)blocks_per_sm_bf16<decltype(d)::value>();
      },
      -1));
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
