// (Shifted-)window attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_pallas_attention_bwd` in
// dl_swin_gan_tpu/kernels/window_attn.py (body `_bwd_kernel`), which the
// custom VJP `_window_attention_pallas` ties to the forward. For every
// window w and head h, with g the cotangent of the forward's output:
//
//     s     = (q[w,h] * scale) k[w,h]^T + bias[h] (+ mask[w % nW])
//     p     = exp(s - lse)             lse: the forward's row log-sum-exp
//     dv    = p^T g
//     dp    = g v^T
//     ds    = p o (dp - delta)         delta = rowsum(g o out) = rowsum(dp o p)
//     dq    = ds k * scale,  dk = ds^T q * scale
//     dbias = sum over w of ds; the mask gets no gradient
//
// Layout, all contiguous:
//   q, k, v, g, dq, dk, dv  [W, H, N, D]   D % 4 == 0, D <= 32, any N;
//                                          float32 (window_attn_bwd_launch)
//                                          or bfloat16 (..._bf16_launch)
//   out                     [W, H, N, D]   float32: the forward's output,
//                                          for bf16 its out32
//   bias, dbias             [H, N, N]      float32
//   mask                    [nW, N, N]     float32, or null
//   lse                     [W, H, N]      float32, from window_attn.cu
//
// bfloat16 is the Pallas kernel's bf16 contract: q, k, v and g are widened
// to float32 exactly, every product and sum is taken in float32, and dq, dk
// and dv round to bf16 only when they are stored; ds and dbias stay
// float32. delta reads the forward's float32 output (window_attn.cu's
// out32), so it is float32-exact as the Pallas backward's rowsum(dp o p)
// is. The bf16 path has its own kernels and design: see "The bf16 path"
// below.
//
// Arithmetic, float32: every product runs on the tensor cores as 3xTF32
// (`mma.sync.m16n8k8` with TF32 operands). Each float32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), and a product accumulates
// a_hi b_lo + a_lo b_hi, then a_hi b_hi, in float32: about as accurate as
// float32 FMA (errors against float64 of 4e-7 to 6e-7 where FMA gives 5e-7
// to 8e-7). Plain TF32 (a_hi b_hi alone) misses the 1e-4 limit by 6x to 10x,
// so it is not used anywhere. head_dim is zero-padded to a multiple of 8
// (20 -> 24) in shared memory; only the real D columns are stored.
//
// Bound: 10*W*H*N^2*D FLOP (s, dp, dv, dq, dk) against 4*(7*W*H*N*D +
// 2*H*N^2 + nW*N^2) bytes (q, k, v, g in, dq, dk, dv out, bias in, dbias
// out, the mask in). At the Swin denoiser's full width (N = 448, D = 20,
// H = 8, W = 12 per slice) that is 3.85 GFLOP against 47 MB: at 3xTF32 on
// the tensor cores (495 TFLOP/s of TF32 / 3) the operations bound it at
// 0.0234 ms per slice, ahead of the bytes (0.0139 ms at 3.35 TB/s).
//
// Design, float32. CUDA blocks run in no order, and dk/dv sum over query
// rows, dq over keys, dbias over windows, so no block can own all four, and
// float atomics would make the sums run in no fixed order. So ds [W, H, N, N]
// (77 MB per slice) goes through a scratch in device memory, written once
// and read twice, and every sum runs in a fixed order: two calls on the same
// inputs give bitwise-equal gradients. Three launches:
//   1. kv:    a block per (64-key tile, head, window) owns dk and dv and
//             writes its ds columns. Each warp keeps its 16 keys of k and v
//             as split mma operands and walks the query tiles, computing
//             s^T = k q^T and dp^T = v g^T, so p^T and ds^T come out of the
//             mma already as the A operand of dv += p^T g and dk += ds^T q.
//   2. dq:    a block per (64-row query tile, head, window) owns dq: it
//             streams 64 x 64 tiles of ds and 64 rows of k, dq += ds k.
//   3. dbias: a thread per (head, i, j) sums ds over the windows
//             w = 0 .. W-1 in order; it writes every element of dbias.
// The scratch costs 3 x 77 MB of traffic per slice (0.069 ms at 3.35 TB/s,
// more than the operations bound). Recomputing s and dp in the dq and dbias
// kernels instead (one owner per result, no scratch: 9 products, a floor of
// 0.042 ms) was built first and measured slower on the H100: its dq and
// dbias kernels, each rebuilding p and ds from four tiles, took longer than
// reading ds back (PERF.md, Findings). The kv pass is the one that computes.
//
// A C fragment of m16n8k8 holds columns 2t and 2t+1 of its rows; the A
// fragment wants columns t and t+4. So a ds or p tile is fed back as A with
// its 8 columns permuted (A's k = t is column 2t, k = t+4 is column 2t+1),
// and the B operand reads its rows in the same order: no shuffles, no
// transposes through shared memory. Tiles stream in with cp.async, double
// buffered: the raw float32 rows of tile i+1 arrive while tile i is in the
// mma loop; each staged tile is split once into hi and lo planes of
// [64][Dpad + 4] floats, a stride at which every fragment load is free of
// bank conflicts. delta = rowsum(g o out) is computed once per staged query
// tile. The bias and mask are read through L1 and L2 (6.4 and 9.6 MB at
// batch 1), as the forward reads them, a chunk of 16 queries ahead of their
// use. Keys past N get p = 0; query rows past N read zeros (and a clamped
// bias index) and store nothing.
//
// The bf16 path (window_attn_bwd_bf16_launch). Arithmetic: a product of
// two bf16 values is exact in float32, so s = q k^T and dp = g v^T (and
// their transposes) are one bf16 tensor-core product each
// (`mma.sync.m16n8k16` with bf16 operands and float32 accumulators, plus
// one m16n8k8 where head_dim 20 pads to 24; mma_bf16.cuh), the scale
// applied to s in float32. p and ds are float32: each is split into hi =
// bf16(x) and lo = bf16(x - hi), so dv = p^T g, dk = ds^T q scale and dq =
// ds k scale take two bf16 products each, which keep about 2^-17 of p and
// ds (hi alone, 2^-9, misses the 1e-4 limit; tests/test_torch_window_attn.py
// emulates both). ds and dbias stay float32.
//
// Bound: the seven [W, H, N, D] tensors in bf16 move half the bytes (35 MB
// per slice at full width: 0.0104 ms), ahead of the products at the bf16
// rate (0.0039 ms): the bytes bound it. The float32 design's [W, H, N, N]
// ds scratch (77 MB per slice, written once and read twice: 0.069 ms at
// 3.35 TB/s) is 6.7 times that whole bound, and with exact bf16 products
// recomputing s and dp costs one product each where 3xTF32 cost three. So
// the bf16 path keeps no such scratch: ds is recomputed where it is used,
// each result still has one owner and every sum a fixed order. Every pass
// reads the bias and mask through L2 (6.4 and 9.6 MB, read 77 MB each per
// slice by a pass that walks every (window, head)), and that traffic, not
// the products, is what the passes spend their time on; so the design
// walks them twice, not three times. Four launches:
//   1. delta: a thread per row, delta = rowsum(g o out32) into [W, H, N].
//   2. kv:    a block per (64-key tile, head, window) owns dk and dv, as in
//             float32: each warp holds its 16 keys of k and v as bf16 A
//             fragments and walks the query tiles (q and g staged raw,
//             bf16, read by ldmatrix), s^T and dp^T on the mma, p^T and
//             ds^T straight from their C fragments (two adjacent n-tiles
//             are one k16 A operand), dv += p^T g, dk += ds^T q with g and
//             q by ldmatrix.trans.
//   3. dbias: a block per (head, 64 x 64 tile) walks the windows w = 0 ..
//             W-1 in order, its q, g, k and v tiles, lse and delta rows and
//             mask tile staged a window ahead; each warp owns 16 rows and
//             the tile's 64 keys, holds their bias in registers, recomputes
//             ds and sums it over the windows in registers. The same ds
//             times the K tile is that window's dq over the tile's keys:
//             stored to a float32 partial [key tile, W, H, N, D] (24 MB per
//             slice, a third of ds), so dq needs no pass of its own.
//   4. dq:    a thread per two elements sums the partials over the key
//             tiles in order and rounds dq to bf16.
// In every pass keys past N get p = 0 (so ds = 0 there), and query rows
// past N store nothing.
// The same exact products with the float32 design's ds scratch kept were
// measured against this in one call: this is the faster at every Swin
// point, the slower at SwinDiff's 4 heads, whose 144 dbias blocks fill
// about one wave (PERF.md, Findings).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tiles.cuh"  // Dims, tiles and fragments, kTile
#include "mma_bf16.cuh"    // Bf16Dims, bf16 tiles, mma_dims, mma_split
#include "mma_tf32.cuh"    // AFrag, BFrag, split, mma, mma3

namespace {

constexpr int kThreads = 128;              // 4 warps, 16 rows of a tile each
constexpr int kChunk = 16;                 // columns of s a warp holds at once
constexpr int kChunkTiles = kChunk / 8;    // n-tiles of m16n8k8 per chunk
constexpr int kReduceThreads = 256;        // the dbias sum
constexpr int kDsStride = kTile + 8;       // floats per staged row of ds

// blocks per SM the registers must allow: 3 cap a thread at 168 registers,
// which the kv pass's split fragments outgrow (spill) from head_dim 24 on
constexpr int min_blocks(int D) { return D <= 20 ? 3 : 2; }

// the [64, 64] tile at (i0, j0) of x [N, N] into dst [64][kDsStride], zero
// outside x; 16-byte copies where N % 4 == 0 keeps them aligned
__device__ __forceinline__ void stage_square(float* dst, const float* x,
                                             int i0, int j0, int N,
                                             int tid = threadIdx.x) {
  if (N % 4 == 0) {
    for (int e = tid; e < kTile * kTile / 4; e += kThreads) {
      const int r = e / (kTile / 4), c = 4 * (e % (kTile / 4));
      const bool ok = i0 + r < N && j0 + c < N;
      cp_async16(dst + r * kDsStride + c,
                 ok ? x + (long long)(i0 + r) * N + j0 + c : x, ok);
    }
  } else {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const bool ok = i0 + r < N && j0 + c < N;
      cp_async4(dst + r * kDsStride + c,
                ok ? x + (long long)(i0 + r) * N + j0 + c : x, ok);
    }
  }
}

// one stage of the kv kernel (raw q, g and out, then lse) and of the dq
// kernel (raw k, then a tile of ds), in floats; each is a multiple of 16
// bytes for every D % 4 == 0, so every part of the next stage stays aligned
template <int D>
struct Stages {
  static constexpr int kKv = 3 * Dims<D>::kRaw + kTile;
  static constexpr int kDq = Dims<D>::kRaw + kTile * kDsStride;
};

// x[i0 .. i0+63] into dst [64], zero past N-1
__device__ __forceinline__ void stage_row_values(float* dst, const float* x,
                                                 int i0, int N,
                                                 int tid = threadIdx.x) {
  for (int r = tid; r < kTile; r += kThreads) {
    const bool ok = i0 + r < N;
    cp_async4(dst + r, ok ? x + i0 + r : x, ok);
  }
}

// delta = rowsum(g o out) of a staged tile's rows, in a fixed order
template <int D>
__device__ __forceinline__ void tile_delta(float* delta, const float* g,
                                           const float* out) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c)
      d = fmaf(g[r * D + c], out[r * D + c], d);
    delta[r] = d;
  }
}

// bias plus mask (none: bias alone) at the elements of a warp's chunk of
// s^T: keys j0 + g and j0 + g + 8, queries i0 + 8 n + 2t and + 1; indices
// clamped into [N, N]
__device__ __forceinline__ void load_bias_t(float bm[kChunkTiles][4],
                                            const float* bias,
                                            const float* mask, int i0, int j0,
                                            int g, int t, int N) {
#pragma unroll
  for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long x =
          (long long)min(i0 + 8 * n + 2 * t + (e & 1), N - 1) * N +
          min(j0 + g + 8 * (e >> 1), N - 1);
      bm[n][e] = __ldg(bias + x) + (mask ? __ldg(mask + x) : 0.f);
    }
}

// dk, dv and ds of one (64-key tile, head, window); see the note at the top
template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
attn_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias,
                   const float* __restrict__ mask,
                   const float* __restrict__ g, const float* __restrict__ out,
                   const float* __restrict__ lse, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ ds, int H,
                   int N, int nW, float scale) {
  using C = Dims<D>;
  constexpr int kStage = Stages<D>::kKv;   // raw q, g, out; lse
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);
  uint32_t* qs = reinterpret_cast<uint32_t*>(raw + 2 * kStage);   // q * scale
  uint32_t* gs = qs + 2 * C::kPlane;
  float* delta = reinterpret_cast<float*>(gs + 2 * C::kPlane);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tc = lane % 4;   // the mma's group, thread in group
  const int h = blockIdx.y, w = blockIdx.z;
  const long long rows = ((long long)w * H + h) * N;   // row 0 of (w, h)
  const float* bh = bias + (long long)h * N * N;
  const float* mw = mask ? mask + (long long)(w % nW) * N * N : nullptr;
  const int j0 = blockIdx.x * kTile + 16 * warp;       // this warp's keys

  AFrag kf[C::kSteps], vf[C::kSteps];
  load_a_global<D>(kf, k + rows * D, j0, N, 1.f, gr, tc);
  load_a_global<D>(vf, v + rows * D, j0, N, 1.f, gr, tc);
  float dkc[C::kSteps][4] = {}, dvc[C::kSteps][4] = {};
  // bias plus mask of the next chunk, loaded a chunk ahead of its use
  float nb[kChunkTiles][4];
  load_bias_t(nb, bh, mw, 0, j0, gr, tc, N);

  const int tiles = (N + kTile - 1) / kTile;
  auto prefetch = [&](int it) {
    float* st = raw + (it & 1) * kStage;
    float* so = st + 2 * C::kRaw;
    stage_raw<D, kThreads>(st, q + rows * D, it * kTile, N);
    stage_raw<D, kThreads>(st + C::kRaw, g + rows * D, it * kTile, N);
    stage_raw<D, kThreads>(so, out + rows * D, it * kTile, N);
    stage_row_values(so + C::kRaw, lse + rows, it * kTile, N);
  };
  prefetch(0);
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    __syncthreads();                 // every warp is done with tile it - 1
    if (it + 1 < tiles) prefetch(it + 1);
    cp_async_commit();
    cp_async_wait_one();             // tile it has landed
    __syncthreads();
    const float* st = raw + (it & 1) * kStage;
    const float* so = st + 2 * C::kRaw;
    const float* ls = so + C::kRaw;
    split_tile<D, kThreads>(qs, st, scale);
    split_tile<D, kThreads>(gs, st + C::kRaw, 1.f);
    tile_delta<D>(delta, st + C::kRaw, so);
    __syncthreads();

    const int i0 = it * kTile;
#pragma unroll 1
    for (int c = 0; c < kTile; c += kChunk) {
      // s^T and dp^T: rows are this warp's keys, columns the chunk's queries
      float bm[kChunkTiles][4];
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) bm[n][e] = nb[n][e];
      load_bias_t(nb, bh, mw, i0 + c + kChunk, j0, gr, tc, N);
      float sc[kChunkTiles][4] = {}, dp[kChunkTiles][4] = {};
#pragma unroll
      for (int ks = 0; ks < C::kSteps; ++ks)
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
          mma3(sc[n], kf[ks], load_b_rows<D>(qs, c + 8 * n, ks, gr, tc));
          mma3(dp[n], vf[ks], load_b_rows<D>(gs, c + 8 * n, ks, gr, tc));
        }
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = c + 8 * n + 2 * tc + (e & 1);   // query in the tile
          const int i = i0 + il;
          const int j = j0 + gr + 8 * (e >> 1);
          const float p = i < N ? __expf(sc[n][e] + bm[n][e] - ls[il]) : 0.f;
          sc[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta[il]);
          if (i < N && j < N) ds[(rows + i) * N + j] = dp[n][e];
        }
      // dv += p^T g and dk += ds^T (q * scale) over the chunk's queries
#pragma unroll
      for (int kk = 0; kk < kChunkTiles; ++kk) {
        const AFrag pa = a_from_c(sc[kk]);
        const AFrag da = a_from_c(dp[kk]);
#pragma unroll
        for (int nd = 0; nd < C::kSteps; ++nd) {
          mma3(dvc[nd], pa, load_b_perm<D>(gs, c + 8 * kk, nd, gr, tc));
          mma3(dkc[nd], da, load_b_perm<D>(qs, c + 8 * kk, nd, gr, tc));
        }
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < C::kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + gr + 8 * (e >> 1);
      const int d = 8 * nd + 2 * tc + (e & 1);
      if (j < N && d < D) {
        store1(dk + (rows + j) * D + d, dkc[nd][e]);
        store1(dv + (rows + j) * D + d, dvc[nd][e]);
      }
    }
}

// dq = ds k * scale of one (64-row query tile, head, window), ds read back
// from the kv pass's scratch
template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
attn_bwd_dq_kernel(const float* __restrict__ ds, const float* __restrict__ k,
                   float* __restrict__ dq, int H, int N, float scale) {
  using C = Dims<D>;
  constexpr int kStage = Stages<D>::kDq;   // raw k; a [64][kDsStride] ds
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);
  uint32_t* kpl = reinterpret_cast<uint32_t*>(raw + 2 * kStage);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tc = lane % 4;
  const int h = blockIdx.y, w = blockIdx.z;
  const long long rows = ((long long)w * H + h) * N;
  const int i0 = blockIdx.x * kTile;
  const int r0 = 16 * warp;                      // this warp's rows in the tile
  const float* dsw = ds + rows * N;              // ds [N, N] of (w, h)
  float dqc[C::kSteps][4] = {};

  const int tiles = (N + kTile - 1) / kTile;
  auto prefetch = [&](int jt) {
    float* st = raw + (jt & 1) * kStage;
    stage_raw<D, kThreads>(st, k + rows * D, jt * kTile, N);
    stage_square(st + C::kRaw, dsw, i0, jt * kTile, N);
  };
  prefetch(0);
  cp_async_commit();
  for (int jt = 0; jt < tiles; ++jt) {
    __syncthreads();
    if (jt + 1 < tiles) prefetch(jt + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* st = raw + (jt & 1) * kStage;
    split_tile<D, kThreads>(kpl, st, 1.f);
    __syncthreads();

    // A = ds with its 8 columns in the C fragment's order (k = t is column
    // 2t, k = t+4 column 2t+1), so B reads k's rows as load_b_perm does
    const float* dst = st + C::kRaw + (r0 + gr) * kDsStride + 2 * tc;
#pragma unroll 2
    for (int kk = 0; kk < kTile / 8; ++kk) {
      const float2 top = *reinterpret_cast<const float2*>(dst + 8 * kk);
      const float2 bot =
          *reinterpret_cast<const float2*>(dst + 8 * kDsStride + 8 * kk);
      const float c[4] = {top.x, top.y, bot.x, bot.y};
      const AFrag da = a_from_c(c);
#pragma unroll
      for (int nd = 0; nd < C::kSteps; ++nd)
        mma3(dqc[nd], da, load_b_perm<D>(kpl, 8 * kk, nd, gr, tc));
    }
  }

#pragma unroll
  for (int nd = 0; nd < C::kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + r0 + gr + 8 * (e >> 1);
      const int d = 8 * nd + 2 * tc + (e & 1);
      if (i < N && d < D) store1(dq + (rows + i) * D + d, dqc[nd][e] * scale);
    }
}

// dbias = the sum of ds over the windows, in order w = 0 .. W-1, one
// thread per (head, i, j): the reads of a warp are 32 consecutive floats
__global__ void __launch_bounds__(kReduceThreads)
attn_bwd_dbias_kernel(const float* __restrict__ ds, float* __restrict__ dbias,
                      int W, int H, long long NN) {
  const long long e = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= H * NN) return;
  const long long h = e / NN;
  const long long ij = e % NN;
  float acc = 0.f;
  for (int w = 0; w < W; ++w) acc += ds[((long long)w * H + h) * NN + ij];
  dbias[e] = acc;
}

// ------------------------------------------------------------ the bf16 path
//
// Exact bf16 products on m16n8k16 (mma_bf16.cuh), tiles staged as they are,
// and no [W, H, N, N] scratch: four launches, each result with one owner
// and every sum in a fixed order (see the note at the top).

constexpr int kRowThreads = 256;   // the delta and dq sums: a thread a row

// bytes of one pipeline stage of each bf16 pass
template <int D>
struct Bf16Stages {
  static constexpr int kTileBytes = 2 * Bf16Dims<D>::kTileElems;
  static constexpr int kRows = 4 * kTile;                    // 64 floats
  static constexpr int kKv = 2 * kTileBytes + 2 * kRows;     // q, g; lse, delta
  // q, g, k, v; lse, delta; the mask tile
  static constexpr int kDbias = 4 * kTileBytes + 2 * kRows
                                + 4 * kTile * kDsStride;
};

// delta = rowsum(g o out) of every row of [W * H * N], out the forward's
// float32 output, in a fixed order
template <int D>
__global__ void __launch_bounds__(kRowThreads)
attn_bwd_delta_kernel(const bf16* __restrict__ g, const float* __restrict__ out,
                      float* __restrict__ delta, long long rows) {
  const long long r = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= rows) return;
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c)
    d = fmaf(__bfloat162float(g[r * D + c]), out[r * D + c], d);
  delta[r] = d;
}

// dk and dv of one (64-key tile, head, window): each warp keeps its 16 keys
// of k and v as bf16 A fragments and walks the query tiles, s^T = k q^T and
// dp^T = v g^T exact, p^T = exp(s^T scale + bias - lse), ds^T = p^T o (dp^T -
// delta); dv += p^T g and dk += ds^T q with p^T and ds^T split, straight
// from their C fragments.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
attn_bwd_kv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int N, int nW,
                        float scale) {
  using C = Bf16Dims<D>;
  using S = Bf16Stages<D>;
  constexpr int CB = C::kBlocks;
  extern __shared__ float4 smem4[];
  char* stg = reinterpret_cast<char*>(smem4);
  auto tile = [&](int st, int i) {   // 0: q, 1: g
    return reinterpret_cast<bf16*>(stg + st * S::kKv + i * S::kTileBytes);
  };
  auto row_values = [&](int st, int i) {   // 0: lse, 1: delta
    return reinterpret_cast<float*>(stg + st * S::kKv + 2 * S::kTileBytes +
                                    i * S::kRows);
  };
  for (int st = 0; st < 2; ++st) {
    pad_tile<D, kThreads>(tile(st, 0));
    pad_tile<D, kThreads>(tile(st, 1));
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tc = lane % 4;   // the mma's group, thread in group
  const int h = blockIdx.y, w = blockIdx.z;
  const long long rows = ((long long)w * H + h) * N;   // row 0 of (w, h)
  const float* bh = bias + (long long)h * N * N;
  const float* mw = mask ? mask + (long long)(w % nW) * N * N : nullptr;
  const int j0 = blockIdx.x * kTile + 16 * warp;       // this warp's keys

  uint32_t ka[CB][2], va[CB][2];
  a_global_bf16<D>(ka, k + rows * D, j0, N, gr, tc);
  a_global_bf16<D>(va, v + rows * D, j0, N, gr, tc);
  float dkc[CB][4] = {}, dvc[CB][4] = {};
  float nb[kChunkTiles][4];   // bias plus mask of the next chunk
  load_bias_t(nb, bh, mw, 0, j0, gr, tc, N);

  const int tiles = (N + kTile - 1) / kTile;
  auto prefetch = [&](int it) {
    const int st = it & 1;
    stage_bf16<D, kThreads>(tile(st, 0), q + rows * D, it * kTile, N);
    stage_bf16<D, kThreads>(tile(st, 1), g + rows * D, it * kTile, N);
    stage_row_values(row_values(st, 0), lse + rows, it * kTile, N);
    stage_row_values(row_values(st, 1), delta + rows, it * kTile, N);
  };
  prefetch(0);
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    __syncthreads();                 // every warp is done with tile it - 1
    if (it + 1 < tiles) prefetch(it + 1);
    cp_async_commit();
    cp_async_wait_one();             // tile it has landed
    __syncthreads();
    const int st = it & 1;
    const bf16* qt = tile(st, 0);
    const bf16* gt = tile(st, 1);
    const float* ls = row_values(st, 0);
    const float* dl = row_values(st, 1);

    const int i0 = it * kTile;
#pragma unroll 1
    for (int c = 0; c < kTile; c += kChunk) {
      float bm[kChunkTiles][4];
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) bm[n][e] = nb[n][e];
      load_bias_t(nb, bh, mw, i0 + c + kChunk, j0, gr, tc, N);
      uint32_t qb[kChunkTiles][CB], gb[kChunkTiles][CB];
      b_rows_bf16<D>(qb, qt, c, lane);
      b_rows_bf16<D>(gb, gt, c, lane);
      float sc[kChunkTiles][4] = {}, dp[kChunkTiles][4] = {};
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n) {
        mma_dims<CB>(sc[n], ka, qb[n]);
        mma_dims<CB>(dp[n], va, gb[n]);
      }
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = c + 8 * n + 2 * tc + (e & 1);   // query in the tile
          const int i = i0 + il;
          const float p =
              i < N ? __expf(fmaf(sc[n][e], scale, bm[n][e]) - ls[il]) : 0.f;
          sc[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl[il]);
        }
      // dv += p^T g and dk += ds^T q over the chunk's queries
      uint32_t gv[CB][2], qv[CB][2];
      b_trans_bf16<D>(gv, gt, c, lane);
      b_trans_bf16<D>(qv, qt, c, lane);
      uint32_t ph[4], pl[4], dh[4], dlo[4];
      a_from_c2(sc[0], sc[1], ph, pl);
      a_from_c2(dp[0], dp[1], dh, dlo);
#pragma unroll
      for (int nd = 0; nd < CB; ++nd) {
        mma_split(dvc[nd], ph, pl, gv[nd]);
        mma_split(dkc[nd], dh, dlo, qv[nd]);
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < CB; ++nd)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + gr + 8 * r;
      const int d = 8 * nd + 2 * tc;   // even, and D % 4 == 0: d + 1 < D
      if (j < N && d < D) {
        store2(dk + (rows + j) * D + d, dkc[nd][2 * r] * scale,
               dkc[nd][2 * r + 1] * scale);
        store2(dv + (rows + j) * D + d, dvc[nd][2 * r], dvc[nd][2 * r + 1]);
      }
    }
}

// dbias of one (head, 64 x 64 tile) and the tile's share of dq: the
// windows w = 0 .. W-1 in order, each window's q, g, k and v tiles, lse and
// delta rows and mask tile staged (the next window's arriving meanwhile),
// ds of the tile recomputed and summed over the windows in registers. Each
// warp owns 16 rows and the tile's 64 keys, its bias held in registers
// across the windows; per window its ds times the K tile is that window's
// dq over these keys, stored to dq_part[key tile] (attn_bwd_dq_sum_kernel
// sums the key tiles in order). 3 blocks per SM up to head_dim 20 (a
// slice's 392 blocks in one wave at N = 448), 2 for the wider heads, whose
// fragments outgrow 168 registers (min_blocks).
template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
attn_bwd_dbias_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const bf16* __restrict__ g,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dbias,
                           float* __restrict__ dq_part, int W, int H, int N,
                           int nW, float scale) {
  using C = Bf16Dims<D>;
  using S = Bf16Stages<D>;
  constexpr int CB = C::kBlocks;
  constexpr int kKeyTiles = kTile / 8;
  extern __shared__ float4 smem4[];
  char* stg = reinterpret_cast<char*>(smem4);
  auto tile = [&](int st, int i) {   // 0: q, 1: g, 2: k, 3: v
    return reinterpret_cast<bf16*>(stg + st * S::kDbias + i * S::kTileBytes);
  };
  auto row_values = [&](int st, int i) {   // 0: lse, 1: delta
    return reinterpret_cast<float*>(stg + st * S::kDbias + 4 * S::kTileBytes +
                                    i * S::kRows);
  };
  auto mask_tile = [&](int st) {   // [64][kDsStride]
    return reinterpret_cast<float*>(stg + st * S::kDbias + 4 * S::kTileBytes +
                                    2 * S::kRows);
  };
  for (int st = 0; st < 2; ++st)
    for (int i = 0; i < 4; ++i) pad_tile<D, kThreads>(tile(st, i));

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tc = lane % 4;
  const int tiles = (N + kTile - 1) / kTile;
  const int it = blockIdx.x / tiles, jt = blockIdx.x % tiles;
  const int i0 = it * kTile, j0 = jt * kTile;
  const int h = blockIdx.y;
  const int r0 = 16 * warp;              // this warp's rows in the tile
  float bb[kKeyTiles][4];                // bias at the warp's elements
  load_bias_rows<kKeyTiles>(bb, bias + (long long)h * N * N,
                            bias_row_offset(i0 + r0 + gr, tc, N),
                            bias_row_offset(i0 + r0 + gr + 8, tc, N), j0, tc,
                            N);
  // keys past N get p = 0 (their k rows are zero, so s = 0 there): a bias
  // of -inf, set once here, costs the window loop no register
#pragma unroll
  for (int x = 0; x < kKeyTiles; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + 8 * x + 2 * tc + (e & 1) >= N) bb[x][e] = -CUDART_INF_F;
  float db[kKeyTiles][4] = {};
  float* part = dq_part + (long long)jt * W * H * N * D;

  auto prefetch = [&](int w) {
    // the thread's index laundered, so that the copies' offsets are worked
    // out again each window rather than held in registers across them
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const int st = w & 1;
    const long long rows = ((long long)w * H + h) * N;
    stage_bf16<D, kThreads>(tile(st, 0), q + rows * D, i0, N, tid);
    stage_bf16<D, kThreads>(tile(st, 1), g + rows * D, i0, N, tid);
    stage_bf16<D, kThreads>(tile(st, 2), k + rows * D, j0, N, tid);
    stage_bf16<D, kThreads>(tile(st, 3), v + rows * D, j0, N, tid);
    stage_row_values(row_values(st, 0), lse + rows, i0, N, tid);
    stage_row_values(row_values(st, 1), delta + rows, i0, N, tid);
    if (mask)
      stage_square(mask_tile(st), mask + (long long)(w % nW) * N * N, i0, j0,
                   N, tid);
  };
  prefetch(0);
  cp_async_commit();
  for (int w = 0; w < W; ++w) {
    __syncthreads();                 // every warp is done with window w - 1
    if (w + 1 < W) prefetch(w + 1);
    cp_async_commit();
    cp_async_wait_one();             // window w has landed
    __syncthreads();
    const int st = w & 1;
    const float* ls = row_values(st, 0) + r0 + gr;
    const float* dl = row_values(st, 1) + r0 + gr;
    // the mask at the warp's elements: rows r0 + g (+ 8), columns 2t
    const float* mt = mask_tile(st) + (r0 + gr) * kDsStride + 2 * tc;
    uint32_t qa[CB][2], ga[CB][2];
    a_rows_bf16<D>(qa, tile(st, 0), r0, lane);
    a_rows_bf16<D>(ga, tile(st, 1), r0, lane);
    float dqc[CB][4] = {};
#pragma unroll
    for (int c = 0; c < kTile; c += kChunk) {
      uint32_t kb[kChunkTiles][CB], vb[kChunkTiles][CB];
      b_rows_bf16<D>(kb, tile(st, 2), c, lane);
      b_rows_bf16<D>(vb, tile(st, 3), c, lane);
      float sc[kChunkTiles][4] = {}, dp[kChunkTiles][4] = {};
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n) {
        mma_dims<CB>(sc[n], qa, kb[n]);
        mma_dims<CB>(dp[n], ga, vb[n]);
      }
#pragma unroll
      for (int n = 0; n < kChunkTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = c / 8 + n, r8 = 8 * (e >> 1);
          const float m = mask ? mt[r8 * kDsStride + 8 * x + (e & 1)] : 0.f;
          const float p =
              __expf((fmaf(sc[n][e], scale, bb[x][e]) + m) - ls[r8]);
          sc[n][e] = p * (dp[n][e] - dl[r8]);   // ds
          db[x][e] += sc[n][e];
        }
      // dq over the chunk's keys: ds k
      uint32_t kv[CB][2];
      b_trans_bf16<D>(kv, tile(st, 2), c, lane);
      uint32_t dh[4], dlo[4];
      a_from_c2(sc[0], sc[1], dh, dlo);
#pragma unroll
      for (int nd = 0; nd < CB; ++nd) mma_split(dqc[nd], dh, dlo, kv[nd]);
    }
    float* pw = part + ((long long)w * H + h) * N * D;
#pragma unroll
    for (int nd = 0; nd < CB; ++nd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r0 + gr + 8 * r;
        const int d = 8 * nd + 2 * tc;   // even, and D % 4 == 0: d + 1 < D
        if (i < N && d < D)
          *reinterpret_cast<float2*>(pw + (long long)i * D + d) =
              make_float2(dqc[nd][2 * r], dqc[nd][2 * r + 1]);
      }
  }

  float* dbh = dbias + (long long)h * N * N;
#pragma unroll
  for (int x = 0; x < kKeyTiles; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + r0 + gr + 8 * (e >> 1);
      const int j = j0 + 8 * x + 2 * tc + (e & 1);
      if (i < N && j < N) dbh[(long long)i * N + j] = db[x][e];
    }
}

// dq = scale times the sum of dq_part [tiles][n] over the key tiles in
// order, two elements a thread (n = W * H * N * D, even)
__global__ void __launch_bounds__(kRowThreads)
attn_bwd_dq_sum_kernel(const float* __restrict__ dq_part,
                       bf16* __restrict__ dq, long long n, int tiles,
                       float scale) {
  const long long e = 2 * ((long long)blockIdx.x * kRowThreads + threadIdx.x);
  if (e >= n) return;
  float a = 0.f, b = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float2 x =
        __ldg(reinterpret_cast<const float2*>(dq_part + t * n + e));
    a += x.x;
    b += x.y;
  }
  store2(dq + e, a * scale, b * scale);
}

// dynamic shared memory of each kernel, in bytes
template <int D>
constexpr size_t kv_smem() {
  using C = Dims<D>;
  return sizeof(float) * (2 * Stages<D>::kKv + 4 * C::kPlane + kTile);
}
template <int D>
constexpr size_t dq_smem() {
  using C = Dims<D>;
  return sizeof(float) * (2 * Stages<D>::kDq + 2 * C::kPlane);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* mask, const float* g, const float* out,
           const float* lse, float* ds, float* dq, float* dk, float* dv,
           float* dbias, int W, int H, int N, int nW, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem<D>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + kTile - 1) / kTile;
  attn_bwd_kv_kernel<D><<<dim3(tiles, H, W), kThreads, kv_smem<D>(),
                          stream>>>(q, k, v, bias, mask, g, out, lse, dk, dv,
                                    ds, H, N, nW, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D><<<dim3(tiles, H, W), kThreads, dq_smem<D>(),
                          stream>>>(ds, k, dq, H, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long NN = (long long)N * N;
  const long long blocks = (H * NN + kReduceThreads - 1) / kReduceThreads;
  attn_bwd_dbias_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                          stream>>>(ds, dbias, W, H, NN);
  return static_cast<int>(cudaGetLastError());
}

// floats of the bf16 path's work scratch: delta [W, H, N], then dq_part
// [tiles, W, H, N, D]
long long bf16_work_floats(int W, int H, int N, int D) {
  const long long rows = (long long)W * H * N;
  return rows + (long long)((N + kTile - 1) / kTile) * rows * D;
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const float* bias, const float* mask, const bf16* g,
                const float* out, const float* lse, float* work, bf16* dq,
                bf16* dk, bf16* dv, float* dbias, int W, int H, int N, int nW,
                float scale, cudaStream_t stream) {
  using S = Bf16Stages<D>;
  const int tiles = (N + kTile - 1) / kTile;
  const long long nrows = (long long)W * H * N;
  float* delta = work;
  attn_bwd_delta_kernel<D><<<static_cast<unsigned>(
                                 (nrows + kRowThreads - 1) / kRowThreads),
                             kRowThreads, 0, stream>>>(g, out, delta, nrows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kv_bf16_kernel<D><<<dim3(tiles, H, W), kThreads, 2 * S::kKv,
                               stream>>>(q, k, v, bias, mask, g, lse, delta,
                                         dk, dv, H, N, nW, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dq_part = work + nrows;
  err = cudaFuncSetAttribute(attn_bwd_dbias_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * S::kDbias);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dbias_bf16_kernel<D><<<dim3(tiles * tiles, H), kThreads,
                                  2 * S::kDbias, stream>>>(
      q, k, v, bias, mask, g, lse, delta, dbias, dq_part, W, H, N, nW, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = nrows * D;
  attn_bwd_dq_sum_kernel<<<static_cast<unsigned>(
                               (n / 2 + kRowThreads - 1) / kRowThreads),
                           kRowThreads, 0, stream>>>(dq_part, dq, n, tiles,
                                                     scale);
  return static_cast<int>(cudaGetLastError());
}

// blocks per SM of the bf16 launches, in order: 0 delta, 1 kv,
// 2 dbias (with dq's partial sums), 3 dq's sum; -1 on a CUDA error or
// another index
template <int D>
int blocks_per_sm_bf16(int pass) {
  using S = Bf16Stages<D>;
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (pass == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, attn_bwd_delta_kernel<D>, kRowThreads, 0);
  else if (pass == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, attn_bwd_kv_bf16_kernel<D>, kThreads, 2 * S::kKv);
  else if (pass == 2 &&
           (err = cudaFuncSetAttribute(
                attn_bwd_dbias_bf16_kernel<D>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                2 * S::kDbias)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, attn_bwd_dbias_bf16_kernel<D>, kThreads, 2 * S::kDbias);
  else if (pass == 3)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, attn_bwd_dq_sum_kernel, kRowThreads, 0);
  return err == cudaSuccess ? n : -1;
}

// f(std::integral_constant<int, D>()) for the head_dims the kernels are
// built for (multiples of 4 up to 32); `otherwise` for any other
template <typename F>
int with_head_dim(int D, F f, int otherwise) {
  switch (D) {
#define WINDOW_ATTN_BWD_DIM(DIM) \
    case DIM:                    \
      return f(std::integral_constant<int, DIM>());
    WINDOW_ATTN_BWD_DIM(4)
    WINDOW_ATTN_BWD_DIM(8)
    WINDOW_ATTN_BWD_DIM(12)
    WINDOW_ATTN_BWD_DIM(16)
    WINDOW_ATTN_BWD_DIM(20)
    WINDOW_ATTN_BWD_DIM(24)
    WINDOW_ATTN_BWD_DIM(28)
    WINDOW_ATTN_BWD_DIM(32)
#undef WINDOW_ATTN_BWD_DIM
    default:
      return otherwise;
  }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream`; returns the CUDA error code (0 =
// ok). q, k, v, g, out, dq, dk and dv are float32. `mask` may be null (then
// nW is not read). `ds` is scratch of W * H * N * N floats. D is a multiple
// of 4 up to 32; any other head_dim returns cudaErrorInvalidValue. Every
// element of dq, dk, dv and dbias is written.
int window_attn_bwd_launch(const void* q, const void* k, const void* v,
                           const void* bias, const void* mask, const void* g,
                           const void* out, const void* lse, void* ds,
                           void* dq, void* dk, void* dv, void* dbias, int W,
                           int H, int N, int D, int nW, float scale,
                           void* stream) {
  return with_head_dim(
      D,
      [&](auto d) {
        return launch<decltype(d)::value>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(bias),
            static_cast<const float*>(mask), static_cast<const float*>(g),
            static_cast<const float*>(out), static_cast<const float*>(lse),
            static_cast<float*>(ds), static_cast<float*>(dq),
            static_cast<float*>(dk), static_cast<float*>(dv),
            static_cast<float*>(dbias), W, H, N, nW, scale,
            static_cast<cudaStream_t>(stream));
      },
      static_cast<int>(cudaErrorInvalidValue));
}

// The bf16 path: q, k, v, g, dq, dk and dv bfloat16; `out` (the forward's
// out32), bias, mask, lse and dbias float32. `work` is scratch of
// window_attn_bwd_bf16_work(W, H, N, D) floats; no [W, H, N, N] scratch.
int window_attn_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                const void* bias, const void* mask,
                                const void* g, const void* out,
                                const void* lse, void* work, void* dq,
                                void* dk, void* dv, void* dbias, int W,
                                int H, int N, int D, int nW, float scale,
                                void* stream) {
  return with_head_dim(
      D,
      [&](auto d) {
        return launch_bf16<decltype(d)::value>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const float*>(bias),
            static_cast<const float*>(mask), static_cast<const bf16*>(g),
            static_cast<const float*>(out), static_cast<const float*>(lse),
            static_cast<float*>(work), static_cast<bf16*>(dq),
            static_cast<bf16*>(dk), static_cast<bf16*>(dv),
            static_cast<float*>(dbias), W, H, N, nW, scale,
            static_cast<cudaStream_t>(stream));
      },
      static_cast<int>(cudaErrorInvalidValue));
}

// Floats of the bf16 launch's `work` scratch: delta [W, H, N] and dq's
// partial sums over the key tiles [ceil(N / 64), W, H, N, D].
long long window_attn_bwd_bf16_work(int W, int H, int N, int D) {
  return bf16_work_floats(W, H, N, D);
}

// Blocks that fit one SM at head_dim D of the bf16 launch `pass` (0 delta,
// 1 kv, 2 dbias, 3 dq's sum), or -1.
int window_attn_bwd_bf16_blocks_per_sm(int D, int pass) {
  return with_head_dim(
      D, [&](auto d) { return blocks_per_sm_bf16<decltype(d)::value>(pass); },
      -1);
}

const char* window_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
