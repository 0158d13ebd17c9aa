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
// bfloat16 is the Pallas kernel's bf16 contract: q, k, v and g widen to
// float32 exactly where their tiles are staged or their fragments built,
// every product and sum is the float32 kernel's, and dq, dk and dv round
// to bf16 only when they are stored; ds and dbias stay float32. delta
// reads the forward's float32 output (window_attn.cu's out32), so it is
// float32-exact as the Pallas backward's rowsum(dp o p) is.
//
// Arithmetic: every product runs on the tensor cores as 3xTF32
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
// 0.0234 ms per slice, ahead of the bytes (0.0139 ms at 3.35 TB/s). With
// bf16 I/O the seven [W, H, N, D] tensors move half the bytes (35 MB:
// 0.0104 ms), ahead of the products at the bf16 rate (0.0039 ms); the
// kernel keeps 3xTF32 for them all the same.
//
// Design. CUDA blocks run in no order, and dk/dv sum over query rows, dq
// over keys, dbias over windows, so no block can own all four, and float
// atomics would make the sums run in no fixed order. So ds [W, H, N, N]
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tiles.cuh"  // Dims, tiles and fragments, kTile
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
// the kv pass with bf16 I/O at head_dim 20 needs 8 bytes more than 168
// registers a thread (ptxas, CUDA 12.8): 2 blocks per SM, no spill
template <typename T>
constexpr int kv_min_blocks(int D) {
  return sizeof(T) == 4 || D < 20 ? min_blocks(D) : 2;
}

// the [64, 64] tile at (i0, j0) of x [N, N] into dst [64][kDsStride], zero
// outside x; 16-byte copies where N % 4 == 0 keeps them aligned
__device__ __forceinline__ void stage_square(float* dst, const float* x,
                                             int i0, int j0, int N) {
  if (N % 4 == 0) {
    for (int e = threadIdx.x; e < kTile * kTile / 4; e += kThreads) {
      const int r = e / (kTile / 4), c = 4 * (e % (kTile / 4));
      const bool ok = i0 + r < N && j0 + c < N;
      cp_async16(dst + r * kDsStride + c,
                 ok ? x + (long long)(i0 + r) * N + j0 + c : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const bool ok = i0 + r < N && j0 + c < N;
      cp_async4(dst + r * kDsStride + c,
                ok ? x + (long long)(i0 + r) * N + j0 + c : x, ok);
    }
  }
}

// one stage of the kv kernel (raw q and g of T, then raw out and lse of
// float32) and of the dq kernel (raw k of T, then a tile of ds), in
// elements of T; each is a multiple of 16 bytes for every D % 4 == 0, so
// every part of the next stage stays aligned
template <int D, typename T>
struct Stages {
  static constexpr int kPerFloat = 4 / sizeof(T);   // T elements per float
  static constexpr int kKv = 2 * Dims<D>::kRaw
                             + (Dims<D>::kRaw + kTile) * kPerFloat;
  static constexpr int kDq = Dims<D>::kRaw + kTile * kDsStride * kPerFloat;
};

// x[i0 .. i0+63] into dst [64], zero past N-1
__device__ __forceinline__ void stage_row_values(float* dst, const float* x,
                                                 int i0, int N) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool ok = i0 + r < N;
    cp_async4(dst + r, ok ? x + i0 + r : x, ok);
  }
}

// delta = rowsum(g o out) of a staged tile's rows, in a fixed order
template <int D, typename T>
__device__ __forceinline__ void tile_delta(float* delta, const T* g,
                                           const float* out) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c)
      d = fmaf(to_f32(g[r * D + c]), out[r * D + c], d);
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
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, kv_min_blocks<T>(D))
attn_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ mask, const T* __restrict__ g,
                   const float* __restrict__ out,
                   const float* __restrict__ lse, T* __restrict__ dk,
                   T* __restrict__ dv, float* __restrict__ ds, int H, int N,
                   int nW, float scale) {
  using C = Dims<D>;
  constexpr int kStage = Stages<D, T>::kKv;   // raw q, g; out, lse
  extern __shared__ float4 smem4[];
  T* raw = reinterpret_cast<T*>(smem4);
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
    T* st = raw + (it & 1) * kStage;
    float* so = reinterpret_cast<float*>(st + 2 * C::kRaw);
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
    const T* st = raw + (it & 1) * kStage;
    const float* so = reinterpret_cast<const float*>(st + 2 * C::kRaw);
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
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
attn_bwd_dq_kernel(const float* __restrict__ ds, const T* __restrict__ k,
                   T* __restrict__ dq, int H, int N, float scale) {
  using C = Dims<D>;
  constexpr int kStage = Stages<D, T>::kDq;   // raw k; a [64][kDsStride] ds
  extern __shared__ float4 smem4[];
  T* raw = reinterpret_cast<T*>(smem4);
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
    T* st = raw + (jt & 1) * kStage;
    stage_raw<D, kThreads>(st, k + rows * D, jt * kTile, N);
    stage_square(reinterpret_cast<float*>(st + C::kRaw), dsw, i0,
                 jt * kTile, N);
  };
  prefetch(0);
  cp_async_commit();
  for (int jt = 0; jt < tiles; ++jt) {
    __syncthreads();
    if (jt + 1 < tiles) prefetch(jt + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* st = raw + (jt & 1) * kStage;
    split_tile<D, kThreads>(kpl, st, 1.f);
    __syncthreads();

    // A = ds with its 8 columns in the C fragment's order (k = t is column
    // 2t, k = t+4 column 2t+1), so B reads k's rows as load_b_perm does
    const float* dst = reinterpret_cast<const float*>(st + C::kRaw)
                       + (r0 + gr) * kDsStride + 2 * tc;
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

// dynamic shared memory of each kernel, in bytes
template <int D, typename T>
constexpr size_t kv_smem() {
  using C = Dims<D>;
  return sizeof(T) * 2 * Stages<D, T>::kKv
         + sizeof(float) * (4 * C::kPlane + kTile);
}
template <int D, typename T>
constexpr size_t dq_smem() {
  using C = Dims<D>;
  return sizeof(T) * 2 * Stages<D, T>::kDq + sizeof(float) * 2 * C::kPlane;
}

template <int D, typename T>
int launch(const T* q, const T* k, const T* v, const float* bias,
           const float* mask, const T* g, const float* out,
           const float* lse, float* ds, T* dq, T* dk, T* dv,
           float* dbias, int W, int H, int N, int nW, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem<D, T>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem<D, T>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + kTile - 1) / kTile;
  attn_bwd_kv_kernel<D, T><<<dim3(tiles, H, W), kThreads, kv_smem<D, T>(),
                             stream>>>(q, k, v, bias, mask, g, out, lse, dk,
                                       dv, ds, H, N, nW, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D, T><<<dim3(tiles, H, W), kThreads, dq_smem<D, T>(),
                             stream>>>(ds, k, dq, H, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long NN = (long long)N * N;
  const long long blocks = (H * NN + kReduceThreads - 1) / kReduceThreads;
  attn_bwd_dbias_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                          stream>>>(ds, dbias, W, H, NN);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* q, const void* k, const void* v, const void* bias,
               const void* mask, const void* g, const void* out,
               const void* lse, void* ds, void* dq, void* dk, void* dv,
               void* dbias, int W, int H, int N, int D, int nW, float scale,
               void* stream) {
  const auto* qf = static_cast<const T*>(q);
  const auto* kf = static_cast<const T*>(k);
  const auto* vf = static_cast<const T*>(v);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(mask);
  const auto* gf = static_cast<const T*>(g);
  const auto* of = static_cast<const float*>(out);
  const auto* lf = static_cast<const float*>(lse);
  auto* dsf = static_cast<float*>(ds);
  auto* dqf = static_cast<T*>(dq);
  auto* dkf = static_cast<T*>(dk);
  auto* dvf = static_cast<T*>(dv);
  auto* dbf = static_cast<float*>(dbias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define WINDOW_ATTN_BWD_CASE(DIM)                                          \
    case DIM:                                                              \
      return launch<DIM, T>(qf, kf, vf, bf, mf, gf, of, lf, dsf, dqf, dkf, \
                            dvf, dbf, W, H, N, nW, scale, s);
    WINDOW_ATTN_BWD_CASE(4)
    WINDOW_ATTN_BWD_CASE(8)
    WINDOW_ATTN_BWD_CASE(12)
    WINDOW_ATTN_BWD_CASE(16)
    WINDOW_ATTN_BWD_CASE(20)
    WINDOW_ATTN_BWD_CASE(24)
    WINDOW_ATTN_BWD_CASE(28)
    WINDOW_ATTN_BWD_CASE(32)
#undef WINDOW_ATTN_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
  return launch_any<float>(q, k, v, bias, mask, g, out, lse, ds, dq, dk, dv,
                           dbias, W, H, N, D, nW, scale, stream);
}

// The same with q, k, v, g, dq, dk and dv bfloat16; `out` (the forward's
// out32), bias, mask, lse, ds and dbias float32.
int window_attn_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                const void* bias, const void* mask,
                                const void* g, const void* out,
                                const void* lse, void* ds, void* dq, void* dk,
                                void* dv, void* dbias, int W, int H, int N,
                                int D, int nW, float scale, void* stream) {
  return launch_any<bf16>(q, k, v, bias, mask, g, out, lse, ds, dq, dk, dv,
                          dbias, W, H, N, D, nW, scale, stream);
}

const char* window_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
