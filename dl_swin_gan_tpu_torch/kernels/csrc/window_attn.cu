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
// Layout, all float32 and contiguous:
//   q, k, v, out  [W, H, N, D]    W = batch * windows, D % 4 == 0, D <= 32
//   bias          [H, N, N]       relative-position bias, gathered per head
//   mask          [nW, N, N]      0 / -100 shift mask, or null
//   lse           [W, H, N]       each row's log-sum-exp, or null; written
//                                 for the backward (window_attn_bwd.cu)
//
// Bound: 4*W*H*N^2*D FLOP (the two products) against about 4*(4*W*H*N*D +
// H*N^2 + nW*N^2) bytes. At the Swin denoiser's full width (N = 448,
// D = 20, H = 8, W = 12 per slice) that is 1.54 GFLOP against 30 MB: the
// float32 FMA rate (67 TFLOP/s without tensor cores) bounds it at about
// 0.023 ms per slice, ahead of the bytes (0.009 ms at 3.35 TB/s). All
// arithmetic is float32 FMA: no TF32.
//
// Design: the TPU grid is (H, W), one (window, head) per step with the whole
// [N, N] score matrix in VMEM; here that would give 96 blocks per slice for
// 132 SMs and a 0.8 MB matrix no SM can hold. Instead one block takes one
// (window, head) and a tile of 64 query rows (7 tiles at N = 448, 672
// blocks per slice), stages K and V of its (window, head) in shared memory
// (2 * 448 * 20 * 4 B = 72 KB, zero-padded to a multiple of 32 keys), and
// runs an online softmax over the keys, so no score leaves the registers.
// Each lane holds two query rows (pre-scaled) and their two accumulators in
// registers, so every K and V element it reads from shared memory feeds two
// rows. Four lanes share a row pair and split the keys: per step each takes
// a chunk of 8 consecutive keys, scores them, folds them into its running
// max, sum and accumulator, and at the end the four partial results are
// merged with warp shuffles. Staged keys carry 4 floats of padding after
// every chunk of 8, so the four lanes' loads start in different banks;
// lanes of the same split read the same address, which broadcasts. Bias and
// mask rows are read straight from global memory through the read-only
// cache: 16 MB at batch 1, they stay in the 50 MB L2. A lane issues the
// bias and mask loads of a chunk (on a clamped index, so unconditionally)
// before it scores the chunk, and their L2 latency overlaps the score FMAs;
// loaded after the scores, they stalled every chunk. Shared memory admits 3
// blocks per SM at N = 448, and the launch bound keeps the registers within
// what 3 blocks may hold. Tensor cores (a head_dim padded to 24 or 32 for
// `wgmma`), TMA staging and a larger tile per block are left for later
// work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kSplits = 4;                    // lanes that share a row pair
constexpr int kPairs = kThreads / kSplits;    // 32 row pairs
constexpr int kRows = 2 * kPairs;             // 64 query rows per block
constexpr int kChunk = 8;                     // keys a lane takes per step
constexpr int kRound = kSplits * kChunk;      // keys per step of the block
constexpr int kPad = 4;                       // floats after each chunk

// blocks per SM the registers must allow: 3 fit in shared memory at N = 448;
// at D = 20 that caps a thread at 170 registers, beyond which wider heads
// would spill
constexpr int min_blocks(int D) { return D <= 20 ? 3 : 2; }

__host__ __device__ inline int padded_keys(int N) {
  return (N + kRound - 1) / kRound * kRound;
}

// floats of one staged tensor (K or V)
__host__ __device__ inline int staged_floats(int N, int D) {
  const int npad = padded_keys(N);
  return npad * D + npad / kChunk * kPad;
}

// float offset of key j in a staged tensor
template <int D>
__device__ __forceinline__ int key_offset(int j) {
  return j * D + (j / kChunk) * kPad;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
  static_assert(D % 4 == 0 && D % kSplits == 0, "D must be a multiple of 4");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + staged_floats(N, D);
  const int npad = padded_keys(N);

  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const long long wh = (long long)w * H + h;
  const float* qg = q + wh * N * D;
  const float* kg = k + wh * N * D;
  const float* vg = v + wh * N * D;

  // 1. stage K and V of this (window, head), zero past key N - 1
  for (int e = threadIdx.x; e < npad * D / 4; e += kThreads) {
    const int j = e * 4 / D;
    const int off = e * 4 + (j / kChunk) * kPad;
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vv = kk;
    if (j < N) {
      kk = __ldg(reinterpret_cast<const float4*>(kg) + e);
      vv = __ldg(reinterpret_cast<const float4*>(vg) + e);
    }
    *reinterpret_cast<float4*>(ks + off) = kk;
    *reinterpret_cast<float4*>(vs + off) = vv;
  }

  // 2. this lane's two query rows, pre-scaled, and its key split
  const int split = threadIdx.x % kSplits;
  const int pair = threadIdx.x / kSplits;
  const int r0 = blockIdx.x * kRows + pair;
  const int r1 = r0 + kPairs;
  const int c0 = min(r0, N - 1);   // rows past N compute on row N - 1 and
  const int c1 = min(r1, N - 1);   // are not stored
  float q0[D], q1[D], acc0[D], acc1[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(qg + c0 * D + d));
    const float4 b = __ldg(reinterpret_cast<const float4*>(qg + c1 * D + d));
    q0[d] = a.x * scale; q0[d + 1] = a.y * scale;
    q0[d + 2] = a.z * scale; q0[d + 3] = a.w * scale;
    q1[d] = b.x * scale; q1[d + 1] = b.y * scale;
    q1[d + 2] = b.z * scale; q1[d + 3] = b.w * scale;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc0[d] = acc1[d] = 0.f;
  const float* b0 = bias + ((long long)h * N + c0) * N;
  const float* b1 = bias + ((long long)h * N + c1) * N;
  const float* m0 = mask ? mask + ((long long)(w % nW) * N + c0) * N : nullptr;
  const float* m1 = mask ? mask + ((long long)(w % nW) * N + c1) * N : nullptr;
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  __syncthreads();

  // 3. online softmax over this lane's chunks of keys
  for (int base = split * kChunk; base < npad; base += kRound) {
    const float* kc = ks + key_offset<D>(base);
    const float* vc = vs + key_offset<D>(base);
    // bias and mask first, so their loads are in flight during the scores
    float bias0[kChunk], bias1[kChunk], mask0[kChunk], mask1[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int j = min(base + i, N - 1);
      bias0[i] = __ldg(b0 + j);
      bias1[i] = __ldg(b1 + j);
      mask0[i] = mask ? __ldg(m0 + j) : 0.f;
      mask1[i] = mask ? __ldg(m1 + j) : 0.f;
    }
    float s0[kChunk], s1[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = ld4(kc + i * D + d);
        d0 = fmaf(q0[d], kk.x, d0);
        d0 = fmaf(q0[d + 1], kk.y, d0);
        d0 = fmaf(q0[d + 2], kk.z, d0);
        d0 = fmaf(q0[d + 3], kk.w, d0);
        d1 = fmaf(q1[d], kk.x, d1);
        d1 = fmaf(q1[d + 1], kk.y, d1);
        d1 = fmaf(q1[d + 2], kk.z, d1);
        d1 = fmaf(q1[d + 3], kk.w, d1);
      }
      s0[i] = d0;
      s1[i] = d1;
    }
    float cm0 = -CUDART_INF_F, cm1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool key = base + i < N;
      s0[i] = key ? (s0[i] + bias0[i]) + mask0[i] : -CUDART_INF_F;
      s1[i] = key ? (s1[i] + bias1[i]) + mask1[i] : -CUDART_INF_F;
      cm0 = fmaxf(cm0, s0[i]);
      cm1 = fmaxf(cm1, s1[i]);
    }
    // a row whose keys so far all lie past N keeps max -inf and adds nothing
    const float n0 = fmaxf(mx0, cm0), n1 = fmaxf(mx1, cm1);
    const bool live0 = n0 != -CUDART_INF_F, live1 = n1 != -CUDART_INF_F;
    const float al0 = live0 ? expf(mx0 - n0) : 1.f;
    const float al1 = live1 ? expf(mx1 - n1) : 1.f;
    mx0 = n0;
    mx1 = n1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      s0[i] = live0 ? expf(s0[i] - n0) : 0.f;
      s1[i] = live1 ? expf(s1[i] - n1) : 0.f;
      l0 += s0[i];
      l1 += s1[i];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      acc0[d] *= al0;
      acc1[d] *= al1;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = ld4(vc + i * D + d);
        acc0[d] = fmaf(s0[i], vv.x, acc0[d]);
        acc0[d + 1] = fmaf(s0[i], vv.y, acc0[d + 1]);
        acc0[d + 2] = fmaf(s0[i], vv.z, acc0[d + 2]);
        acc0[d + 3] = fmaf(s0[i], vv.w, acc0[d + 3]);
        acc1[d] = fmaf(s1[i], vv.x, acc1[d]);
        acc1[d + 1] = fmaf(s1[i], vv.y, acc1[d + 1]);
        acc1[d + 2] = fmaf(s1[i], vv.z, acc1[d + 2]);
        acc1[d + 3] = fmaf(s1[i], vv.w, acc1[d + 3]);
      }
    }
  }

  // 4. merge the four splits of each row (lanes 4p .. 4p+3 of one warp)
  constexpr unsigned kFull = 0xffffffffu;
  float top0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  top0 = fmaxf(top0, __shfl_xor_sync(kFull, top0, 2));
  const float f0 = mx0 == -CUDART_INF_F ? 0.f : expf(mx0 - top0);
  float top1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  top1 = fmaxf(top1, __shfl_xor_sync(kFull, top1, 2));
  const float f1 = mx1 == -CUDART_INF_F ? 0.f : expf(mx1 - top1);
  l0 *= f0;
  l1 *= f1;
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    acc0[d] *= f0;
    acc1[d] *= f1;
    acc0[d] += __shfl_xor_sync(kFull, acc0[d], 1);
    acc0[d] += __shfl_xor_sync(kFull, acc0[d], 2);
    acc1[d] += __shfl_xor_sync(kFull, acc1[d], 1);
    acc1[d] += __shfl_xor_sync(kFull, acc1[d], 2);
  }

  // 5. each of the four lanes stores a quarter of the two rows; the first
  // also stores the rows' log-sum-exp when the backward asked for it
  float* og = out + wh * N * D;
  constexpr int kPart = D / kSplits;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d / kPart == split) {
      if (r0 < N) og[r0 * D + d] = acc0[d] / l0;
      if (r1 < N) og[r1 * D + d] = acc1[d] / l1;
    }
  }
  if (lse != nullptr && split == 0) {
    if (r0 < N) lse[wh * N + r0] = top0 + logf(l0);
    if (r1 < N) lse[wh * N + r1] = top1 + logf(l1);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* mask, float* out, float* lse, int W, int H, int N,
           int nW, float scale, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)staged_floats(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, H, W);
  window_attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, mask, out, lse, H, N, nW, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes: K and V of one (window,
// head), zero-padded to a multiple of 32 keys, with the bank padding.
long long window_attn_smem_bytes(int N, int D) {
  return 2LL * static_cast<long long>(sizeof(float)) * staged_floats(N, D);
}

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// `mask` may be null (then nW is not read). `lse` may be null; otherwise it
// receives each row's log-sum-exp [W, H, N], which the backward
// (window_attn_bwd.cu) reads. D is a multiple of 4 up to 32; any other
// head_dim returns cudaErrorInvalidValue.
int window_attn_launch(const void* q, const void* k, const void* v,
                       const void* bias, const void* mask, void* out,
                       void* lse, int W, int H, int N, int D, int nW,
                       float scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(mask);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define WINDOW_ATTN_CASE(DIM) \
    case DIM:                                                             \
      return launch<DIM>(qf, kf, vf, bf, mf, of, lf, W, H, N, nW, scale, s);
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
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
