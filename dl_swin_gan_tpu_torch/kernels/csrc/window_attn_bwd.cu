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
// Layout, all float32 and contiguous:
//   q, k, v, g, out, dq, dk, dv  [W, H, N, D]   D % 4 == 0, D <= 32
//   bias, dbias                  [H, N, N]
//   mask                         [nW, N, N], or null
//   lse                          [W, H, N]      from window_attn.cu
//   ds                           [W, H, N, N]   scratch
//
// Bound: 10*W*H*N^2*D FLOP (s, dp, dv, dq, dk) against 4*(7*W*H*N*D +
// 2*H*N^2 + nW*N^2) bytes (q, k, v, g in, dq, dk, dv out, bias in, dbias
// out, the mask in). At the Swin denoiser's full width (N = 448, D = 20,
// H = 8, W = 12 per slice) that is 3.85 GFLOP against 47 MB: the float32 FMA
// rate (67 TFLOP/s without tensor cores) bounds it at 0.0575 ms per slice,
// ahead of the bytes (0.014 ms at 3.35 TB/s). All arithmetic is float32 FMA.
//
// Design. The TPU runs its grid (H, W) in order, one (window, head) per step
// with the [N, N] matrices in VMEM, and sums dbias over the windows in one
// VMEM block that consecutive steps revisit. CUDA blocks run in no order,
// and dK/dV sum over query rows while dQ sums over keys, so no block can own
// all three. Three launches, none with atomics, so two calls on the same
// inputs give bitwise-equal gradients:
//   1. kv: one block per (32-key tile, head, window), one key per lane. The
//      block stages q * scale, g, lse and delta (computed here from g and
//      out) of all N query rows in shared memory (75 KB at N = 448, D = 20:
//      3 blocks per SM). Each warp walks every fourth row, two rows at a
//      time for ILP, recomputes s, p, dp and ds for its 32 keys with the
//      forward's operation order, and accumulates dk and dv in registers.
//      All lanes read the same staged row, which broadcasts; the bias and
//      mask reads and the ds store are 32 consecutive floats, coalesced. The
//      four warps' partial dk and dv are summed in a fixed order in shared
//      memory. ds goes to the scratch (77 MB per slice).
//   2. dq: one block per (64-row query tile, head, window); tiles of 32 keys
//      of ds and K staged in shared memory; dq = ds k * scale.
//   3. dbias: one thread per (head, i, j) sums ds over w = 0 .. W-1 in order,
//      as the TPU's revisited block does.
// The scratch costs three passes over 77 MB (about 0.07 ms at 3.35 TB/s)
// and buys determinism without a second recomputation of p; a block per
// (query tile, key tile, head) that loops over the windows would avoid it,
// but then dq, dk and dv would need reductions across blocks. Tensor cores
// and fusing the passes are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;               // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                   // pass 1: one key per lane
constexpr int kRows = 64;                   // pass 2: query rows per block
constexpr int kTile = 32;                   // pass 2: keys per staged tile
constexpr int kReduceThreads = 256;         // pass 3
static_assert(kThreads == 2 * kRows, "pass 2 splits D in two halves");

// floats of pass 1's shared memory: q * scale and g of N rows, lse and
// delta, reused afterwards for the four warps' partial dk and dv
__host__ __device__ inline long long kv_smem_floats(int N, int D) {
  const long long staged = 2LL * N * D + 2LL * N;
  const long long partial = 2LL * kWarps * kKeys * (D + 1);
  return staged > partial ? staged : partial;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a . b[0..3], in the order of the forward's score FMAs
__device__ __forceinline__ float dot4(const float4 a, const float* b,
                                      float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

// acc[0..3] += s * a
__device__ __forceinline__ void axpy4(const float s, const float4 a,
                                      float* acc) {
  acc[0] = fmaf(s, a.x, acc[0]);
  acc[1] = fmaf(s, a.y, acc[1]);
  acc[2] = fmaf(s, a.z, acc[2]);
  acc[3] = fmaf(s, a.w, acc[3]);
}

// blocks per SM the registers must allow: 3 fit in shared memory at N = 448
// and D <= 20, which caps a thread at 170 registers
constexpr int min_blocks(int D) { return D <= 20 ? 3 : 2; }

template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks(D))
attn_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias,
                   const float* __restrict__ mask,
                   const float* __restrict__ g,
                   const float* __restrict__ out,
                   const float* __restrict__ lse, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ ds, int H,
                   int N, int nW, float scale) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [N, D] q * scale
  float* gs = qs + N * D;                          // [N, D] g
  float* ls = gs + N * D;                          // [N] lse
  float* dl = ls + N;                              // [N] delta

  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const long long rows = ((long long)w * H + h) * N;   // row 0 of (w, h)
  const float* qg = q + rows * D;
  const float* gg = g + rows * D;
  const float* og = out + rows * D;

  // 1. stage q * scale and g of every query row; lse and delta per row
  for (int e = threadIdx.x; e < N * D / 4; e += kThreads) {
    float4 a = __ldg(reinterpret_cast<const float4*>(qg) + e);
    a.x *= scale; a.y *= scale; a.z *= scale; a.w *= scale;
    reinterpret_cast<float4*>(qs)[e] = a;
    reinterpret_cast<float4*>(gs)[e] =
        __ldg(reinterpret_cast<const float4*>(gg) + e);
  }
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(gg + i * D + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(og + i * D + c));
      d = fmaf(a.x, b.x, d);
      d = fmaf(a.y, b.y, d);
      d = fmaf(a.z, b.z, d);
      d = fmaf(a.w, b.w, d);
    }
    dl[i] = d;
    ls[i] = __ldg(lse + rows + i);
  }

  // 2. this lane's key (keys past N compute on key N - 1 and store nothing)
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int j = blockIdx.x * kKeys + lane;
  const bool live = j < N;
  const int jc = min(j, N - 1);
  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(k + (rows + jc) * D + d));
    const float4 b = __ldg(reinterpret_cast<const float4*>(v + (rows + jc) * D + d));
    kr[d] = a.x; kr[d + 1] = a.y; kr[d + 2] = a.z; kr[d + 3] = a.w;
    vr[d] = b.x; vr[d + 1] = b.y; vr[d + 2] = b.z; vr[d + 3] = b.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dkr[d] = dvr[d] = 0.f;
  const float* bcol = bias + (long long)h * N * N + jc;   // bias[h, i, jc]
  const float* mcol =
      mask ? mask + (long long)(w % nW) * N * N + jc : nullptr;
  float* dscol = ds + rows * N + jc;                       // ds[w, h, i, jc]
  __syncthreads();

  // 3. this warp's query rows, two at a time: row i0 and row i0 + kWarps
  for (int i0 = warp; i0 < N; i0 += 2 * kWarps) {
    const int i1 = i0 + kWarps;
    const bool has1 = i1 < N;
    const int c1 = has1 ? i1 : i0;
    // bias and mask first, so their loads are in flight during the dots
    const float b0 = __ldg(bcol + (long long)i0 * N);
    const float b1 = __ldg(bcol + (long long)c1 * N);
    const float m0 = mask ? __ldg(mcol + (long long)i0 * N) : 0.f;
    const float m1 = mask ? __ldg(mcol + (long long)c1 * N) : 0.f;
    const float* q0 = qs + i0 * D;
    const float* q1 = qs + c1 * D;
    const float* g0 = gs + i0 * D;
    const float* g1 = gs + c1 * D;
    float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      s0 = dot4(ld4(q0 + d), kr + d, s0);
      s1 = dot4(ld4(q1 + d), kr + d, s1);
      dp0 = dot4(ld4(g0 + d), vr + d, dp0);
      dp1 = dot4(ld4(g1 + d), vr + d, dp1);
    }
    s0 = (s0 + b0) + m0;
    s1 = (s1 + b1) + m1;
    const float p0 = expf(s0 - ls[i0]);
    const float p1 = has1 ? expf(s1 - ls[c1]) : 0.f;
    const float ds0 = p0 * (dp0 - dl[i0]);
    const float ds1 = has1 ? p1 * (dp1 - dl[c1]) : 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      axpy4(p0, ld4(g0 + d), dvr + d);
      axpy4(p1, ld4(g1 + d), dvr + d);
      axpy4(ds0, ld4(q0 + d), dkr + d);
      axpy4(ds1, ld4(q1 + d), dkr + d);
    }
    if (live) {
      dscol[(long long)i0 * N] = ds0;
      if (has1) dscol[(long long)i1 * N] = ds1;
    }
  }

  // 4. sum the four warps' partial dk and dv in a fixed order
  constexpr int kStride = D + 1;   // odd: a warp's lanes hit distinct banks
  __syncthreads();                 // every warp is done with the staged rows
  float* part = qs;                // [kWarps][2][kKeys][kStride]
#pragma unroll
  for (int d = 0; d < D; ++d) {
    part[((warp * 2) * kKeys + lane) * kStride + d] = dkr[d];
    part[((warp * 2 + 1) * kKeys + lane) * kStride + d] = dvr[d];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
    const int key = e / D;
    const int d = e % D;
    const int jj = blockIdx.x * kKeys + key;
    if (jj >= N) continue;
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      sk += part[((u * 2) * kKeys + key) * kStride + d];
      sv += part[((u * 2 + 1) * kKeys + key) * kStride + d];
    }
    dk[(rows + jj) * D + d] = sk;
    dv[(rows + jj) * D + d] = sv;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ ds, const float* __restrict__ k,
                   float* __restrict__ dq, int H, int N, float scale) {
  constexpr int kHalf = D / 2;     // even, since D % 4 == 0
  __shared__ float dss[kRows][kTile + 1];
  __shared__ __align__(16) float kts[kTile * D];
  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const long long rows = ((long long)w * H + h) * N;
  const int r = threadIdx.x % kRows;
  const int half = threadIdx.x / kRows;
  const int row0 = blockIdx.x * kRows;
  float acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) acc[d] = 0.f;

  for (int j0 = 0; j0 < N; j0 += kTile) {
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile;
      const int jj = e % kTile;
      const int i = row0 + rr;
      const int j = j0 + jj;
      dss[rr][jj] = (i < N && j < N) ? ds[(rows + i) * N + j] : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      kts[e] = (j0 + e / D < N) ? k[(rows + j0) * D + e] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      const float x = dss[r][jj];
      const float* kr = kts + jj * D + half * kHalf;
#pragma unroll
      for (int d = 0; d < kHalf; d += 2) {
        const float2 kk = *reinterpret_cast<const float2*>(kr + d);
        acc[d] = fmaf(x, kk.x, acc[d]);
        acc[d + 1] = fmaf(x, kk.y, acc[d + 1]);
      }
    }
    __syncthreads();
  }
  const int i = row0 + r;
  if (i < N) {
#pragma unroll
    for (int d = 0; d < kHalf; ++d)
      dq[(rows + i) * D + half * kHalf + d] = acc[d] * scale;
  }
}

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

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* mask, const float* g, const float* out,
           const float* lse, float* ds, float* dq, float* dk, float* dv,
           float* dbias, int W, int H, int N, int nW, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kv_smem_floats(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kv_kernel<D><<<dim3((N + kKeys - 1) / kKeys, H, W), kThreads,
                          smem, stream>>>(
      q, k, v, bias, mask, g, out, lse, dk, dv, ds, H, N, nW, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D><<<dim3((N + kRows - 1) / kRows, H, W), kThreads, 0,
                          stream>>>(ds, k, dq, H, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long NN = (long long)N * N;
  const long long blocks = (H * NN + kReduceThreads - 1) / kReduceThreads;
  attn_bwd_dbias_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                          stream>>>(ds, dbias, W, H, NN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of pass 1, in bytes.
long long window_attn_bwd_smem_bytes(int N, int D) {
  return static_cast<long long>(sizeof(float)) * kv_smem_floats(N, D);
}

// Launches the three passes on `stream`; returns the CUDA error code (0 =
// ok). `mask` may be null (then nW is not read). `ds` is scratch of
// W * H * N * N floats. D is a multiple of 4 up to 32; any other head_dim
// returns cudaErrorInvalidValue.
int window_attn_bwd_launch(const void* q, const void* k, const void* v,
                           const void* bias, const void* mask, const void* g,
                           const void* out, const void* lse, void* ds,
                           void* dq, void* dk, void* dv, void* dbias, int W,
                           int H, int N, int D, int nW, float scale,
                           void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(mask);
  const auto* gf = static_cast<const float*>(g);
  const auto* of = static_cast<const float*>(out);
  const auto* lf = static_cast<const float*>(lse);
  auto* dsf = static_cast<float*>(ds);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* dbf = static_cast<float*>(dbias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define WINDOW_ATTN_BWD_CASE(DIM)                                           \
    case DIM:                                                               \
      return launch<DIM>(qf, kf, vf, bf, mf, gf, of, lf, dsf, dqf, dkf, dvf, \
                         dbf, W, H, N, nW, scale, s);
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

const char* window_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
