// The per-coil SENSE normal passes on one frame, shared by the SENSE-normal
// kernel (sense_normal.cu) and the block-LLR normal kernel (llr_normal.cu).
//
// coil_normal_kernel, grid (C, T, B), 384 threads, one block per (coil,
// frame, batch):
//
//     s_c   = sum_e maps[b,e,c] * x[b,e,t]          coil expansion
//     k_c   = F_y s_c F_x^T                         ortho DFT (F symmetric)
//     k_c  *= w[b,t]                                w = mask^2
//     c_c   = conj(F_y) k_c conj(F_x)^T             inverse DFT
//
// into the scratch coil [B, T, C, Y, X]; coil_combine_kernel then sums
// out[b,e,t] = sum_c conj(maps[b,e,c]) * c_c in a fixed order (no atomics).
// The y-DFT goes first and only to the k-space rows of the frame that hold
// a nonzero weight; both x-DFTs run on those rows alone. sense_normal.cu's
// source note gives the design and the bound.
//
// Layout: complex64 values as interleaved float2 (torch's complex64),
//   x, out  [B, E, T, Y, X]     maps [B, E, C, Y, X]     w [B, T, Y, X] f32
//   fy [Y, Y], fx [X, X]        ortho DFT matrices (complex64)

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 256;
constexpr int kExpand = 4;  // elements per thread per round of the expansion

__device__ __forceinline__ float2 conj_if(bool conj, float2 v) {
  return conj ? make_float2(v.x, -v.y) : v;
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  // acc += a * b
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// A frame in shared memory, row-major with row stride ld = X + 1: the pad
// puts 8 neighbouring rows of one column in 8 different bank pairs.
struct Frame {
  float2* p;
  int ld;
  __device__ float2& operator()(int r, int c) const { return p[r * ld + c]; }
};

// A symmetric DFT table F [n, n] in global memory, read through the
// read-only cache: as the right operand of the x-DFTs, row k at step k.
struct TableR {
  const float2* p;
  int n;
  __device__ float2 operator()(int k, int c) const { return __ldg(p + k * n + c); }
};

// The y-DFT to the sampled rows: F[rows[i]][y] = F[y][rows[i]], the left
// operand of output row i at step y (a warp's 8 rows read row y of F).
struct SampledRowsL {
  const float2* p;
  int n;
  const int* rows;
  __device__ float2 operator()(int i, int y) const {
    return __ldg(p + y * n + rows[i]);
  }
};
// The inverse y-DFT from the sampled rows: F[y][rows[i]] = F[rows[i]][y],
// the left operand of output row y at step i.
struct SampledTableL {
  const float2* p;
  int n;
  const int* rows;
  __device__ float2 operator()(int y, int i) const {
    return __ldg(p + rows[i] * n + y);
  }
};

// One step k of the contraction: the tile's left and right operands.
template <int TM, int TN, class L, class R>
__device__ __forceinline__ void load_step(const L& lhs, const R& rhs,
                                          const int* rr, const int* cc, int k,
                                          float2* l, float2* r) {
#pragma unroll
  for (int i = 0; i < TM; ++i) l[i] = lhs(rr[i], k);
#pragma unroll
  for (int j = 0; j < TN; ++j) r[j] = rhs(k, cc[j]);
}

// acc[i][j] += L[i] * R[j] over the tile, with L and R optionally conjugated.
template <int TM, int TN, bool kConjL, bool kConjR>
__device__ __forceinline__ void mac_step(float2 (&acc)[TM][TN],
                                         const float2* l, const float2* r) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      cmac(acc[i][j], conj_if(kConjL, l[i]), conj_if(kConjR, r[j]));
}

// out[r][c] = sum_k L(r, k) * R(k, c) for an M x N output, K deep, with L
// and R optionally conjugated; epi(r, c, value) stores each output.
//
// Each thread holds a TM x TN tile of outputs; a warp covers 8*TM rows x
// 4*TN columns, lane l taking rows l/4 + 8i and columns l%4 + 4j, so for
// each i the warp reads 8 neighbouring rows and for each j 4 neighbouring
// columns. A ring of S register sets keeps the operands of S - 1 steps in
// flight ahead of the arithmetic, with no copies between sets. Rows and
// columns past the ragged edge are read clamped and never stored.
template <int TM, int TN, int S, bool kConjL, bool kConjR, class L, class R,
          class Epi>
__device__ __forceinline__ void dft_pass(int M, int N, int K, L lhs, R rhs,
                                         Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wtiles_m = (M + 8 * TM - 1) / (8 * TM);
  const int wtiles_n = (N + 4 * TN - 1) / (4 * TN);
  for (int wt = warp; wt < wtiles_m * wtiles_n; wt += kWarps) {
    const int r0 = (wt / wtiles_n) * 8 * TM + lane / 4;
    const int c0 = (wt % wtiles_n) * 4 * TN + lane % 4;
    int rr[TM], cc[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) rr[i] = min(r0 + 8 * i, M - 1);
#pragma unroll
    for (int j = 0; j < TN; ++j) cc[j] = min(c0 + 4 * j, N - 1);
    float2 acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = make_float2(0.f, 0.f);

    float2 l[S][TM], r[S][TN];
    if (K > 0) {
#pragma unroll
      for (int st = 0; st < S - 1; ++st)
        load_step<TM, TN>(lhs, rhs, rr, cc, min(st, K - 1), l[st], r[st]);
    }
    for (int k = 0; k < K; k += S) {
#pragma unroll
      for (int st = 0; st < S; ++st) {
        const int ahead = (st + S - 1) % S;
        load_step<TM, TN>(lhs, rhs, rr, cc, min(k + st + S - 1, K - 1),
                          l[ahead], r[ahead]);
        if (k + st < K) mac_step<TM, TN, kConjL, kConjR>(acc, l[st], r[st]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (r0 + 8 * i < M && c0 + 4 * j < N)
          epi(r0 + 8 * i, c0 + 4 * j, acc[i][j]);
  }
}

// The rows of a [Y, X] weight frame that hold a nonzero weight, in
// ascending order, into rows[0 .. *count). All threads flag rows in rows[]
// itself (every load independent of the others); warp 0 then compacts the
// flags in place.
__device__ void sampled_rows(const float* __restrict__ wf, int Y, int X,
                             int* rows, int* count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int y = threadIdx.x; y < Y; y += kThreads) rows[y] = 0;
  __syncthreads();
#pragma unroll 4
  for (int p = threadIdx.x; p < Y * X; p += kThreads)
    if (__ldg(wf + p) != 0.f) rows[p / X] = 1;
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < Y; base += 32) {
      const int y = base + lane;
      const bool flag = y < Y && rows[y];
      const unsigned ballot = __ballot_sync(0xffffffffu, flag);
      __syncwarp();  // every flag of this chunk is read before any write
      if (flag) rows[n + __popc(ballot & ((1u << lane) - 1))] = y;
      n += __popc(ballot);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
coil_normal_kernel(const float2* __restrict__ x, const float2* __restrict__ maps,
                   const float* __restrict__ w, const float2* __restrict__ fy,
                   const float2* __restrict__ fx, float2* __restrict__ coil,
                   int E, int C, int T, int Y, int X) {
  extern __shared__ float2 smem[];
  const int ld = X + 1;
  const Frame a{smem, ld};           // [Y][ld]
  const Frame b{smem + Y * ld, ld};  // [Y][ld]
  int* rows = reinterpret_cast<int*>(smem + 2 * Y * ld);  // [Y], then count

  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int bb = blockIdx.z;
  const int n = Y * X;
  const long long yx = n;
  const float* wf = w + ((long long)bb * T + t) * yx;

  // 1. coil expansion: a = sum_e maps[bb,e,c] * x[bb,e,t]; each thread
  //    takes kExpand elements at once, so their loads are in flight together
  const float2* mc = maps + ((long long)bb * E * C + c) * yx;
  const float2* xt = x + ((long long)bb * E * T + t) * yx;
  for (int p0 = threadIdx.x; p0 < n; p0 += kExpand * kThreads) {
    float2 acc[kExpand];
#pragma unroll
    for (int u = 0; u < kExpand; ++u) acc[u] = make_float2(0.f, 0.f);
    for (int e = 0; e < E; ++e) {
      float2 m[kExpand], v[kExpand];
#pragma unroll
      for (int u = 0; u < kExpand; ++u) {
        const int p = min(p0 + u * kThreads, n - 1);
        m[u] = __ldg(mc + (long long)e * C * yx + p);
        v[u] = __ldg(xt + (long long)e * T * yx + p);
      }
#pragma unroll
      for (int u = 0; u < kExpand; ++u) cmac(acc[u], m[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kExpand; ++u) {
      const int p = p0 + u * kThreads;
      if (p < n) a(p / X, p % X) = acc[u];
    }
  }
  sampled_rows(wf, Y, X, rows, rows + Y);  // ends in __syncthreads
  const int R = rows[Y];

  // 2. DFT along y to the sampled rows i < R (row rows[i] of k-space):
  //    b[i][x] = sum_y fy[rows[i]][y] * a[y][x]
  dft_pass<1, 4, 4, false, false>(
      R, X, Y, SampledRowsL{fy, Y, rows}, a,
      [=](int i, int col, float2 v) { b(i, col) = v; });
  __syncthreads();

  // 3. DFT along x of those rows, then the weight:
  //    a[i][k] = w[rows[i]][k] * sum_x b[i][x] * fx[x][k]
  dft_pass<1, 4, 4, false, false>(
      R, X, X, b, TableR{fx, X}, [=](int i, int col, float2 v) {
        const float wk = __ldg(wf + rows[i] * X + col);
        a(i, col) = make_float2(v.x * wk, v.y * wk);
      });
  __syncthreads();

  // 4. inverse DFT along x: b[i][x] = sum_k a[i][k] * conj(fx[k][x])
  dft_pass<1, 4, 4, false, true>(
      R, X, X, a, TableR{fx, X},
      [=](int i, int col, float2 v) { b(i, col) = v; });
  __syncthreads();

  // 5. inverse DFT along y from the sampled rows, straight to the coil
  //    scratch: coil[bb,t,c][y][x] = sum_i conj(fy[y][rows[i]]) * b[i][x]
  float2* out = coil + ((long long)(bb * T + t) * C + c) * yx;
  dft_pass<4, 8, 3, true, false>(
      Y, X, R, SampledTableL{fy, Y, rows}, b,
      [=](int r, int col, float2 v) { out[r * X + col] = v; });
}

// out[bb,e,t,p] = sum_c conj(maps[bb,e,c,p]) * coil[bb,t,c,p]
__global__ void __launch_bounds__(kCombineThreads)
coil_combine_kernel(const float2* __restrict__ maps,
                    const float2* __restrict__ coil, float2* __restrict__ out,
                    int B, int E, int C, int T, int YX) {
  const long long total = (long long)B * E * T * YX;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long p = idx % YX;
    long long r = idx / YX;
    const long long t = r % T;
    r /= T;
    const long long e = r % E;
    const long long bb = r / E;
    const float2* m = maps + ((bb * E + e) * C) * YX + p;
    const float2* v = coil + ((bb * T + t) * C) * YX + p;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int c = 0; c < C; ++c)
      cmac(acc, conj_if(true, __ldg(m + (long long)c * YX)),
           __ldg(v + (long long)c * YX));
    out[idx] = acc;
  }
}

}  // namespace

namespace {

// Dynamic shared memory of one coil_normal_kernel block, in bytes: two
// padded complex frames, the list of sampled rows and its length.
long long coil_normal_smem_bytes(int Y, int X) {
  return 2LL * Y * (X + 1) * static_cast<long long>(sizeof(float2)) +
         (Y + 1LL) * static_cast<long long>(sizeof(int));
}

// Launches coil_normal_kernel and coil_combine_kernel on `s`; returns the
// first CUDA error (cudaSuccess = ok).
cudaError_t launch_coil_normal(const float2* x, const float2* maps,
                               const float* w, const float2* fy,
                               const float2* fx, float2* coil, float2* out,
                               int B, int E, int C, int T, int Y, int X,
                               cudaStream_t s) {
  const size_t smem = static_cast<size_t>(coil_normal_smem_bytes(Y, X));
  cudaError_t err = cudaFuncSetAttribute(
      coil_normal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  const dim3 grid(C, T, B);
  coil_normal_kernel<<<grid, kThreads, smem, s>>>(x, maps, w, fy, fx, coil, E,
                                                  C, T, Y, X);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long total = static_cast<long long>(B) * E * T * Y * X;
  long long blocks = (total + kCombineThreads - 1) / kCombineThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  coil_combine_kernel<<<static_cast<unsigned>(blocks), kCombineThreads, 0, s>>>(
      maps, coil, out, B, E, C, T, Y * X);
  return cudaGetLastError();
}

}  // namespace
