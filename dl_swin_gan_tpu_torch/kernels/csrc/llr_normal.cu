// Block-LLR normal operator for Hopper (sm_90a), CUDA C++:
//
//     out = extract( [Dinv] A^H W^2 A [Dinv] combine(blocks) )
//
// with Dinv on the combine side ('pre', the primal) or on the extract side
// ('post', its adjoint). Replaces the Pallas TPU kernel
// `_llr_normal_pallas` (body `_make_kernel`) in
// dl_swin_gan_tpu/kernels/llr_normal.py, both of its variants (`d_pre`).
//
// Layout (complex64 as interleaved float2, torch's complex64):
//   blocks, out  [S, N, E, b, b, T]   the DSLR solver's [N, e*b^2, t] blocks
//                                     of S systems, N = nby*nbx row-major
//   maps  [S, E, C, Y, X]   w2 [S, T, Y, X] f32 (mask^2)   dinv [Y, X] f32
//   win   [b] f32           the periodic sqrt-Hann window of one axis
//   fy, fx                  the ortho DFT matrices, split into TF32 hi and
//                           lo parts by the wrapper (coil_normal.cuh)
//   img, img_out [S, E, T, Y, X] and coil [S, T, C, Y, X]: scratch the
//                           wrapper allocates
//
// Geometry (ops/llr.py BlockOp): blocks of b x b at stride s = b/2 over the
// image padded by (pyl, pxl) in front, so padded pixel (yp, xp) lies in the
// blocks by in {yp/s - 1, yp/s} (and the same for x), at in-block row
// yp - by*s. The TPU kernel multiplies by dense projection matrices
// P_y [nby*b, Y] and P_x [nbx*b, X], whose columns hold two nonzeros each;
// here combine is that gather and extract that windowed read.
//
// Four launches on the caller's stream, no atomics:
//   1. llr_combine_kernel, one block per (stride tile tx, ty, system*E + e):
//      each of the tile's s*s*T pixels sums its (up to) 2x2 covering block
//      pixels, weighted by win[iy]*win[ix], in a fixed order; the reads of a
//      block row are contiguous runs of s*T values. The tile goes through
//      shared memory so that the image rows are written contiguously;
//      'pre' multiplies by Dinv.
//   2-3. coil_normal_kernel and coil_combine_kernel (coil_normal.cuh, the
//      SENSE-normal kernel's device code) on the S systems as a batch: per
//      (coil, frame, system) the y-DFT to the sampled k-space rows only,
//      both x-DFTs on them, the weight, the inverse y-DFT from them; then
//      the coil sum in a fixed order. Per-coil [X, X] DFTs, not the TPU's
//      [C*X, C*X] block-diagonal matrix (C times the FLOPs).
//   4. llr_extract_kernel, one block per (block n, system*E + e): the b x b
//      x T patch is read row by row (out-of-image pixels give 0; 'post'
//      multiplies by Dinv), windowed, staged in shared memory and written
//      in the blocks' layout, T fastest, in one contiguous run.
// The blocks are read and written in the solver's layout directly, so the
// wrapper needs neither of the TPU path's blocks<->matrices transposes.
//
// Bound: at the DSLR training point (S=1, T=20, E=2, C=8, 180x64, b=16,
// 207 blocks, about 15 of 180 k-space rows sampled per frame) the kernel
// moves the blocks in and out (17 MB each way) and does about 0.6 GFLOP of
// DFTs, on the tensor cores in 3xTF32, and 0.1 GFLOP of float32 FMA, so
// the bytes (about 11 us at 3.35 TB/s) bound it ahead of the operations
// (about 5 us). No plain TF32 or bf16. The coil passes are the SENSE
// kernel's (coil_normal.cuh): one block per (coil, frame, system), two
// blocks per SM, so 160 blocks at S=1 run in one wave on the 132 SMs;
// sense_normal.cu's note gives their design. Fusing combine and extract
// into them, and the coil sum on chip, are left for later work.

#include "coil_normal.cuh"

namespace {

constexpr int kTileThreads = 256;

__global__ void __launch_bounds__(kTileThreads)
llr_combine_kernel(const float2* __restrict__ blocks,
                   const float* __restrict__ win,
                   const float* __restrict__ dinv, float2* __restrict__ img,
                   int E, int T, int Y, int X, int b, int nby, int nbx,
                   int pyl, int pxl, int pre) {
  extern __shared__ float2 tile[];  // [T][s*s + 1]
  const int s = b / 2;
  const int ld = s * s + 1;
  const int tx = blockIdx.x;
  const int ty = blockIdx.y;
  const int sys = blockIdx.z / E;
  const int e = blockIdx.z % E;
  const long long nblk = static_cast<long long>(nby) * nbx;
  const int n_el = s * s * T;

  // gather, T fastest: a warp reads contiguous runs of one block row
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int t = idx % T;
    const int q = idx / T;  // iyl * s + ixl
    const int iyl = q / s;
    const int ixl = q % s;
    float2 acc = make_float2(0.f, 0.f);
    for (int dy = 0; dy < 2; ++dy) {  // block row ty - 1, then ty
      const int by = ty - 1 + dy;
      if (by < 0 || by >= nby) continue;
      const int iy = iyl + (1 - dy) * s;
      for (int dx = 0; dx < 2; ++dx) {
        const int bx = tx - 1 + dx;
        if (bx < 0 || bx >= nbx) continue;
        const int ix = ixl + (1 - dx) * s;
        const float wgt = __ldg(win + iy) * __ldg(win + ix);
        const float2 v = __ldg(
            blocks + (((sys * nblk + by * nbx + bx) * E + e) * b * b +
                      iy * b + ix) * static_cast<long long>(T) + t);
        acc.x = fmaf(wgt, v.x, acc.x);
        acc.y = fmaf(wgt, v.y, acc.y);
      }
    }
    tile[t * ld + q] = acc;
  }
  __syncthreads();

  // write the image pixels of the tile, x fastest; padding is dropped
  float2* im = img + (static_cast<long long>(sys) * E + e) * T * Y * X;
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int ixl = idx % s;
    const int iyl = (idx / s) % s;
    const int t = idx / (s * s);
    const int y = ty * s + iyl - pyl;
    const int x = tx * s + ixl - pxl;
    if (y < 0 || y >= Y || x < 0 || x >= X) continue;
    float2 v = tile[t * ld + iyl * s + ixl];
    if (pre) {
      const float d = __ldg(dinv + y * X + x);
      v.x *= d;
      v.y *= d;
    }
    im[(static_cast<long long>(t) * Y + y) * X + x] = v;
  }
}

__global__ void __launch_bounds__(kTileThreads)
llr_extract_kernel(const float2* __restrict__ img,
                   const float* __restrict__ win,
                   const float* __restrict__ dinv, float2* __restrict__ blocks,
                   int E, int T, int Y, int X, int b, int nby, int nbx,
                   int pyl, int pxl, int post) {
  extern __shared__ float2 patch[];  // [T][b*b + 1]
  const int s = b / 2;
  const int bb = b * b;
  const int ld = bb + 1;
  const int n = blockIdx.x;
  const int sys = blockIdx.y / E;
  const int e = blockIdx.y % E;
  const int by = n / nbx;
  const int bx = n % nbx;
  const int n_el = bb * T;

  // read the patch row by row, x fastest; pixels outside the image give 0
  const float2* im = img + (static_cast<long long>(sys) * E + e) * T * Y * X;
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int ix = idx % b;
    const int iy = (idx / b) % b;
    const int t = idx / bb;
    const int y = by * s + iy - pyl;
    const int x = bx * s + ix - pxl;
    float2 v = make_float2(0.f, 0.f);
    if (y >= 0 && y < Y && x >= 0 && x < X) {
      v = __ldg(im + (static_cast<long long>(t) * Y + y) * X + x);
      if (post) {
        const float d = __ldg(dinv + y * X + x);
        v.x *= d;
        v.y *= d;
      }
      const float wgt = __ldg(win + iy) * __ldg(win + ix);
      v.x *= wgt;
      v.y *= wgt;
    }
    patch[t * ld + iy * b + ix] = v;
  }
  __syncthreads();

  // write the block in its [b*b, T] layout, T fastest: one contiguous run
  float2* out = blocks + ((static_cast<long long>(sys) * nby * nbx + n) * E +
                          e) * n_el;
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x)
    out[idx] = patch[(idx % T) * ld + idx / T];
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of each launch, in bytes; the wrapper
// checks them against the card's limit.
long long llr_normal_smem_bytes(int T, int Y, int X, int b) {
  const long long coil = coil_normal_smem_bytes(Y, X);
  const long long extract =
      static_cast<long long>(T) * (b * b + 1) * sizeof(float2);
  return coil > extract ? coil : extract;
}

// Launches the four kernels on `stream`; returns the CUDA error code
// (0 = ok). pre = 1 applies Dinv after combine (the primal), 0 before
// extract (the adjoint).
int llr_normal_launch(const void* blocks, const void* maps, const void* w2,
                      const void* fy, const void* fx, const void* win,
                      const void* dinv, void* img, void* coil, void* img_out,
                      void* out, int S, int E, int C, int T, int Y, int X,
                      int b, int nby, int nbx, int pyl, int pxl, int pre,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = b / 2;
  const size_t tile_smem = static_cast<size_t>(T) * (s * s + 1) * sizeof(float2);
  const size_t patch_smem = static_cast<size_t>(T) * (b * b + 1) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      llr_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tile_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(llr_extract_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(patch_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* w = static_cast<const float*>(win);
  const float* d = static_cast<const float*>(dinv);
  llr_combine_kernel<<<dim3(nbx + 1, nby + 1, S * E), kTileThreads, tile_smem,
                       st>>>(static_cast<const float2*>(blocks), w, d,
                             static_cast<float2*>(img), E, T, Y, X, b, nby,
                             nbx, pyl, pxl, pre);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_coil_normal(
      static_cast<const float2*>(img), static_cast<const float2*>(maps),
      static_cast<const float*>(w2), static_cast<const float4*>(fy),
      static_cast<const uint4*>(fx), static_cast<float2*>(coil),
      static_cast<float2*>(img_out), S, E, C, T, Y, X, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  llr_extract_kernel<<<dim3(nby * nbx, S * E), kTileThreads, patch_smem,
                       st>>>(static_cast<const float2*>(img_out), w, d,
                             static_cast<float2*>(out), E, T, Y, X, b, nby,
                             nbx, pyl, pxl, pre ? 0 : 1);
  return static_cast<int>(cudaGetLastError());
}

const char* llr_normal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
