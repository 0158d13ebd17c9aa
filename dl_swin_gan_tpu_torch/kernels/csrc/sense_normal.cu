// SENSE normal operator A^H W^2 A for Hopper (sm_90a), CUDA C++. The device
// code lives in coil_normal.cuh, which the block-LLR normal kernel shares.
//
// Replaces the Pallas TPU kernel `sense_normal_fused` in
// dl_swin_gan_tpu/kernels/sense_normal.py (body `_kernel`). For every
// (batch b, frame t, coil c) it computes
//
//     s_c   = sum_e maps[b,e,c] * x[b,e,t]          coil expansion
//     k_c   = F_y s_c F_x^T                         ortho DFT (F symmetric)
//     k_c  *= w[b,t]                                w = mask^2
//     c_c   = conj(F_y) k_c conj(F_x)^T             inverse DFT
//
// and then, in a second launch, out[b,e,t] = sum_c conj(maps[b,e,c]) * c_c.
//
// Layout: complex64 values as interleaved float2 (torch's complex64),
//   x, out  [B, E, T, Y, X]     maps [B, E, C, Y, X]     w [B, T, Y, X] f32
//   fy [Y, Y], fx [X, X]        ortho DFT matrices, built in float64 and
//                               rounded to complex64 by the wrapper
//   coil    [B, T, C, Y, X]     scratch the wrapper allocates
//
// Sampled rows: k-space rows whose weights are all zero contribute exact
// zeros. The kernel lists the R rows of frame (b, t) that hold a nonzero
// weight (a Cartesian mask samples whole phase-encode rows: at 12x, 15 of
// 180), takes the y-DFT first and to those rows only, runs both x-DFTs on
// those R rows alone, and sums the inverse y-DFT over them. For finite
// inputs the result is the dense product's; a row of zero weight whose
// k-space holds inf or NaN is dropped, not spread as NaN.
//
// Bound: the DFTs are done as dense products over the rows they need:
// 8*R*X*(2Y + 2X) FLOP per (b,t,c), 3.7 MFLOP at 180x64 and R=15, and
// 0.66 GFLOP per slice with the coil sums, against ~10 MB moved, so the
// float32 operations (67 TFLOP/s without tensor cores) bound it ahead of
// the bytes (3.35 TB/s), by about 3x. All arithmetic is float32 FMA: no
// TF32 or bf16, whose rounding the reconstruction cannot absorb.
//
// Design: the TPU grid is (B, T) and loops over coils inside the body; here
// the grid is (C, T, B), so one slice gives 160 blocks for the 132 SMs. Each
// block keeps its frame in two dynamic shared-memory buffers (2*Y*(X+1)*8
// bytes, 187,200 at 180x64) and ping-pongs between them, one pass per DFT
// axis, so no intermediate goes to device memory. Each DFT pass is a small
// complex matrix product in which every thread holds a tile of outputs in
// registers (4x8 on the inverse y-DFT, 1x4 on the passes over R rows): per
// step of the contraction the 4x8 tile loads 4 + 8 operands for 32 complex
// multiply-adds (128 FMA), where a one-output-per-thread loop loads 2 for 4
// FMA and is bound by the load/store units. Lanes take strided rows and
// columns, so a warp's loads of the frame hit distinct banks or broadcast
// and its loads of a DFT row are contiguous. Operands are loaded a few
// steps ahead of their use; the DFT tables are read through the read-only
// cache (fy is 259 KB and stays in L2). The coil sum runs in a second
// launch, one thread per output element, so it needs no atomics and its
// summation order is fixed. Tensor cores (3xTF32), TMA staging and a grid
// finer than one frame per block are left for later work.

#include "coil_normal.cuh"

extern "C" {

// Dynamic shared memory of one block, in bytes: two padded complex frames,
// the list of sampled rows and its length. The kernel uses no other.
long long sense_normal_smem_bytes(int Y, int X) {
  return coil_normal_smem_bytes(Y, X);
}

// Launches both kernels on `stream`; returns the CUDA error code (0 = ok).
int sense_normal_launch(const void* x, const void* maps, const void* w,
                        const void* fy, const void* fx, void* coil, void* out,
                        int B, int E, int C, int T, int Y, int X,
                        void* stream) {
  return static_cast<int>(launch_coil_normal(
      static_cast<const float2*>(x), static_cast<const float2*>(maps),
      static_cast<const float*>(w), static_cast<const float2*>(fy),
      static_cast<const float2*>(fx), static_cast<float2*>(coil),
      static_cast<float2*>(out), B, E, C, T, Y, X,
      static_cast<cudaStream_t>(stream)));
}

const char* sense_normal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
