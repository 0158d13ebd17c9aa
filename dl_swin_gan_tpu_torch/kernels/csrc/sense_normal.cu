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
//   fy, fx                      the ortho DFT matrices (built in float64,
//                               rounded to complex64), split into TF32 hi
//                               and lo parts by the wrapper once per shape
//                               and device (coil_normal.cuh gives the layout)
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
// Bound: the DFTs are dense products over the rows they need: 8*R*X*(2Y +
// 2X) FLOP per (b,t,c), 3.7 MFLOP at 180x64 and R=15, 0.60 GFLOP per slice,
// plus 0.06 GFLOP of coil expansion and sum in float32 FMA, against about
// 10 MB moved. With the DFTs on the tensor cores in 3xTF32 (495/3 TFLOP/s)
// and the rest at 67 TFLOP/s, the operations bound a slice at about 4.5 us,
// ahead of the bytes (3.0 us at 3.35 TB/s); all in float32 FMA it would be
// 9.8 us. No plain TF32 or bf16: its rounding misses the 1e-4 limit.
//
// Design: the TPU grid is (B, T) and loops over coils inside the body; here
// the grid is (C, T, B), one block of 256 threads per (coil, frame, batch). A
// block keeps the expanded frame s_c in shared memory (Y rows of 2X floats,
// 92,160 bytes at 180x64) and two planes of 16 rows, 109,268 bytes in all, so
// two blocks fit an SM: a slice's 160 blocks run in one wave on the 132 SMs. A
// frame of few rows and a wide readout (fewer than 34 rows, from 433 columns
// on), for which that does not fit, gets planes and chunks of 8, 4, 2 or 1
// rows; frames of one or two rows wider than 9,680 or 7,252 columns do not fit
// at all. The expansion also flags the k-space rows that hold a nonzero
// weight. The sampled rows go through passes 2-5 in chunks of 16 (the mma's
// M): the y-DFT to the chunk's rows, the x-DFT and the weight, the inverse
// x-DFT, each into a chunk plane, then the inverse y-DFT from the chunk into
// the coil scratch, where later chunks add to what the same thread wrote (no
// atomics; the order is fixed). Each pass is a complex product done as two
// real ones on the tensor cores (mma.sync.m16n8k8, 3xTF32: every operand split
// into TF32 hi and lo): P1 = Re(A) B and P2 = Im(A) B over B as stored, (re,
// im) interleaved, which each lane finishes into re = P1.re -+ P2.im and im =
// P1.im +- P2.re; conjugates are those signs. The wrapper splits the DFT
// tables once: fy into (re hi, re lo, im hi, im lo) entries, whose chunk rows
// (pass 2) and columns (pass 5) stream through the chunk planes in slices with
// cp.async (pass 2's double-buffered in both planes, pass 5's through one) and
// are read with one 16-byte load per operand; fx in the mma's B-fragment
// order, one 16-byte load per lane from device memory. The x-DFTs sum at most
// 128 terms on the tensor cores before they add the partial sum into the chunk
// plane, so a long readout keeps the 1e-4 limit. The frame and the chunks are
// split as they are read. Each warp owns two n-tiles of a pass, so an operand
// it splits is split once. The shared-memory planes are XOR-swizzled so that
// the fragment loads hit 32 banks. The coil sum runs in a second launch, one
// thread per output element, in a fixed order. The expansion, which reads maps
// and x again for every (coil, frame) block, is now the largest phase; the
// coil sum on chip (a cluster of a frame's C blocks, which could also share x)
// and TMA staging are left for later work.

#include "coil_normal.cuh"

extern "C" {

// Dynamic shared memory of one block, in bytes: the frame and two chunks of
// 16 rows (fewer where those do not fit), the list of sampled rows and its
// length. The kernel uses no other.
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
      static_cast<const float*>(w), static_cast<const float4*>(fy),
      static_cast<const uint4*>(fx), static_cast<float2*>(coil),
      static_cast<float2*>(out), B, E, C, T, Y, X,
      static_cast<cudaStream_t>(stream)));
}

const char* sense_normal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
