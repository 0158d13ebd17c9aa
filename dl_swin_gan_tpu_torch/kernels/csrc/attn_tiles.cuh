// Tile helpers shared by the window-attention forward (window_attn.cu) and
// backward (window_attn_bwd.cu): 64-row tiles of a [N, D] operand staged
// with cp.async, split once into 3xTF32 hi and lo planes, and the
// m16n8k8 fragments read from those planes (fragment layout in
// mma_tf32.cuh; g = lane / 4, t = lane % 4).
//
// A staged plane is [64][Dpad + 4] 32-bit words, head_dim zero-padded to a
// multiple of 8 (the mma's k): at that stride every fragment load below is
// free of bank conflicts.
//
// The staging, planes and A loads here serve the float32 kernels; the bf16
// kernels stage their tiles as they are (mma_bf16.cuh) and round only
// their final stores to bf16 (store2: to nearest, ties to even, as torch's
// .to(torch.bfloat16)). Also shared: the cp.async copies and the bias and
// mask reads at C-fragment positions.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // AFrag, BFrag, split, split_int

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// two consecutive elements (p 8-byte aligned for float, 4-byte for bf16)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr int kTile = 64;   // rows (queries or keys) per staged tile

template <int D>
struct Dims {
  static constexpr int kPad = (D + 7) / 8 * 8;    // head_dim padded to the mma's k
  static constexpr int kSteps = kPad / 8;         // k-steps (or n-tiles) over it
  static constexpr int kStride = kPad + 4;        // floats per staged row
  static constexpr int kPlane = kTile * kStride;  // one hi (or lo) plane
  static constexpr int kRaw = kTile * D;          // one raw float32 tile
};

// B operand of x y^T with y staged: n runs over the staged rows n0 .. n0+7,
// k over head_dim step ks (b[0] = (k = t, n = g), b[1] = (k = t+4, n = g))
template <int D>
__device__ __forceinline__ BFrag load_b_rows(const uint32_t* plane, int n0,
                                             int ks, int g, int t) {
  using C = Dims<D>;
  const int e = (n0 + g) * C::kStride + 8 * ks + t;
  BFrag f;
  f.hi[0] = plane[e];
  f.hi[1] = plane[e + 4];
  f.lo[0] = plane[C::kPlane + e];
  f.lo[1] = plane[C::kPlane + e + 4];
  return f;
}

// B operand of p y with p from a C fragment: k runs over the staged rows
// k0 .. k0+7 in the fragment's order (k = t is row k0+2t, k = t+4 is row
// k0+2t+1), n over head_dim columns 8 nd .. 8 nd + 7
template <int D>
__device__ __forceinline__ BFrag load_b_perm(const uint32_t* plane, int k0,
                                             int nd, int g, int t) {
  using C = Dims<D>;
  const int e = (k0 + 2 * t) * C::kStride + 8 * nd + g;
  BFrag f;
  f.hi[0] = plane[e];
  f.hi[1] = plane[e + C::kStride];
  f.lo[0] = plane[C::kPlane + e];
  f.lo[1] = plane[C::kPlane + e + C::kStride];
  return f;
}

// a C fragment (rows g, g+8; columns 2t, 2t+1) as the A operand whose k = t
// is column 2t and k = t+4 column 2t+1; IntSplit splits it on the integer
// pipes (split_int), which leaves cvt's pipe to the rest of the loop
template <bool IntSplit = false>
__device__ __forceinline__ AFrag a_from_c(const float c[4]) {
  AFrag f;
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (IntSplit)
      split_int(x[i], f.hi[i], f.lo[i]);
    else
      split(x[i], f.hi[i], f.lo[i]);
  }
  return f;
}

// A operand straight from device memory: rows r0 .. r0+15 of x [N, D]
// (times mult, in float32), zero past row N-1 and column D-1
template <int D>
__device__ __forceinline__ void load_a_global(AFrag f[Dims<D>::kSteps],
                                              const float* x, int r0, int N,
                                              float mult, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < Dims<D>::kSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i & 1);
      const int d = 8 * ks + t + 4 * (i >> 1);
      const float v =
          (r < N && d < D) ? __ldg(x + (long long)r * D + d) * mult : 0.f;
      split(v, f[ks].hi[i], f[ks].lo[i]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// rows i0 .. i0+63 of x [N, D] into dst [64 * D], zero past row N-1; the
// block's Threads threads share the copies, 16 bytes each (D % 4 == 0, so
// a copy never straddles two rows)
template <int D, int Threads>
__device__ __forceinline__ void stage_raw(float* dst, const float* x, int i0,
                                          int N) {
  const float* src = x + (long long)i0 * D;
  for (int e = threadIdx.x; e < kTile * D / 4; e += Threads) {
    const bool ok = i0 + 4 * e / D < N;
    cp_async16(dst + 4 * e, ok ? src + 4 * e : x, ok);
  }
}

// a raw tile (times mult) into its hi and lo planes, four columns at a
// time, zero in the padding columns; with Ones, mult in the first padding
// column (column D, where D % 8 != 0), so that a product with the tile sums
// the other operand's rows there
template <int D, int Threads, bool Ones = false>
__device__ __forceinline__ void split_tile(uint32_t* plane, const float* raw,
                                           float mult) {
  using C = Dims<D>;
  constexpr int kQuads = C::kPad / 4;
  for (int e = threadIdx.x; e < kTile * kQuads; e += Threads) {
    const int r = e / kQuads;
    const int d = 4 * (e % kQuads);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d < D) x = *reinterpret_cast<const float4*>(raw + r * D + d);
    else if (Ones && d == D) x.x = 1.f;
    uint4 hi, lo;
    split(x.x * mult, hi.x, lo.x);
    split(x.y * mult, hi.y, lo.y);
    split(x.z * mult, hi.z, lo.z);
    split(x.w * mult, hi.w, lo.w);
    *reinterpret_cast<uint4*>(plane + r * C::kStride + d) = hi;
    *reinterpret_cast<uint4*>(plane + C::kPlane + r * C::kStride + d) = lo;
  }
}

// Offset into an [N, N] tensor of a lane's first element in a row of C
// fragments: row i (clamped into [0, N)) times N plus 2t. Rows < 46341 keep
// it within int.
__device__ __forceinline__ int bias_row_offset(int i, int t, int N) {
  return min(i, N - 1) * N + 2 * t;
}

// x [N, N] (the bias of a head, or the mask of a window) at the elements
// of a warp's C fragments of s over Tiles n-tiles of keys from j0: rows at
// offsets o0 and o1 (bias_row_offset of rows g and g + 8), columns
// j0 + 8 n + 2t and + 1. Where the keys lie inside the row and N is even,
// each pair is one 8-byte load at a fixed offset from one address; else
// two 4-byte loads with the columns clamped into [0, N).
template <int Tiles>
__device__ __forceinline__ void load_bias_rows(float x_out[Tiles][4],
                                               const float* x, int o0, int o1,
                                               int j0, int t, int N) {
  if (N % 2 == 0 && j0 + 8 * Tiles <= N) {
    const float* p0 = x + (o0 + j0);
    const float* p1 = x + (o1 + j0);
#pragma unroll
    for (int n = 0; n < Tiles; ++n) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p0 + 8 * n));
      const float2 b = __ldg(reinterpret_cast<const float2*>(p1 + 8 * n));
      x_out[n][0] = a.x;
      x_out[n][1] = a.y;
      x_out[n][2] = b.x;
      x_out[n][3] = b.y;
    }
  } else {
    const float* p0 = x + (o0 - 2 * t);   // the rows' starts
    const float* p1 = x + (o1 - 2 * t);
#pragma unroll
    for (int n = 0; n < Tiles; ++n) {
      const int j = j0 + 8 * n + 2 * t;
      const int ja = min(j, N - 1), jb = min(j + 1, N - 1);
      x_out[n][0] = __ldg(p0 + ja);
      x_out[n][1] = __ldg(p0 + jb);
      x_out[n][2] = __ldg(p1 + ja);
      x_out[n][3] = __ldg(p1 + jb);
    }
  }
}

}  // namespace
