// 3xTF32 products on Hopper's tensor cores (`mma.sync.m16n8k8`, TF32
// operands, float32 accumulators), shared by the window-attention kernels
// (window_attn.cu, window_attn_bwd.cu) and the SENSE coil pass
// (coil_normal.cuh).
//
// Each float32 operand x is split into hi = tf32(x) (cvt.rna: to nearest,
// ties away from zero) and lo = tf32(x - hi); a product accumulates
// a_hi b_lo + a_lo b_hi, then a_hi b_hi, in float32. That is about as
// accurate as float32 FMA. Plain TF32 (a_hi b_hi alone) keeps about three
// decimal digits, which neither kernel's 1e-4 limit allows.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A [16 x 8], row-major: a[0] = (g, t), a[1] = (g + 8, t),
//                          a[2] = (g, t + 4), a[3] = (g + 8, t + 4)
//   B [8 x 8], column:     b[0] = (k = t, n = g), b[1] = (k = t + 4, n = g)
//   C [16 x 8]:            c[0] = (g, 2t), c[1] = (g, 2t + 1),
//                          c[2] = (g + 8, 2t), c[3] = (g + 8, 2t + 1)

#pragma once

#include <stdint.h>

namespace {

struct AFrag {   // an m16n8k8 A operand, split
  uint32_t hi[4], lo[4];
};
struct BFrag {   // an m16n8k8 B operand, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// split on the integer pipes instead of cvt: the same rounding (to nearest,
// ties away from zero), bitwise the same as split for finite x
__device__ __forceinline__ void split_int(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two cross terms, then hi * hi
__device__ __forceinline__ void mma3(float c[4], const AFrag& a,
                                     const BFrag& b) {
  mma(c, a.hi, b.lo);
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.hi);
}

}  // namespace
