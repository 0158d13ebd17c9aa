// The per-coil SENSE normal passes on one frame, shared by the SENSE-normal
// kernel (sense_normal.cu) and the block-LLR normal kernel (llr_normal.cu).
//
// coil_normal_kernel, grid (C, T, B), 256 threads, two blocks per SM at
// 180x64, one block per (coil, frame, batch):
//
//     s_c   = sum_e maps[b,e,c] * x[b,e,t]          coil expansion
//     k_c   = F_y s_c F_x^T                         ortho DFT (F symmetric)
//     k_c  *= w[b,t]                                w = mask^2
//     c_c   = conj(F_y) k_c conj(F_x)^T             inverse DFT
//
// into the scratch coil [B, T, C, Y, X]; coil_combine_kernel then sums
// out[b,e,t] = sum_c conj(maps[b,e,c]) * c_c in a fixed order (no atomics).
// The y-DFT goes first and only to the k-space rows of the frame that hold
// a nonzero weight, in chunks of up to 16 such rows; both x-DFTs run on a
// chunk's rows alone, and the inverse y-DFT of each chunk adds into the
// block's own slice of coil, in chunk order. A frame of few rows and a
// wide readout, whose two 16-row chunk planes do not fit beside it in
// shared memory, runs chunks of 8, 4, 2 or 1 rows instead
// (coil_chunk_rows). The four DFT passes run on the tensor cores in 3xTF32
// (mma_tf32.cuh). sense_normal.cu's source note gives the design and the
// bound.
//
// Layout: complex64 values as interleaved float2 (torch's complex64),
//   x, out  [B, E, T, Y, X]     maps [B, E, C, Y, X]     w [B, T, Y, X] f32
//   fy      [Y, Y] of (re hi, re lo, im hi, im lo): the ortho DFT matrix
//           split into TF32 parts by the wrapper
//   fx      the [X, 2X] floats of the ortho DFT matrix, split into TF32
//           (hi, lo) pairs by the wrapper, in the order of the mma's B
//           fragments (sense_normal.py coil_tables)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // AFrag, BFrag, split, mma3

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // sampled k-space rows per round: the mma's M
constexpr int kGroup = 2;   // n-tiles a warp holds at once over a chunk
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

// The phase probe, compiled in only by compare_coil_normal.py --phases:
// thread 0 of each of the first kPhaseBlocks blocks adds the clock64()
// cycles of each phase to coil_phase_cycles (0 expansion and row flags, 1
// row list, then summed over the chunks 2 y-DFT, 3 x-DFT and weight, 4
// inverse x-DFT, 5 inverse y-DFT).
#ifdef COIL_NORMAL_PHASES
constexpr int kPhaseBlocks = 4096;
constexpr int kPhases = 6;
__device__ long long coil_phase_cycles[kPhaseBlocks][kPhases];
__device__ __forceinline__ long long phase_start() { return clock64(); }
__device__ __forceinline__ void phase_end(long long& last, int i) {
  const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const long long now = clock64();
  if (threadIdx.x == 0 && b < kPhaseBlocks)
    coil_phase_cycles[b][i] += now - last;
  last = now;
}
#else
__device__ __forceinline__ long long phase_start() { return 0; }
__device__ __forceinline__ void phase_end(long long&, int) {}
#endif

// Floats per row of a complex plane in shared memory: 2X rounded up to 32,
// so that the swizzle below stays inside the row.
__host__ __device__ constexpr int plane_ld(int X) {
  return (2 * X + 31) / 32 * 32;
}

// A complex plane in shared memory as floats (re, im interleaved), row r at
// r * ld, its float columns XOR-swizzled on bits 2-4 (row bit 0 -> column
// bit 3, bit 1 -> bit 4, bit 2 -> bit 2). Then a B fragment read as stored
// (4 rows x 8 floats) hits 32 distinct banks, and so do an A fragment read
// as (re, im) pairs and a C fragment stored as pairs, per half-warp.
struct Plane {
  float* p;
  int ld;
  __device__ static int swz(int r) { return ((r & 3) << 3) | (r & 4); }
  __device__ float operator()(int r, int k) const {
    return p[r * ld + (k ^ swz(r))];
  }
  __device__ float2& pair(int r, int k) const {  // k even
    return *reinterpret_cast<float2*>(p + r * ld + (k ^ swz(r)));
  }
};

// A complex product C = op(A) op(B) on the tensor cores as two real ones
// over B as stored (re, im interleaved along its rows): P1 = Ar B and
// P2 = Ai B, each [M, 2N]. A C fragment's c[0], c[1] are the (re, im)
// columns of one complex output column, so with op(A) = Ar + i sa Ai and
// op(B) = Br + i sb Bi (sa, sb = +-1, -1 conjugating) the lane finishes
//     re = P1.re - sa sb P2.im,   im = sb P1.im + sa P2.re.
// A and B never need a sign or a column swap, and B is read as stored.
struct CFrag {
  float p1[4], p2[4];
};

template <int kSa, int kSb>
__device__ __forceinline__ float2 finish(const CFrag& c, int half) {
  const int i = 2 * half;  // c[0..1]: row g; c[2..3]: row g + 8
  return make_float2(c.p1[i] - kSa * kSb * c.p2[i + 1],
                     kSb * c.p1[i + 1] + kSa * c.p2[i]);
}

__device__ __forceinline__ void cmma3(CFrag& c, const AFrag& ar,
                                      const AFrag& ai, const BFrag& b) {
  mma3(c.p1, ar, b);
  mma3(c.p2, ai, b);
}

// 16-byte asynchronous copy from device to shared memory; zero-filled (and
// src not read) where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Entries of the split DFT table staged in shared memory: an entry (re hi,
// re lo, im hi, im lo) is 16 bytes, row r at r * ld floats (ld a multiple
// of 32), entry k of it at 4 * (k ^ ((r & 1) << 2)). Then the 8 lanes of
// each quarter-warp that read an A fragment (rows g, g + 1 of two lanes'
// groups, four entries each) hit 32 distinct banks.
struct QPlane {
  float* p;
  int ld;
  __device__ float4& operator()(int r, int k) const {
    return *reinterpret_cast<float4*>(p + r * ld + 4 * (k ^ ((r & 1) << 2)));
  }
};

// Stage a chunk's rows of the split DFT table fy [Y, Y], columns y0 ..
// y0 + w - 1: dst(i, j) = fy[rc[i]][y0 + j] for the kc rows i, or
// (kTransposed, the inverse y-DFT's operand, F being symmetric) dst(j, i) =
// fy[y0 + j][rc[i]]; zero past row m or column Y. One commit group; the
// reads run along j, contiguous in fy.
template <bool kTransposed>
__device__ __forceinline__ void stage_table(const QPlane& dst,
                                            const float4* __restrict__ fy,
                                            const int* rc, int m, int kc,
                                            int Y, int y0, int w) {
  for (int idx = threadIdx.x; idx < kc * w; idx += kThreads) {
    const int i = idx / w;
    const int j = idx % w;
    const bool ok = i < m && y0 + j < Y;
    float4* d = kTransposed ? &dst(j, i) : &dst(i, j);
    cp_async16(d, ok ? fy + rc[i] * Y + y0 + j : fy, ok);
  }
  cp_async_commit();
}

// A operands (Ar, Ai) from staged table entries, already split: rows
// r0 + g and r0 + g + 8, zero past row M or column K.
__device__ __forceinline__ void load_a_quad(const QPlane& src, int r0, int k0,
                                            int M, int K, int g, int t,
                                            AFrag& ar, AFrag& ai) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1);
    const int k = k0 + t + 4 * (i >> 1);
    const float4 v =
        (r < M && k < K) ? src(r, k) : make_float4(0.f, 0.f, 0.f, 0.f);
    ar.hi[i] = __float_as_uint(v.x);
    ar.lo[i] = __float_as_uint(v.y);
    ai.hi[i] = __float_as_uint(v.z);
    ai.lo[i] = __float_as_uint(v.w);
  }
}

// A operands (Ar, Ai) from a complex plane in shared memory, split on load:
// element (r, k) is the float pair at column 2k of row r; rows r0 + g and
// r0 + g + 8, zero past row M or column K (complex).
__device__ __forceinline__ void load_a_plane(const Plane& src, int r0, int k0,
                                             int M, int K, int g, int t,
                                             AFrag& ar, AFrag& ai) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1);
    const int k = k0 + t + 4 * (i >> 1);
    const float2 v =
        (r < M && k < K) ? src.pair(r, 2 * k) : make_float2(0.f, 0.f);
    split(v.x, ar.hi[i], ar.lo[i]);
    split(v.y, ai.hi[i], ai.lo[i]);
  }
}

// The B operand at complex row k0 and float column n0 (multiples of 8) of a
// complex plane in shared memory, as stored, split on load; zero past row K.
__device__ __forceinline__ BFrag load_b_plane(const Plane& src, int k0, int n0,
                                              int K, int g, int t) {
  BFrag f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + t + 4 * i;
    split(k < K ? src(k, n0 + g) : 0.f, f.hi[i], f.lo[i]);
  }
  return f;
}

// The B operand of k-step ks and n-tile nt of an [X, 2X] DFT table as
// stored, split and laid out by the wrapper in fragment order: one 16-byte
// load per lane, (b[0] hi, lo, b[1] hi, lo).
__device__ __forceinline__ BFrag load_b_frags(const uint4* __restrict__ frags,
                                              int ks, int nt, int ntiles,
                                              int lane) {
  const uint4 v = __ldg(frags + (ks * ntiles + nt) * 32 + lane);
  BFrag f;
  f.hi[0] = v.x;
  f.lo[0] = v.y;
  f.hi[1] = v.z;
  f.lo[1] = v.w;
  return f;
}

// Compacts the row flags rows[0 .. Y) (1 = the k-space row holds a nonzero
// weight) in place into the ascending list of those rows, and their number
// into *count: warp 0 ballots 32 flags at a time.
__device__ void compact_rows(int* rows, int Y, int* count) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
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

// Pass 2, the y-DFT to a chunk's rows: C [m, X] = fy[rc] [m, Y] s [Y, X],
// s the frame in shared memory. Warp w takes kGroup n-tiles; the split
// table rows stream through shared memory in slices of w = ld / 4 entries
// (cp.async), double-buffered in the chunk planes q and p (kc rows each)
// when one round of n-tiles covers X (X <= 64), else through q alone. The
// accumulators stay in registers to the last slice, so p can take the
// result: epi(i, n, v) for row i < m, float column n (even) < N2. Ends in
// __syncthreads.
template <class Epi>
__device__ __forceinline__ void y_pass(const Plane& s, const float4* fy,
                                       const int* rc, int m, int kc, int Y,
                                       int N2, float* q, float* p, int ld,
                                       const Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const QPlane bq{q, ld}, bp{p, ld};
  const int w = ld / 4;
  const int nslices = (Y + w - 1) / w;
  const int ntiles = (N2 + 7) / 8;
  const int nrounds = (ntiles + kWarps * kGroup - 1) / (kWarps * kGroup);
  const bool twin = nrounds == 1;  // double-buffer in q and p
  for (int round = 0; round < nrounds; ++round) {
    const int nt0 = (round * kWarps + warp) * kGroup;
    CFrag acc[kGroup] = {};
    stage_table<false>(bq, fy, rc, m, kc, Y, 0, w);
    for (int sl = 0; sl < nslices; ++sl) {
      const QPlane cur = (twin && (sl & 1)) ? bp : bq;
      if (twin && sl + 1 < nslices) {
        stage_table<false>((sl & 1) ? bq : bp, fy, rc, m, kc, Y, (sl + 1) * w,
                           w);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int y0 = sl * w;
      const int kw = min(w, Y - y0);
      if (nt0 < ntiles) {
        for (int ks = 0; ks < (kw + 7) / 8; ++ks) {
          AFrag ar, ai;
          load_a_quad(cur, 0, 8 * ks, m, kw, g, t, ar, ai);
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (nt0 + j < ntiles)
              cmma3(acc[j], ar, ai,
                    load_b_plane(s, y0 + 8 * ks, 8 * (nt0 + j), Y, g, t));
        }
      }
      __syncthreads();  // cur is restaged from here on
      if (!twin && sl + 1 < nslices)
        stage_table<false>(bq, fy, rc, m, kc, Y, (sl + 1) * w, w);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int n = 8 * (nt0 + j) + 2 * t;
      if (nt0 + j >= ntiles || n >= N2) continue;
      if (g < m) epi(g, n, finish<1, 1>(acc[j], 0));
      if (g + 8 < m) epi(g + 8, n, finish<1, 1>(acc[j], 1));
    }
    __syncthreads();  // the results are in p before a next round restages
  }
}

// Passes 3 and 4, along x over a chunk: C [m, X] = src [m, X] op(fx), with
// fx's split B fragments from device memory, kBatch k-steps of them loaded
// at once (more would spill at two blocks per SM). The tensor cores sum at
// most kSpan k-steps (128 terms) into a fresh accumulator: the error of
// their float32 sums grows with the count of terms (one sum over a
// 9,000-column readout missed 1e-4). epi(i, n, v, first) for row
// i < m, float column n (even) < N2 stores the span's partial sum v when
// first, else adds it (in float32, rounded to nearest) to what the same
// thread stored; a readout of up to 128 columns is one span.
template <int kSb, class Epi>
__device__ __forceinline__ void x_pass(const Plane& src,
                                       const uint4* __restrict__ fx, int m,
                                       int X, int N2, const Epi& epi) {
  constexpr int kBatch = 2;
  constexpr int kSpan = 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ntiles = (N2 + 7) / 8;
  const int ksteps = (X + 7) / 8;
  for (int nt0 = warp * kGroup; nt0 < ntiles; nt0 += kWarps * kGroup) {
    for (int kp = 0; kp < ksteps; kp += kSpan) {
      const int kend = min(ksteps, kp + kSpan);
      CFrag acc[kGroup] = {};
      for (int ks0 = kp; ks0 < kend; ks0 += kBatch) {
        BFrag b[kBatch][kGroup];
#pragma unroll
        for (int kb = 0; kb < kBatch; ++kb)
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (ks0 + kb < kend && nt0 + j < ntiles)
              b[kb][j] = load_b_frags(fx, ks0 + kb, nt0 + j, ntiles, lane);
#pragma unroll
        for (int kb = 0; kb < kBatch; ++kb) {
          if (ks0 + kb < kend) {
            AFrag ar, ai;
            load_a_plane(src, 0, 8 * (ks0 + kb), m, X, g, t, ar, ai);
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              if (nt0 + j < ntiles) cmma3(acc[j], ar, ai, b[kb][j]);
          }
        }
      }
      const bool first = kp == 0;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int n = 8 * (nt0 + j) + 2 * t;
        if (nt0 + j >= ntiles || n >= N2) continue;
        if (g < m) epi(g, n, finish<1, kSb>(acc[j], 0), first);
        if (g + 8 < m) epi(g + 8, n, finish<1, kSb>(acc[j], 1), first);
      }
    }
  }
}

// Pass 5, the inverse y-DFT from a chunk: C [Y, X] = conj(fy[:, rc]) [Y, m]
// p [m, X], m <= kc <= 16: two k-steps. Warp w takes kGroup n-tiles and
// holds their B operands from p, split once; the split table's columns rc
// stream through q (rows of 16 entries, 8 when kc <= 8) in slices of h
// rows of C (ld / 4 when kc is 8 or 16), and the warp walks their m-tiles.
// epi(r, n, v) for row r < Y, float column n (even) < N2. Ends in
// __syncthreads.
template <class Epi>
__device__ __forceinline__ void inverse_y_pass(const float4* fy, const int* rc,
                                               int m, int kc, int Y, int N2,
                                               const Plane& p, float* q,
                                               int ld, const Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row = kc > 8 ? kChunk : 8;  // entries; the swizzle needs 8
  const QPlane st{q, 4 * row};
  const int h = kc * ld / (4 * row);
  const int ntiles = (N2 + 7) / 8;
  const int nrounds = (ntiles + kWarps * kGroup - 1) / (kWarps * kGroup);
  for (int round = 0; round < nrounds; ++round) {
    const int nt0 = (round * kWarps + warp) * kGroup;
    BFrag b[kChunk / 8][kGroup];
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks)
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        b[ks][j] = load_b_plane(p, 8 * ks, 8 * min(nt0 + j, ntiles - 1), m,
                                g, t);
    for (int y0 = 0; y0 < Y; y0 += h) {
      stage_table<true>(st, fy, rc, m, kc, Y, y0, h);
      cp_async_wait<0>();
      __syncthreads();
      const int hr = min(h, Y - y0);
      for (int r0 = 0; nt0 < ntiles && r0 < hr; r0 += 16) {
        CFrag acc[kGroup] = {};
#pragma unroll
        for (int ks = 0; ks < kChunk / 8; ++ks) {
          if (8 * ks >= m) break;
          AFrag ar, ai;
          load_a_quad(st, r0, 8 * ks, hr, m, g, t, ar, ai);
#pragma unroll
          for (int j = 0; j < kGroup; ++j) cmma3(acc[j], ar, ai, b[ks][j]);
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int n = 8 * (nt0 + j) + 2 * t;
          if (nt0 + j >= ntiles || n >= N2) continue;
          if (r0 + g < hr) epi(y0 + r0 + g, n, finish<-1, 1>(acc[j], 0));
          if (r0 + g + 8 < hr)
            epi(y0 + r0 + g + 8, n, finish<-1, 1>(acc[j], 1));
        }
      }
      __syncthreads();  // q is restaged by the next slice
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
coil_normal_kernel(const float2* __restrict__ x,
                   const float2* __restrict__ maps, const float* __restrict__ w,
                   const float4* __restrict__ fy,
                   const uint4* __restrict__ fx, float2* __restrict__ coil,
                   int E, int C, int T, int Y, int X, int kc) {
  extern __shared__ float smem[];
  const int ld = plane_ld(X);
  const Plane a{smem, ld};                        // [Y][ld]: s_c
  const Plane p{smem + Y * ld, ld};               // [kc][ld]
  const Plane q{smem + (Y + kc) * ld, ld};        // [kc][ld]
  int* rows = reinterpret_cast<int*>(smem + (Y + 2 * kc) * ld);  // [Y], count
  const int X2 = 2 * X;

  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int bb = blockIdx.z;
  const int n = Y * X;
  const long long yx = n;
  const float* wf = w + ((long long)bb * T + t) * yx;

  // 1. coil expansion, a = sum_e maps[bb,e,c] * x[bb,e,t], and the flags of
  //    the k-space rows that hold a nonzero weight; each thread takes
  //    kExpand elements at once, so their loads are in flight together
  long long clk = phase_start();
  for (int y = threadIdx.x; y < Y; y += kThreads) rows[y] = 0;
  __syncthreads();
  const float2* mc = maps + ((long long)bb * E * C + c) * yx;
  const float2* xt = x + ((long long)bb * E * T + t) * yx;
  for (int p0 = threadIdx.x; p0 < n; p0 += kExpand * kThreads) {
    float2 acc[kExpand];
    float wv[kExpand];
#pragma unroll
    for (int u = 0; u < kExpand; ++u) {
      acc[u] = make_float2(0.f, 0.f);
      wv[u] = __ldg(wf + min(p0 + u * kThreads, n - 1));
    }
    for (int e = 0; e < E; ++e) {
      float2 mv[kExpand], v[kExpand];
#pragma unroll
      for (int u = 0; u < kExpand; ++u) {
        const int pp = min(p0 + u * kThreads, n - 1);
        mv[u] = __ldg(mc + (long long)e * C * yx + pp);
        v[u] = __ldg(xt + (long long)e * T * yx + pp);
      }
#pragma unroll
      for (int u = 0; u < kExpand; ++u) cmac(acc[u], mv[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kExpand; ++u) {
      const int pp = p0 + u * kThreads;
      if (pp < n) {
        a.pair(pp / X, 2 * (pp % X)) = acc[u];
        if (wv[u] != 0.f) rows[pp / X] = 1;
      }
    }
  }
  __syncthreads();
  phase_end(clk, 0);
  compact_rows(rows, Y, rows + Y);  // ends in __syncthreads
  const int R = rows[Y];
  phase_end(clk, 1);

  // Passes 2-5 on chunks of up to kc sampled rows; each chunk's inverse
  // y-DFT adds into the coil scratch, which only this block writes, in
  // chunk order. R = 0 still runs one chunk: pass 5 then writes zeros.
  float2* out = coil + ((long long)(bb * T + t) * C + c) * yx;
  for (int i0 = 0; i0 == 0 || i0 < R; i0 += kc) {
    const int m = min(kc, R - i0);
    const int* rc = rows + i0;

    // 2. DFT along y to the chunk's rows (row rc[i] of k-space):
    //    p[i][x] = sum_y fy[rc[i]][y] * a[y][x]
    y_pass(a, fy, rc, m, kc, Y, X2, q.p, p.p, ld,
           [=](int i, int k, float2 v) { p.pair(i, k) = v; });
    phase_end(clk, 2);

    // 3. DFT along x of those rows, then the weight:
    //    q[i][k] = w[rc[i]][k] * sum_x p[i][x] * fx[x][k]
    x_pass<1>(p, fx, m, X, X2, [=](int i, int k, float2 v, bool first) {
      const float wk = __ldg(wf + rc[i] * X + k / 2);
      float2& o = q.pair(i, k);
      o = first ? make_float2(v.x * wk, v.y * wk)
                : make_float2(fmaf(v.x, wk, o.x), fmaf(v.y, wk, o.y));
    });
    __syncthreads();
    phase_end(clk, 3);

    // 4. inverse DFT along x: p[i][x] = sum_k q[i][k] * conj(fx[k][x])
    x_pass<-1>(q, fx, m, X, X2, [=](int i, int k, float2 v, bool first) {
      float2& o = p.pair(i, k);
      o = first ? v : make_float2(o.x + v.x, o.y + v.y);
    });
    __syncthreads();
    phase_end(clk, 4);

    // 5. inverse DFT along y from the chunk's rows, into the coil scratch:
    //    coil[bb,t,c][y][x] (+)= sum_i conj(fy[y][rc[i]]) * p[i][x]. A
    //    thread adds only to the elements it wrote itself in chunk 0; p and
    //    q are free again when it returns.
    const bool first = i0 == 0;
    inverse_y_pass(fy, rc, m, kc, Y, X2, p, q.p, ld,
                   [=](int y, int k, float2 v) {
      float2& o = out[y * X + k / 2];
      o = first ? v : make_float2(o.x + v.x, o.y + v.y);
    });
    phase_end(clk, 5);
  }
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

// The most dynamic shared memory a Hopper block may opt into, in bytes.
constexpr long long kSmemOptin = 232448;

// Dynamic shared memory of one coil_normal_kernel block, in bytes, with
// chunk planes of kc rows: the complex frame and two chunks, rows of
// plane_ld(X) floats, then the list of sampled rows and its length.
long long coil_smem_bytes(int Y, int X, int kc) {
  return (Y + 2LL * kc) * plane_ld(X) * static_cast<long long>(sizeof(float)) +
         (Y + 1LL) * static_cast<long long>(sizeof(int));
}

// Rows of each chunk plane: kChunk, or, for a frame of few rows and a wide
// readout whose two 16-row planes do not fit beside it, the largest power
// of two below that fits (1 if none does).
int coil_chunk_rows(int Y, int X) {
  int kc = kChunk;
  while (kc > 1 && coil_smem_bytes(Y, X, kc) > kSmemOptin) kc /= 2;
  return kc;
}

long long coil_normal_smem_bytes(int Y, int X) {
  return coil_smem_bytes(Y, X, coil_chunk_rows(Y, X));
}

// Launches coil_normal_kernel and coil_combine_kernel on `s`; returns the
// first CUDA error (cudaSuccess = ok).
// Lets coil_normal_kernel take `smem` bytes of dynamic shared memory, with
// the SM's largest shared-memory carveout, so that two blocks fit an SM.
cudaError_t coil_normal_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      coil_normal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(coil_normal_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch_coil_normal(const float2* x, const float2* maps,
                               const float* w, const float4* fy,
                               const uint4* fx, float2* coil, float2* out,
                               int B, int E, int C, int T, int Y, int X,
                               cudaStream_t s) {
  const size_t smem = static_cast<size_t>(coil_normal_smem_bytes(Y, X));
  cudaError_t err = coil_normal_attributes(smem);
  if (err != cudaSuccess) return err;

  const dim3 grid(C, T, B);
  coil_normal_kernel<<<grid, kThreads, smem, s>>>(x, maps, w, fy, fx, coil, E,
                                                  C, T, Y, X,
                                                  coil_chunk_rows(Y, X));
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

// coil_normal_kernel blocks that fit one SM for a Y x X frame (registers,
// threads and shared memory), or -1 on a CUDA error.
extern "C" int coil_normal_blocks_per_sm(int Y, int X) {
  const size_t smem = static_cast<size_t>(coil_normal_smem_bytes(Y, X));
  int n = 0;
  if (coil_normal_attributes(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, coil_normal_kernel,
                                                    kThreads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

#ifdef COIL_NORMAL_PHASES
// Copies the probe's cycles [kPhaseBlocks][kPhases] to host memory dst and
// zeroes them; returns the CUDA error code (0 = ok).
extern "C" int coil_normal_phases(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, coil_phase_cycles,
                                         sizeof(coil_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const long long zeros[kPhaseBlocks][kPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(coil_phase_cycles, zeros, sizeof(zeros)));
}
#endif
