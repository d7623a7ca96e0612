// Split-TF32 matrix products on Hopper's tensor cores at float32 accuracy,
// and the cp.async tile loads that feed them: shared by the float32
// attention kernels (flash_attention.cu's forward, flash_attention_bwd.cu's
// dK/dV and dQ kernels).
//
// A float32 x is split in registers into hi = tf32(x) (10 mantissa bits)
// and lo = x - hi (the tensor core reads its top 10); a product a * b is
// taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b (the small ones first), dropping
// lo_a lo_b (~2^-22 of it): three TF32 mma.sync m16n8k8 per float32 one,
// accumulated in float32. This is the scheme of PyTorch's own float32
// attention (CUTLASS's OpMultiplyAddFastF32); it runs at a third of the
// dense TF32 rate, 495 / 3 = 165 TFLOP/s, against 67 TFLOP/s of float32
// FMAs on the CUDA cores.
//
// Why mma.sync and not wgmma: wgmma takes .tf32 operands K-major only (its
// transpose bits are for 16-bit types). That fits S = Q K^T and dP = dO V^T
// in their natural layouts, but not O += P V, dV = P^T dO, dK = dS^T Q or
// dQ = dS K, whose B operand is row-major over the reduced dimension: each
// would need a transposed copy in shared memory. mma.sync with fragments
// loaded from padded shared memory takes either layout, and its A operand
// can come straight from an earlier product's accumulators (mma_pn).
//
// One warp computes a 16-row slab. Fragments of m16n8k8 (g = lane / 4,
// t = lane % 4): A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0, c1
// (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1). A C fragment is an A
// fragment of the next product once its 8 columns are taken in the order
// 2t -> k = t, 2t + 1 -> k = t + 4; the B operand's rows are read in the
// same order, so no shuffle is needed. Tiles in shared memory are row-major
// with a row stride of D + 4 floats (4 mod 32 banks): every fragment load
// below hits 32 distinct banks.
//
// Each source that includes this header gets its own copy (internal
// linkage); _build.py hashes the headers with the sources.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, half away from
// zero, by integer ops: two instructions where cvt.rna.tf32.f32 takes more),
// lo = x - hi exactly, handed to the tensor core as it is (it reads lo's
// top 10 mantissa bits: ~2^-22 of x left out, as much as lo lo)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n0 + i] += a b[i] at float32 accuracy for the CH blocks i: the two
// small products, then hi hi, each pass over all CH accumulators so that
// consecutive mma.sync are independent (a pass on one accumulator would
// wait out the tensor core's latency three times)
template <int CH, int NB>
__device__ __forceinline__ void mma3(float (&acc)[NB][4], int n0, const FragA& a,
                                     const FragB (&b)[CH]) {
#pragma unroll
  for (int i = 0; i < CH; ++i) mma_tf32(acc[n0 + i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < CH; ++i) mma_tf32(acc[n0 + i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < CH; ++i) mma_tf32(acc[n0 + i], a.hi, b[i].hi);
}

// B fragments split at a time: 8 (32 registers) keep 8 independent
// accumulators in flight
template <int NB>
constexpr int kChunk = NB < 8 ? NB : 8;

// acc (16 x 8 NB) += A T^T over K columns: A the warp's 16 rows, T 8 NB
// rows, both row-major in shared memory with row stride ld (the S = Q K^T
// form: both operands in their natural layout).
template <int NB, int K>
__device__ __forceinline__ void mma_nt(float (&acc)[NB][4], const float* A, const float* T,
                                       int ld) {
  constexpr int CH = kChunk<NB>;
  static_assert(NB % CH == 0, "whole chunks");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = A + g * ld + t;
  const float* b = T + g * ld + t;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    const FragA fa = frag_a(a[k], a[8 * ld + k], a[k + 4], a[8 * ld + k + 4]);
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += CH) {
      FragB fb[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        fb[i] = frag_b(b[8 * (n0 + i) * ld + k], b[8 * (n0 + i) * ld + k + 4]);
      mma3(acc, n0, fa, fb);
    }
  }
}

// acc (16 x 8 NB) += P T over 8 KB rows of T: P (16 x 8 KB) the C fragments
// p of an earlier product, T row-major in shared memory with row stride ld,
// its first column at T (the O += P V form).
template <int NB, int KB>
__device__ __forceinline__ void mma_pn(float (&acc)[NB][4], const float (&p)[KB][4],
                                       const float* T, int ld) {
  constexpr int CH = kChunk<NB>;
  static_assert(NB % CH == 0, "whole chunks");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const FragA fa = frag_a(p[j][0], p[j][2], p[j][1], p[j][3]);
    const float* b = T + (8 * j + 2 * t) * ld + g;
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += CH) {
      FragB fb[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) fb[i] = frag_b(b[8 * (n0 + i)], b[ld + 8 * (n0 + i)]);
      mma3(acc, n0, fa, fb);
    }
  }
}

// -- cp.async ----------------------------------------------------------------

// 16 bytes from global to shared memory; zeros instead when !in (src is not
// read then, but must be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) of an operand whose row i starts at src + i * stride
// (D contiguous floats, 16-byte aligned) into R rows of D + 4 floats in
// shared memory, rows at or past S as zeros; the block's THREADS threads
// each issue 16-byte copies, consecutive threads on consecutive addresses
template <int R, int D, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride,
                                          int r0, int S) {
  constexpr int C = D / 4;  // 16-byte chunks of a row
  static_assert(R * C % THREADS == 0, "whole steps of the block's threads");
#pragma unroll
  for (int i = 0; i < R * C / THREADS; ++i) {
    const int c = i * THREADS + threadIdx.x, r = c / C, col = (c % C) * 4;
    const bool in = r0 + r < S;
    cp_async16(dst + r * (D + 4) + col, in ? src + (r0 + r) * stride + col : src, in);
  }
}

}  // namespace
