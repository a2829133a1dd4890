// Tensor-core and asynchronous-copy helpers shared by the tensor-core
// paths of conv_chain.cu, conv_single.cu, invres_block.cu and
// conv_igemm.cu: shared-memory
// addresses, ldmatrix (plain and transposed), the bf16 m16n8k16 mma.sync
// with f32 accumulators, the s8 m16n8k32 mma.sync with s32 accumulators,
// the tf32 m16n8k8 mma.sync and the split of f32 values into TF32 hi and
// lo (3xTF32), the symmetric int8 quantizer, cp.async with zero fill, and
// bf16 packing and pair stores.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4*g + t):
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, k x n):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16x8, f32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// ldmatrix.x4 takes one 16-byte row address from each lane: lanes 8i to
// 8i+7 give the rows of matrix i, which lands in register i. So for A,
// lane l points at row (l & 15), columns 8 * (l >> 4); for B stored k-major
// ([k][n], n contiguous) through .trans, lane l points at k row (l & 15)
// of the 16-row step, columns 8 * (l >> 4) past the first n-tile, and the
// registers are b0, b1 of that n-tile, then b0, b1 of the next.
//
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (four int8 per register):
//   A (16x32, row-major): a0 = A[g][4t..4t+3],    a1 = A[g+8][4t..4t+3],
//                         a2 = A[g][4t+16..4t+19], a3 = A[g+8][4t+16..4t+19]
//   B (32x8, k x n):      b0 = B[4t..4t+3][g],    b1 = B[4t+16..4t+19][g]
//   C (16x8, s32):        as the f32 C above.
// ldmatrix moves 16-byte rows, so the A addressing is the bf16 one (a row
// of 16 int8 is a row of 8 bf16). It has no 8-bit transpose: B is stored
// n-major ([n][k], k contiguous) and read without .trans, one 8-row matrix
// per (n-tile, 16 k): lane l of an .x4 points at n row (l & 7) + 8 (l >> 4),
// k byte 16 ((l >> 3) & 1), giving b0, b1 of one n-tile, then of the next.
//
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (one 32-bit value per register):
//   A (16x8, row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8x8, k x n):      b0 = B[t][g], b1 = B[t+4][g]
//   C (16x8, f32):       as above.
// An 8x8 b16 matrix of ldmatrix is 8 rows of four f32, and thread 4g+t
// receives the f32 (g, t) of it: so A, f32 rows with k contiguous, is read
// with the bf16 A addressing (lane l: row (l & 15), float 4 (l >> 4)), and
// B, stored n-major as no 32-bit transpose exists, with the s8 B addressing
// (lane l of an .x4: n row (l & 7) + 8 (l >> 4), float 4 ((l >> 3) & 1);
// b0, b1 of one n-tile, then of the next).
//
// 3xTF32: v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), both rounded
// to nearest, ties away (as cvt.rna); v - hi is exact in f32 and hi + lo equals
// v within 2^-22 |v|. A product is a_hi b_lo + a_lo b_hi + a_hi b_hi with f32
// sums (the small terms first), about f32's accuracy; a_lo b_lo (2^-22
// relative) is dropped. An operand exact in TF32 (an int8 weight, a bf16
// input) has lo = 0, and its pass is skipped.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Two matrices: lanes 0-15 give the addresses (the others are ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16 bf16) * b (16x8 bf16), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8 tf32) * b (8x8 tf32), f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> tf32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero;
// the low 13 bits zero), in two integer operations: nvcc expands cvt.rna
// into about four, an Inf/NaN test among them, and the splits are most of
// the f32 forms' instructions. Equal to cvt.rna for every finite value.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// N f32 fragment registers (bit patterns) split into their tf32 hi and lo.
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&v)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(__uint_as_float(v[i]));
    lo[i] = tf32_rna(__uint_as_float(v[i]) - __uint_as_float(hi[i]));
  }
}

// c += a (16x32 s8) * b (32x8 s8), s32 accumulators: exact.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The symmetric int8 quantizer of the JAX kernels: v * inv (inv = 1/scale,
// a float32 constant) rounded half to even, clipped to +-127.
__device__ __forceinline__ int quant_s8(float v, float inv) {
  return max(-127, min(127, __float2int_rn(v * inv)));
}

// Four quantized values as one register, the first in the low byte.
__device__ __forceinline__ uint32_t pack_s8x4(int q0, int q1, int q2, int q3) {
  return (uint32_t)(q0 & 0xff) | (uint32_t)(q1 & 0xff) << 8 | (uint32_t)(q2 & 0xff) << 16 |
         (uint32_t)(q3 & 0xff) << 24;
}

// 16 bytes global -> shared without passing through registers; the first
// `bytes` (0..16) are read, the rest of the 16 are zero-filled. dst and
// src are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// 4 bytes, zero-filled when `valid` is false; dst and src 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent output values, one rounding each to the output dtype.
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
}

}  // namespace
