// Warp-level tensor-core and async-copy instructions of sm_80+ (all run on
// Hopper), as PTX wrappers shared by the tensor-core kernels
// (flash_attention.cu, gemm_mma.cuh; the cp.async helpers also
// decode_tile.cuh).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k32"), for lane = 4 * g + t:
//   m16n8k16 bf16  A (16x16, row): a[0] = A[g][2t..2t+1],  a[1] = A[g+8][2t..],
//                                  a[2] = A[g][2t+8..],    a[3] = A[g+8][2t+8..]
//                  B (16x8, col):  b[0] = B[2t..2t+1][g],  b[1] = B[2t+8..][g]
//   m16n8k32 s8    A (16x32, row): a[0] = A[g][4t..4t+3],  a[1] = A[g+8][4t..],
//                                  a[2] = A[g][4t+16..],   a[3] = A[g+8][4t+16..]
//                  B (32x8, col):  b[0] = B[4t..4t+3][g],  b[1] = B[4t+16..][g]
//   C/D (16x8, f32 or s32):        c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..]
// (the lower index in the lower bits of each register).  ``ldmatrix.x4``
// loads four 8x8 matrices of 16-bit elements, lanes 8j..8j+7 giving the row
// addresses of matrix j: lane (g, t) receives row g, elements 2t and 2t+1 of
// each, or with ``.trans`` elements (2t, g) and (2t+1, g).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace wmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d = a * b + d, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b + d, int8 inputs, int32 accumulators (exact)
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; the bytes past ``src_bytes``
// (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared through L1 (``.cg`` takes only 16); zero-filled
// when ``src_bytes`` is 0
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two f32 -> one register of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// (a, b) as hi + lo in bf16 pairs: hi = bf16(a, b), lo = bf16(a - hi, b - hi)
// (the differences are exact in f32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

}  // namespace wmma
