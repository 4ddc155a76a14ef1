// Tensor-core building blocks shared by the port's mma.sync kernels
// (flash_attention.cu, l2dist.cu's self-query tile, block.cu's distance
// matrix): cp.async staging, ldmatrix, the bf16 and tf32 mma.sync
// products, and the 3xTF32 operand split.
//
// 3xTF32.  A float32 product on the TF32 tensor cores keeps full float32
// accuracy when each operand is split, x = hi + lo with hi = tf32_rna(x)
// and lo = tf32_rna(x - hi), and a.b ~ lo.hi + hi.lo + hi.hi (the small
// terms first, into one float32 accumulator), good to about 2^-21 of
// |a||b|.  tf32_rna is cvt.rna.tf32.f32's rounding (nearest, ties away)
// done as two integer operations, the same bits; raw float32 bits fed to
// a tf32 mma would be truncated instead.
//
// Fragment layouts of mma.m16n8k8 (row.col, tf32), g = lane / 4,
// t = lane % 4: a0..a3 = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4);
// b0, b1 = B(t, g), B(t + 4, g); c0..c3 = C(g, 2t), C(g, 2t + 1),
// C(g + 8, 2t), C(g + 8, 2t + 1).  The k order inside a step is free as
// long as A and B agree, so the kernels give k-index t column 2t and
// t + 4 column 2t + 1: a thread's two values of a row are one 8-byte load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past src_bytes (all, for 0) zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// 8 bytes global -> shared (zeroed for src_bytes = 0), for rows that are
// 8-byte but not 16-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes global -> shared (zeroed for src_bytes = 0), for rows that are
// not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b: a 16 x 8 tf32 (row), b 8 x 8 tf32 (col), c 16 x 8 float32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the bits of cvt.rna.tf32.f32 (round to nearest, ties away from zero, to
// 10 mantissa bits) for every finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, each a TF32 value rounded to nearest, ties away from zero
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

}  // namespace
