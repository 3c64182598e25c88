// Tensor-core and asynchronous-copy helpers (sm_80+ instructions, used on
// sm_90a): cp.async into shared memory, ldmatrix, and the bf16
// mma.sync.m16n8k16 with float32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major, 4 x bf16x2: a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//     a2 (g, 2t+8..), a3 (g+8, 2t+8..);
//   B 16x8, 2 x bf16x2: b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C 16x8 float: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace karanta {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; src_bytes == 0 writes zeros
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds row l / 4, columns 2(l % 4)..+1 of matrix i
// (of its transpose with .trans)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a * b on the tensor cores, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (exp2(-inf) = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace karanta
