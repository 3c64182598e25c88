// Tensor-core and asynchronous-copy helpers (sm_80+ instructions, used on
// sm_90a): cp.async into shared memory, ldmatrix, the bf16
// mma.sync.m16n8k16 with float32 accumulators, and the exact conversions of
// int8 and packed int4 cache rows to bf16 operands.
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

constexpr float kLog2e = 1.4426950408889634f;

// eight int8 values (one 8-byte word pair) -> eight bf16, exactly: the bytes
// biased to unsigned become the low mantissa bits of 2^23 + 128 + b, and the
// float subtraction of 2^23 + 128 gives b
__device__ __forceinline__ uint4 int8x8_to_bf16(uint2 raw) {
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
  uint32_t r[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float lo = __uint_as_float(__byte_perm(w[h], 0x4B000000u, 0x7440 + 2 * p)) -
                       8388736.f;
      const float hi = __uint_as_float(__byte_perm(w[h], 0x4B000000u, 0x7441 + 2 * p)) -
                       8388736.f;
      r[2 * h + p] = pack_bf16(lo, hi);
    }
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// eight packed int4 bytes (one 8-byte word pair) -> their eight low nibbles
// and their eight high nibbles as bf16, exactly. Each nibble n is biased to
// n + 8 in [0, 15]; a prmt spreads two bytes to the two halves of a word, a
// mask puts a nibble into the low mantissa bits of the bf16 128 + (n + 8),
// and one packed bf16 subtraction of 136 gives n.
__device__ __forceinline__ void int4x8_to_bf16(uint2 raw, uint4& lo, uint4& hi) {
  const uint32_t w[2] = {raw.x ^ 0x88888888u, raw.y ^ 0x88888888u};
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t l[4], h[4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      // bytes 2p and 2p + 1 of word k to bytes 0 and 2
      const uint32_t pair = __byte_perm(w[k], 0u, 0x4140 + 0x0202 * p);
      uint32_t x = (pair & 0x000F000Fu) | 0x43004300u;
      uint32_t y = ((pair >> 4) & 0x000F000Fu) | 0x43004300u;
      __nv_bfloat162 xv = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x), bias);
      __nv_bfloat162 yv = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&y), bias);
      l[2 * k + p] = *reinterpret_cast<uint32_t*>(&xv);
      h[2 * k + p] = *reinterpret_cast<uint32_t*>(&yv);
    }
  }
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
}

// Rows [r_lo, r_lo + kRows) of one landed chunk of a quantized cache (stored
// K rows 0..15, then V rows 16..31, pitch D) into a bf16 stage (pitch P): int8 row rr
// to stage row rr (K keys 0..15, V keys 16..31); packed int4 row rr to stage
// rows lo(rr) (its low nibbles) and lo(rr) + 16 (its high nibbles), with
// lo(rr) = rr for K and rr + 16 for V (K tiles 0..31, V tiles 32..63).
template <int kBits, int D, int P, int kRows>
__device__ __forceinline__ void stage_rows(const int8_t* __restrict__ src,
                                           __nv_bfloat16* __restrict__ dst, int r_lo,
                                           int lane) {
  constexpr int kV = D / 8;  // 8-byte vectors per row
#pragma unroll
  for (int c = lane; c < kRows * kV; c += 32) {
    const int r = r_lo + c / kV, col = (c % kV) * 8;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + r * D + col);
    if constexpr (kBits == 8) {
      *reinterpret_cast<uint4*>(dst + r * P + col) = int8x8_to_bf16(raw);
    } else {
      const int lo_row = r < 16 ? r : r + 16;
      uint4 lo, hi;
      int4x8_to_bf16(raw, lo, hi);
      *reinterpret_cast<uint4*>(dst + lo_row * P + col) = lo;
      *reinterpret_cast<uint4*>(dst + (lo_row + 16) * P + col) = hi;
    }
  }
}

}  // namespace karanta
