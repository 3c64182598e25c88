// Shared device helpers for the port's attention kernels (sm_90a).
//
// Every kernel is templated on the element type T of its activations:
// float (tests and the CPU-vs-card check at small sizes) or __nv_bfloat16
// (the serving path). Arithmetic is float32 throughout; values round to T
// only where the JAX kernel rounds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace karanta {

constexpr float kNegInf = -1e30f;  // finite mask value, as the TPU kernels use

// element-type codes passed through the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float through T and back (the JAX kernels' astype(q.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Load a contiguous row of D elements as 16-byte vectors into float registers.
// The row must start on a 16-byte boundary (the wrappers check the base
// pointers; row pitches are multiples of 16 bytes for every D they admit).
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ src, float (&dst)[D]) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(D % kVec == 0, "row is not a whole number of 16-byte vectors");
#pragma unroll
  for (int i = 0; i < D / kVec; ++i) {
    const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[i * kVec + j] = to_f<T>(e[j]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const float (&src)[D]) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(D % kVec == 0, "row is not a whole number of 16-byte vectors");
#pragma unroll
  for (int i = 0; i < D / kVec; ++i) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) e[j] = from_f<T>(src[i * kVec + j]);
    reinterpret_cast<uint4*>(dst)[i] = raw;
  }
}

// an unsigned type of N bytes, for one vector load of N int8 values
template <int N> struct Bytes;
template <> struct Bytes<16> { using type = uint4; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<4> { using type = unsigned int; };
template <> struct Bytes<2> { using type = unsigned short; };

// The int4 KV cache's layout (models/qwen25_vl/decoder.py Q4KVCache): in each
// 64-token window w, token 64w + j (j < 32) sits in the low nibble of packed
// row 32w + j and token 64w + 32 + j in the high nibble of the same row; the
// scale of kv head h sits in plane 2h + nibble, column = packed row.
__device__ __forceinline__ int q4_row(int tok) { return ((tok >> 6) << 5) + (tok & 31); }
__device__ __forceinline__ int q4_nib(int tok) { return (tok >> 5) & 1; }
// packed rows that hold a token below len: whole windows, then the partial
// window's rows whose low token is live (decode_attention.py:1421-1422)
__device__ __forceinline__ int q4_live_rows(int len) {
  return (len >> 6) * 32 + min(len & 63, 32);
}
// sign-extended nibbles of a packed byte b (an int8 widened to int)
__device__ __forceinline__ int q4_lo(int b) {
  return static_cast<int>(static_cast<unsigned>(b) << 28) >> 28;
}
__device__ __forceinline__ int q4_hi(int b) { return b >> 4; }
// the packed byte `old` with nibble `nib` replaced by the low 4 bits of v
__device__ __forceinline__ int8_t q4_merge(int8_t old, int8_t v, int nib) {
  const int o = static_cast<unsigned char>(old);
  const int n4 = v & 0xF;
  const int merged = nib ? ((o & 0x0F) | (n4 << 4)) : ((o & 0xF0) | n4);
  return static_cast<int8_t>(static_cast<unsigned char>(merged));
}

// token of key kk (0..15) of key tile p of the chunk that starts at stored
// row c0 (a multiple of 16): one token a row for bf16 (kBits 16) and int8
// rows, two for packed int4 rows (q4_row)
template <int kBits>
__device__ __forceinline__ int chunk_token(int c0, int p, int kk) {
  if constexpr (kBits != 4) {
    return c0 + kk;
  } else {
    const int pr = c0 + kk;
    return ((pr >> 5) << 6) + 32 * p + (pr & 31);
  }
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace karanta
