// Read-only, length-bounded decode attention over a cache in the activations'
// dtype (the bf16 KV cache), for Hopper (sm_90a). One kernel, two entry
// points:
//
// - karanta_decode_attention replaces karanta_tpu/ops/decode_attention.py:120
//   paged_decode_attention (body _decode_kernel :38): a per-slot cache
//   (B, KVH, M, D);
// - karanta_decode_attention_stacked replaces :272
//   paged_decode_attention_stacked (body _decode_kernel_stacked :172): layer
//   `layer` of the stacked cache (L, B, KVH, M, D), read in place.
//
// Slot b attends over rows [0, cache_len[b]]: this step's row was written at
// cache_len[b] before the call (the decoder's stacked mode scatters it).
// Nothing is written to the caches.
//
// What bounds it on this card: every live cache byte is used once per call
// for about G flops, so device-memory bytes bound it:
// KVH * sum_b (cache_len[b] + 1) * D * 2 * sizeof(T) at 3.35 TB/s.
//
// The bf16 instance is decode_split_kernel (decode_split.cuh, with
// kAppend = false), the one body it shares with kernel #5's bf16 instance:
// flash-decoding on the tensor cores, each slot's rows split into runs of
// 1,024 over blocks, a cp.async ring per warp, a last-block merge of the
// runs' partials in a fixed order (two calls give the same bits).
//
// The float32 instance (decode_attention_kernel) stays on the CUDA cores
// (the tensor cores would multiply in TF32): one block per (kv head, slot)
// runs attend_rows (decode_rows.cuh, shared with kernel #5) over its
// cache_len + 1 rows and normalises, keeping the probabilities in float32.
#include "decode_rows.cuh"
#include "decode_split.cuh"

namespace karanta {

// ---------------------------------------------------------------------------
// float32: CUDA cores (attend_rows, shared with kernel #5)
// ---------------------------------------------------------------------------

template <typename T, int D, int G>
__global__ void __launch_bounds__(kRowThreads) decode_attention_kernel(
    const T* __restrict__ q,                                 // (B, KVH*G, D)
    const T* __restrict__ k_cache, const T* __restrict__ v_cache,  // (L, B, KVH, M, D)
    const int* __restrict__ cache_len,                       // (B,)
    T* __restrict__ out,                                     // (B, KVH*G, D)
    int B, int KVH, int M, int layer, float scale) {
  __shared__ RowSmem<T, D, G> sm;
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = KVH * G;
  // rows [0, len]; the clamp keeps a bad value inside the slab
  const int len = min(max(cache_len[b], 0), M - 1);
  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;

  float acc[G];
  attend_rows<T, D, G>(sm, q + (static_cast<size_t>(b) * H + kvh * G) * D,
                       k_cache + slab * D, v_cache + slab * D, len + 1, scale, acc);
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float l = sm.l[g] == 0.f ? 1.f : sm.l[g];
      out[(static_cast<size_t>(b) * H + kvh * G + g) * D + tid] = from_f<T>(acc[g] / l);
    }
  }
}

template <typename T, int D, int G>
cudaError_t launch_attention(const void* q, const void* kc, const void* vc,
                             const int* lens, void* out, int B, int KVH, int M, int layer,
                             float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_attention_kernel<T, D, G><<<grid, kRowThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lens,
      static_cast<T*>(out), B, KVH, M, layer, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <int D, int G>
cudaError_t launch_pair(int dtype, const void* q, const void* kc, const void* vc,
                        const int* lens, void* out, float* partials, int* counters, int B,
                        int KVH, int M, int layer, float scale, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_split<D, G, false>(q, nullptr, nullptr, nullptr, nullptr, kc, vc, nullptr,
                                     nullptr, lens, out, partials, counters, B, KVH, M, layer,
                                     kSplitRows, scale, st);
  }
  if (dtype == kFloat32) {
    return launch_attention<float, D, G>(q, kc, vc, lens, out, B, KVH, M, layer, scale, st);
  }
  return cudaErrorInvalidValue;
}

#define KARANTA_ATTENTION_CASE(DD, GG)                                                  \
  if (D == DD && G == GG)                                                                \
    return static_cast<int>(launch_pair<DD, GG>(dtype, q, kc, vc, lens, out, partials,   \
                                                counters, B, KVH, M, layer, scale,       \
                                                static_cast<cudaStream_t>(stream)));

inline int attention_entry(const void* q, const void* kc, const void* vc, const int* lens,
                           void* out, float* partials, int* counters, int B, int KVH, int G,
                           int M, int D, int layer, float scale, int dtype, void* stream) {
  KARANTA_ROW_PAIRS(KARANTA_ATTENTION_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef KARANTA_ATTENTION_CASE

}  // namespace karanta

// C interface (loaded with ctypes). Returns the CUDA error code of the launch;
// cudaErrorInvalidValue for a (D, G) pair without an instantiation. The bf16
// instance needs `partials`, float32 (B * KVH * ceil(M / split_rows) *
// (8 D + 16), split_rows from karanta_decode_attention_info), and
// `counters`, int32 (B * KVH), zero before the first call (each call leaves
// them zero); the float32 instance ignores both.

// per-slot cache (B, KVH, M, D)
extern "C" int karanta_decode_attention(const void* q, const void* k_cache,
                                        const void* v_cache, const int* cache_len,
                                        void* out, float* partials, int* counters, int B,
                                        int KVH, int G, int M, int D, float scale, int dtype,
                                        void* stream) {
  return karanta::attention_entry(q, k_cache, v_cache, cache_len, out, partials, counters,
                                  B, KVH, G, M, D, 0, scale, dtype, stream);
}

// layer `layer` of the stacked cache (L, B, KVH, M, D)
extern "C" int karanta_decode_attention_stacked(const void* q, const void* k_cache,
                                                const void* v_cache, const int* cache_len,
                                                void* out, float* partials, int* counters,
                                                int B, int KVH, int G, int M, int D,
                                                int layer, float scale, int dtype,
                                                void* stream) {
  return karanta::attention_entry(q, k_cache, v_cache, cache_len, out, partials, counters,
                                  B, KVH, G, M, D, layer, scale, dtype, stream);
}

#define KARANTA_ATTENTION_SUPPORTED(DD, GG) \
  if (D == DD && G == GG) return 1;

// (D, G) pairs with an instantiation, for the wrappers' checks
extern "C" int karanta_decode_attention_supported(int D, int G) {
  KARANTA_ROW_PAIRS(KARANTA_ATTENTION_SUPPORTED)
  return 0;
}

#define KARANTA_ATTENTION_INFO(DD, GG) \
  if (D == DD && G == GG) return static_cast<int>(karanta::split_info<DD, GG, false>(info));

// info[5] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, resident blocks per SM and rows per block of the
// bf16 instance for (D, G). Returns the CUDA error code.
extern "C" int karanta_decode_attention_info(int D, int G, int* info) {
  KARANTA_ROW_PAIRS(KARANTA_ATTENTION_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
