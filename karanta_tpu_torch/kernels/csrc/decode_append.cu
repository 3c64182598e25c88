// Fused KV append + decode attention over a cache in the activations' dtype
// (the bf16 KV cache) for one layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/decode_attention.py:582
// paged_decode_append (body _decode_append_kernel :337-525). For each slot b
// it writes this step's K/V rows at cache_len[b] of layer `layer`, in place,
// then attends over rows [0, cache_len[b]) and folds the new row in last, in
// float32.
//
// What bounds it on this card: every cache byte is used once per step for
// about G flops (G query heads per kv head), so the kernel is bound by
// device-memory bytes: B * KVH * live_rows * D * 2 * sizeof(T) per layer at
// 3.35 TB/s. It reads only the live rows, where the JAX package's dense path
// reads the whole bucket; that is why the port launches it at every bucket
// while the JAX decoder takes its Pallas kernel only from 8192 rows on (each
// Pallas call costs ~125 us of TPU dispatch, a launch here a few us).
//
// The bf16 instance is decode_split_kernel (decode_split.cuh, with
// kAppend = true), the one body it shares with the read-only kernels #8 and
// #9: each slot's rows [0, cache_len) split into runs of 1,024 rows over
// blocks, a cp.async ring per warp, Q.K^T and P.V on the tensor cores
// (mma.sync bf16, float32 accumulators) with P rounded to bf16 before P.V as
// the TPU kernel rounds it (decode_attention.py:487), and a last-block merge
// of the runs' partials in a fixed order. The block of run 0 writes the new
// row at cache_len (no block reads it), and the block that finishes the
// slot folds it in last, in float32, from the inputs, then normalises.
//
// The float32 instance stays on the CUDA cores (the tensor cores would
// multiply in TF32): one block per (kv head, slot) owns that slab: it writes
// row cache_len itself and only reads rows below it, so nothing races. The
// rows below cache_len go through attend_rows (decode_rows.cuh, shared with
// the read-only kernels' float32 instance); the new row folds in last, from
// registers, and the probabilities stay in float32.
#include "decode_rows.cuh"
#include "decode_split.cuh"

namespace karanta {

template <typename T, int D, int G>
__global__ void __launch_bounds__(kRowThreads) decode_append_kernel(
    const T* __restrict__ q,                                   // (B, KVH*G, D)
    const T* __restrict__ new_k, const T* __restrict__ new_v,  // (B, KVH, D)
    T* __restrict__ k_cache, T* __restrict__ v_cache,          // (L, B, KVH, M, D)
    const int* __restrict__ cache_len,                         // (B,)
    T* __restrict__ out,                                       // (B, KVH*G, D)
    int B, int KVH, int M, int layer, float scale) {
  constexpr int kWarps = kRowThreads / 32;
  __shared__ RowSmem<T, D, G> sm;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = KVH * G;
  // rows already present; the engine keeps it below M, the clamp only
  // keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), M - 1);

  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  T* k_rows = k_cache + slab * D;
  T* v_rows = v_cache + slab * D;
  const size_t nrow = static_cast<size_t>(b) * KVH + kvh;

  // 1. append: row `len` of this slab (read by nobody in this step)
  for (int d = tid; d < D; d += kRowThreads) {
    k_rows[static_cast<size_t>(len) * D + d] = new_k[nrow * D + d];
    v_rows[static_cast<size_t>(len) * D + d] = new_v[nrow * D + d];
  }

  // 2. attend over rows [0, len)
  float acc[G];
  attend_rows<T, D, G>(sm, q + (static_cast<size_t>(b) * H + kvh * G) * D, k_rows, v_rows,
                       len, scale, acc);

  // 3. fold in the new row in float32
  for (int g = warp; g < G; g += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += sm.q[g][d] * to_f<T>(new_k[nrow * D + d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) {
      const float s_x = dot * scale;
      const float m_new = fmaxf(sm.m[g], s_x);
      const float p_x = __expf(s_x - m_new);
      const float alpha = __expf(sm.m[g] - m_new);
      sm.l[g] = alpha * sm.l[g] + p_x;
      sm.alpha[g] = alpha;
      sm.px[g] = p_x;
    }
  }
  __syncthreads();
  if (tid < D) {
    const float nv = to_f<T>(new_v[nrow * D + tid]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = acc[g] * sm.alpha[g] + sm.px[g] * nv;
      const float l = sm.l[g] == 0.f ? 1.f : sm.l[g];
      out[(static_cast<size_t>(b) * H + kvh * G + g) * D + tid] = from_f<T>(a / l);
    }
  }
}

template <typename T, int D, int G>
cudaError_t launch_append(const void* q, const void* nk, const void* nv, void* kc,
                          void* vc, const int* lens, void* out, int B, int KVH, int M,
                          int layer, float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_append_kernel<T, D, G><<<grid, kRowThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<T*>(kc), static_cast<T*>(vc), lens, static_cast<T*>(out), B, KVH, M,
      layer, scale);
  return cudaGetLastError();
}

template <int D, int G>
cudaError_t launch_pair(int dtype, const void* q, const void* nk, const void* nv, void* kc,
                        void* vc, const int* lens, void* out, float* partials, int* counters,
                        int B, int KVH, int M, int layer, float scale, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_split<D, G, true>(q, nk, nv, nullptr, nullptr, kc, vc, nullptr, nullptr, lens,
                                    out, partials, counters, B, KVH, M, layer, kSplitRows, scale,
                                    st);
  }
  if (dtype == kFloat32) {
    return launch_append<float, D, G>(q, nk, nv, kc, vc, lens, out, B, KVH, M, layer, scale,
                                      st);
  }
  return cudaErrorInvalidValue;
}

#define KARANTA_APPEND_CASE(DD, GG)                                                         \
  if (D == DD && G == GG)                                                                    \
    return static_cast<int>(launch_pair<DD, GG>(dtype, q, nk, nv, kc, vc, lens, out, partials, \
                                                counters, B, KVH, M, layer, scale,           \
                                                static_cast<cudaStream_t>(stream)));

inline int append_entry(const void* q, const void* nk, const void* nv, void* kc, void* vc,
                        const int* lens, void* out, float* partials, int* counters, int B,
                        int KVH, int G, int M, int D, int layer, float scale, int dtype,
                        void* stream) {
  KARANTA_ROW_PAIRS(KARANTA_APPEND_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef KARANTA_APPEND_CASE

}  // namespace karanta

// C interface (loaded with ctypes). The caches are updated in place and hold
// the activations' dtype. Returns the CUDA error code of the launch;
// cudaErrorInvalidValue for a (D, G) pair without an instantiation. The bf16
// instance needs `partials`, float32 (B * KVH * ceil(M / split_rows) *
// (8 D + 16), split_rows from karanta_decode_append_info), and `counters`,
// int32 (B * KVH), zero before the first call (each call leaves them zero;
// the read-only kernels' counters may be the same array on one stream); the
// float32 instance ignores both.
extern "C" int karanta_decode_append(const void* q, const void* new_k, const void* new_v,
                                     void* k_cache, void* v_cache, const int* cache_len,
                                     void* out, float* partials, int* counters, int B,
                                     int KVH, int G, int M, int D, int layer, float scale,
                                     int dtype, void* stream) {
  return karanta::append_entry(q, new_k, new_v, k_cache, v_cache, cache_len, out, partials,
                               counters, B, KVH, G, M, D, layer, scale, dtype, stream);
}

#define KARANTA_APPEND_SUPPORTED(DD, GG) \
  if (D == DD && G == GG) return 1;

// (D, G) pairs with an instantiation, for the wrapper's checks
extern "C" int karanta_decode_append_supported(int D, int G) {
  KARANTA_ROW_PAIRS(KARANTA_APPEND_SUPPORTED)
  return 0;
}

#define KARANTA_APPEND_INFO(DD, GG) \
  if (D == DD && G == GG) return static_cast<int>(karanta::split_info<DD, GG, true>(info));

// info[5] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, resident blocks per SM and rows per block of the
// bf16 instance for (D, G). Returns the CUDA error code.
extern "C" int karanta_decode_append_info(int D, int G, int* info) {
  KARANTA_ROW_PAIRS(KARANTA_APPEND_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
