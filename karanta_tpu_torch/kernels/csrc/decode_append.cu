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
// Design: the structure of decode_append_quant.cu over rows of T. One block
// per (kv head, slot) owns that slab: it writes row cache_len itself and
// only reads rows below it, so nothing races. Rows stream in chunks of
// 16 KB per cache, staged in shared memory with 16-byte loads; eight lanes
// share a row (D/8 elements each), dot it against all G query heads held in
// registers and reduce with three shuffles; one warp per head turns the
// chunk's scores into probabilities (online softmax across chunks); then
// each thread owns one output dim and accumulates the chunk's V column for
// all G heads.
#include "common.cuh"

namespace karanta {

constexpr int kAppThreads = 128;
constexpr int kAppLanesPerRow = 8;

// N consecutive elements of T from shared memory into float registers, with
// 16-byte loads where the run is a whole number of them
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* __restrict__ src, float (&dst)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kVec = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N / kVec; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[i * kVec + j] = to_f<T>(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f<T>(src[i]);
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kAppThreads) decode_append_kernel(
    const T* __restrict__ q,                                   // (B, KVH*G, D)
    const T* __restrict__ new_k, const T* __restrict__ new_v,  // (B, KVH, D)
    T* __restrict__ k_cache, T* __restrict__ v_cache,          // (L, B, KVH, M, D)
    const int* __restrict__ cache_len,                         // (B,)
    T* __restrict__ out,                                       // (B, KVH*G, D)
    int B, int KVH, int M, int layer, float scale) {
  constexpr int DL = D / kAppLanesPerRow;  // elements per lane
  constexpr int kWarps = kAppThreads / 32;
  constexpr int kRowsPerPass = kWarps * (32 / kAppLanesPerRow);  // 16
  constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static_assert(kRowBytes % 16 == 0, "rows must be whole 16-byte vectors");
  constexpr int kChunk = (16384 / kRowBytes) < 128 ? (16384 / kRowBytes) : 128;
  constexpr int kVecPerRow = kRowBytes / 16;

  __shared__ float q_s[G][D];
  __shared__ float p_s[G][kChunk];
  __shared__ float m_s[G], l_s[G], alpha_s[G], px_s[G];
  __shared__ __align__(16) T k_s[kChunk * D];
  __shared__ __align__(16) T v_s[kChunk * D];

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
  for (int d = tid; d < D; d += kAppThreads) {
    k_rows[static_cast<size_t>(len) * D + d] = new_k[nrow * D + d];
    v_rows[static_cast<size_t>(len) * D + d] = new_v[nrow * D + d];
  }

  for (int i = tid; i < G * D; i += kAppThreads) {
    q_s[i / D][i % D] = to_f<T>(q[(static_cast<size_t>(b) * H + kvh * G + i / D) * D + i % D]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int sub = lane % kAppLanesPerRow;   // which DL-wide slice of the row
  const int rg = lane / kAppLanesPerRow;    // row within the warp's pass
  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DL; ++i) qr[g][i] = q_s[g][sub * DL + i];
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  // 2. attend over rows [0, len), one staged chunk at a time
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    const int n = min(kChunk, len - c0);
    for (int t = tid; t < n * kVecPerRow; t += kAppThreads) {
      const size_t off = static_cast<size_t>(c0) * kRowBytes + static_cast<size_t>(t) * 16;
      reinterpret_cast<uint4*>(k_s)[t] =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(k_rows) + off);
      reinterpret_cast<uint4*>(v_s)[t] =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(v_rows) + off);
    }
    __syncthreads();

    for (int base = 0; base < n; base += kRowsPerPass) {
      const int jj = base + warp * (32 / kAppLanesPerRow) + rg;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (jj < n) {
        float kv[DL];
        load_vals<T, DL>(k_s + jj * D + sub * DL, kv);
#pragma unroll
        for (int i = 0; i < DL; ++i) {
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] += qr[g][i] * kv[i];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 1);
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 2);
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 4);
      }
      if (jj < n && sub == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) p_s[g][jj] = part[g] * scale;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, p_s[g][jj]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < n; jj += 32) {
        const float p = __expf(p_s[g][jj] - m_new);
        sum += p;
        p_s[g][jj] = p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= alpha_s[g];
      for (int jj = 0; jj < n; ++jj) {
        const float vv = to_f<T>(v_s[jj * D + tid]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += p_s[g][jj] * vv;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows and p_s
  }

  // 3. fold in the new row in float32
  for (int g = warp; g < G; g += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += q_s[g][d] * to_f<T>(new_k[nrow * D + d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) {
      const float s_x = dot * scale;
      const float m_new = fmaxf(m_s[g], s_x);
      const float p_x = __expf(s_x - m_new);
      const float alpha = __expf(m_s[g] - m_new);
      l_s[g] = alpha * l_s[g] + p_x;
      alpha_s[g] = alpha;
      px_s[g] = p_x;
    }
  }
  __syncthreads();
  if (tid < D) {
    const float nv = to_f<T>(new_v[nrow * D + tid]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = acc[g] * alpha_s[g] + px_s[g] * nv;
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];
      out[(static_cast<size_t>(b) * H + kvh * G + g) * D + tid] = from_f<T>(a / l);
    }
  }
}

template <typename T, int D, int G>
cudaError_t launch_append(const void* q, const void* nk, const void* nv, void* kc,
                          void* vc, const int* lens, void* out, int B, int KVH, int M,
                          int layer, float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_append_kernel<T, D, G><<<grid, kAppThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<T*>(kc), static_cast<T*>(vc), lens, static_cast<T*>(out), B, KVH, M,
      layer, scale);
  return cudaGetLastError();
}

#define KARANTA_APPEND_CASE(DD, GG)                                                   \
  if (D == DD && G == GG)                                                              \
    return launch_append<T, DD, GG>(q, nk, nv, kc, vc, lens, out, B, KVH, M, layer, \
                                    scale, st);

// (D, G) pairs: Qwen2.5-VL-7B (28 heads over 4), -3B (16 over 2), the tiny
// test config (4 heads over 2) and the shapes of the JAX package's tests
#define KARANTA_APPEND_PAIRS(X) \
  X(128, 7) X(128, 8) X(128, 4) X(128, 2) X(64, 4) X(64, 2) X(32, 2) X(16, 2)

template <typename T>
cudaError_t dispatch_append(int D, int G, const void* q, const void* nk, const void* nv,
                            void* kc, void* vc, const int* lens, void* out, int B,
                            int KVH, int M, int layer, float scale, cudaStream_t st) {
  KARANTA_APPEND_PAIRS(KARANTA_APPEND_CASE)
  return cudaErrorInvalidValue;
}

#undef KARANTA_APPEND_CASE

}  // namespace karanta

// C interface (loaded with ctypes). The caches are updated in place and hold
// the activations' dtype. Returns the CUDA error code of the launch;
// cudaErrorInvalidValue for a (D, G) pair without an instantiation.
extern "C" int karanta_decode_append(const void* q, const void* new_k, const void* new_v,
                                     void* k_cache, void* v_cache, const int* cache_len,
                                     void* out, int B, int KVH, int G, int M, int D,
                                     int layer, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == karanta::kBFloat16) {
    err = karanta::dispatch_append<__nv_bfloat16>(D, G, q, new_k, new_v, k_cache, v_cache,
                                                  cache_len, out, B, KVH, M, layer, scale,
                                                  st);
  } else if (dtype == karanta::kFloat32) {
    err = karanta::dispatch_append<float>(D, G, q, new_k, new_v, k_cache, v_cache,
                                          cache_len, out, B, KVH, M, layer, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#define KARANTA_APPEND_SUPPORTED(DD, GG) \
  if (D == DD && G == GG) return 1;

// (D, G) pairs with an instantiation, for the wrapper's checks
extern "C" int karanta_decode_append_supported(int D, int G) {
  KARANTA_APPEND_PAIRS(KARANTA_APPEND_SUPPORTED)
  return 0;
}
