// Fused multi-token int8-KV append + verify attention for one layer, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/decode_attention.py:1245
// paged_decode_append_multi_quant (body _decode_append_multi_quant_kernel).
// For each slot b it writes the T speculative int8 K/V rows and their scales
// at cache_len[b] + [0, T) of layer `layer`, in place in the four cache
// tensors, then attends all T queries over the old rows [0, cache_len[b])
// with the per-row scales folded into the scores and probabilities, and
// folds the T fresh rows in last, one at a time, in float32 from their int8
// values times their scales, with the causal rule that query t_q sees fresh
// row t_k iff t_k <= t_q (decode_attention.py:1202-1231).
//
// What bounds it on this card: each cache byte is used once per verify pass
// for about 2 * G * T flops (G query heads per kv head, T tokens), still far
// below the card's ~295 flops per byte, so the kernel is bound by device
// memory: B * KVH * live_rows * (D + 2) * 2 bytes per layer at 3.35 TB/s.
// One read of the cache serves all T queries, which is the point of the
// verify pass.
//
// The bf16 instance is verify_split_kernel (verify_split.cuh, with
// kBits = 8), the one body it shares with the int4 cache's verify kernel
// (#7): flash-decoding on the tensor cores, each slot's rows in runs over
// blocks, int8 rows converted to bf16 in shared memory, two warps per chunk
// with one 16-row query tile each, a last-block merge of the runs'
// partials in a fixed order, then the T fresh rows folded in float32. The
// run length is an argument (a multiple of 64). The wrapper's rule
// (ops/decode_attention.py multi_quant_run_rows, measured on the card): the
// shortest power of two from 256 to 1,024 rows that gives at most one live
// block per two SMs when the slots are half full; 512 at the served int8
// point (B = 4, KVH = 4, M = 4096), 1,024 from B = 8. Shorter runs put more
// SMs to work, but the last block of a slot then merges more partials,
// which costs more than the SMs save.
//
// The float32 instance (decode_append_multi_quant_kernel) stays on the CUDA
// cores (the tensor cores would multiply in TF32): one block per (kv head,
// slot) owns that slab of the cache: it writes rows cache_len ..
// cache_len+T-1 itself and only ever reads rows below cache_len, so nothing
// races. The NQ query rows live in shared memory and in registers, 4 dims
// each; the rows stream in chunks of 64, staged in shared memory with
// 16-byte loads; D/4 lanes share one int8 row, dot it against all NQ queries
// and reduce with shuffles; one warp per query row turns the chunk's scores
// into probabilities (online softmax across chunks); then each thread owns
// one output dim and accumulates the chunk's int8 V column for all NQ rows.
// The TPU-only layout rules of the Pallas kernel (the 64-row slab, M % 128)
// do not carry over: any M works.
#include "common.cuh"
#include "verify_split.cuh"

namespace karanta {

constexpr int kMultiThreads = 128;
constexpr int kMultiChunk = 64;  // cache rows staged per chunk

template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kMultiThreads) decode_append_multi_quant_kernel(
    const T* __restrict__ q,                                   // (B, TQ, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, TQ, KVH, D)
    const T* __restrict__ new_ks, const T* __restrict__ new_vs,          // (B, TQ, KVH)
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,  // (L, B, KVH, M, D)
    T* __restrict__ ks_cache, T* __restrict__ vs_cache,          // (L, B, KVH, M)
    const int* __restrict__ cache_len,                           // (B,)
    T* __restrict__ out,                                         // (B, TQ, KVH*G, D)
    int B, int TQ, int KVH, int G, int M, int layer, float scale) {
  constexpr int DL = 4;                    // int8 dims per lane
  constexpr int kLanes = D / DL;           // lanes per cache row
  static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "D/4 must be a power of two up to 32");
  constexpr int kWarps = kMultiThreads / 32;
  constexpr int kRowsPerPass = kWarps * (32 / kLanes);
  constexpr int kVecPerRow = D / 16;       // 16-byte vectors per int8 row

  __shared__ float q_s[NQ][D];
  __shared__ float p_s[NQ][kMultiChunk];
  __shared__ float m_s[NQ], l_s[NQ], alpha_s[NQ], px_s[NQ];
  __shared__ __align__(16) int8_t k_s[kMultiChunk * D];
  __shared__ __align__(16) int8_t v_s[kMultiChunk * D];
  __shared__ float ksc_s[kMultiChunk], vsc_s[kMultiChunk];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = KVH * G;
  // rows present before the T new ones; the engine keeps len + T <= M - 1,
  // the clamp only keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), M - TQ);

  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  int8_t* k_rows = k_cache + slab * D;
  int8_t* v_rows = v_cache + slab * D;
  T* k_sc = ks_cache + slab;
  T* v_sc = vs_cache + slab;

  // 1. append the T rows at len .. len+T-1 (read by nobody in this pass)
  for (int i = tid; i < TQ * D; i += kMultiThreads) {
    const int t = i / D, d = i % D;
    const size_t src = ((static_cast<size_t>(b) * TQ + t) * KVH + kvh) * D + d;
    k_rows[static_cast<size_t>(len + t) * D + d] = new_k[src];
    v_rows[static_cast<size_t>(len + t) * D + d] = new_v[src];
  }
  if (tid < TQ) {
    const size_t src = (static_cast<size_t>(b) * TQ + tid) * KVH + kvh;
    k_sc[len + tid] = new_ks[src];
    v_sc[len + tid] = new_vs[src];
  }

  // query row r = t * G + g is q[b, t, kvh * G + g]
  for (int i = tid; i < NQ * D; i += kMultiThreads) {
    const int r = i / D, d = i % D;
    const int t = r / G, g = r % G;
    q_s[r][d] = to_f<T>(q[((static_cast<size_t>(b) * TQ + t) * H + kvh * G + g) * D + d]);
  }
  if (tid < NQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int sub = lane % kLanes;   // which 4-dim slice of the row
  const int rg = lane / kLanes;    // row within the warp's pass
  float qr[NQ][DL];
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
#pragma unroll
    for (int i = 0; i < DL; ++i) qr[r][i] = q_s[r][sub * DL + i];
  }
  float acc[NQ];
#pragma unroll
  for (int r = 0; r < NQ; ++r) acc[r] = 0.f;

  // 2. attend all NQ query rows over the old rows [0, len)
  for (int c0 = 0; c0 < len; c0 += kMultiChunk) {
    const int n = min(kMultiChunk, len - c0);
    for (int t = tid; t < n * kVecPerRow; t += kMultiThreads) {
      const size_t off = static_cast<size_t>(c0) * D + static_cast<size_t>(t) * 16;
      reinterpret_cast<uint4*>(k_s)[t] = *reinterpret_cast<const uint4*>(k_rows + off);
      reinterpret_cast<uint4*>(v_s)[t] = *reinterpret_cast<const uint4*>(v_rows + off);
    }
    for (int j = tid; j < n; j += kMultiThreads) {
      ksc_s[j] = to_f<T>(k_sc[c0 + j]);
      vsc_s[j] = to_f<T>(v_sc[c0 + j]);
    }
    __syncthreads();

    for (int base = 0; base < n; base += kRowsPerPass) {
      const int jj = base + warp * (32 / kLanes) + rg;
      float part[NQ];
#pragma unroll
      for (int r = 0; r < NQ; ++r) part[r] = 0.f;
      if (jj < n) {
        const unsigned int raw =
            *reinterpret_cast<const unsigned int*>(k_s + jj * D + sub * DL);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const float kv = static_cast<float>(kb[i]);
#pragma unroll
          for (int r = 0; r < NQ; ++r) part[r] += qr[r][i] * kv;
        }
      }
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) {
          part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
        }
      }
      if (jj < n && sub == 0) {
        const float ksc = ksc_s[jj];
#pragma unroll
        for (int r = 0; r < NQ; ++r) p_s[r][jj] = part[r] * ksc * scale;
      }
    }
    __syncthreads();

    for (int r = warp; r < NQ; r += kWarps) {
      float mx = kNegInf;
      for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, p_s[r][jj]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < n; jj += 32) {
        const float p = __expf(p_s[r][jj] - m_new);
        sum += p;
        p_s[r][jj] = p * vsc_s[jj];  // V scale folds into p
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int r = 0; r < NQ; ++r) acc[r] *= alpha_s[r];
      for (int jj = 0; jj < n; ++jj) {
        const float vv = static_cast<float>(v_s[jj * D + tid]);
#pragma unroll
        for (int r = 0; r < NQ; ++r) acc[r] += p_s[r][jj] * vv;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows and p_s
  }

  // 3. fold in the T fresh rows in order, dequantized in float32, causally
  for (int tk = 0; tk < TQ; ++tk) {
    const size_t nrow = (static_cast<size_t>(b) * TQ + tk) * KVH + kvh;
    const float nks = to_f<T>(new_ks[nrow]);
    for (int r = warp; r < NQ; r += kWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        dot += q_s[r][d] * (static_cast<float>(new_k[nrow * D + d]) * nks);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const float s_x = (r / G >= tk) ? dot * scale : kNegInf;
        const float m_new = fmaxf(m_s[r], s_x);
        const float p_x = __expf(s_x - m_new);
        const float alpha = __expf(m_s[r] - m_new);
        l_s[r] = alpha * l_s[r] + p_x;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
        px_s[r] = p_x;
      }
    }
    __syncthreads();
    if (tid < D) {
      const float nv = static_cast<float>(new_v[nrow * D + tid]) * to_f<T>(new_vs[nrow]);
#pragma unroll
      for (int r = 0; r < NQ; ++r) acc[r] = acc[r] * alpha_s[r] + px_s[r] * nv;
    }
    __syncthreads();  // the next fresh row rewrites alpha_s and px_s
  }

  if (tid < D) {
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      const int t = r / G, g = r % G;
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      out[((static_cast<size_t>(b) * TQ + t) * H + kvh * G + g) * D + tid] =
          from_f<T>(acc[r] / l);
    }
  }
}

template <typename T, int D, int NQ>
cudaError_t launch_multi(const void* q, const int8_t* nk, const int8_t* nv,
                         const void* nks, const void* nvs, int8_t* kc, int8_t* vc,
                         void* ksc, void* vsc, const int* lens, void* out, int B,
                         int TQ, int KVH, int G, int M, int layer, float scale,
                         cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_append_multi_quant_kernel<T, D, NQ><<<grid, kMultiThreads, 0, stream>>>(
      static_cast<const T*>(q), nk, nv, static_cast<const T*>(nks),
      static_cast<const T*>(nvs), kc, vc, static_cast<T*>(ksc), static_cast<T*>(vsc),
      lens, static_cast<T*>(out), B, TQ, KVH, G, M, layer, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// (D, G * T) pairs: Qwen2.5-VL-7B (G = 7) and -3B (G = 8) at T = 2..5, two
// query heads per kv head at T = 5, the tiny test config (D = 16, G = 2) at
// T = 2..6
#define KARANTA_MULTI_PAIRS(X)                                                   \
  X(128, 14) X(128, 21) X(128, 28) X(128, 16) X(128, 24) X(128, 32) X(128, 10) \
  X(16, 4) X(16, 6) X(16, 8) X(16, 10) X(16, 12)

template <int D, int NQ>
cudaError_t launch_pair(int dtype, const void* q, const int8_t* nk, const int8_t* nv,
                        const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                        void* vsc, const int* lens, void* out, float* partials, int* counters,
                        int B, int TQ, int KVH, int G, int M, int layer, int run_rows,
                        float scale, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_verify<D, NQ, 8>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out,
                                   partials, counters, B, TQ, KVH, G, M, layer, run_rows,
                                   scale, st);
  }
  if (dtype == kFloat32) {
    return launch_multi<float, D, NQ>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, B,
                                      TQ, KVH, G, M, layer, scale, st);
  }
  return cudaErrorInvalidValue;
}

#define KARANTA_MULTI_CASE(DD, NN)                                                         \
  if (D == DD && NQ == NN)                                                                  \
    return static_cast<int>(launch_pair<DD, NN>(dtype, q, nk, nv, nks, nvs, kc, vc, ksc, vsc, \
                                                lens, out, partials, counters, B, TQ, KVH, \
                                                G, M, layer, run_rows, scale,              \
                                                static_cast<cudaStream_t>(stream)));

inline int multi_entry(int D, int NQ, const void* q, const int8_t* nk, const int8_t* nv,
                       const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                       void* vsc, const int* lens, void* out, float* partials, int* counters,
                       int B, int TQ, int KVH, int G, int M, int layer, int run_rows,
                       float scale, int dtype, void* stream) {
  KARANTA_MULTI_PAIRS(KARANTA_MULTI_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef KARANTA_MULTI_CASE

}  // namespace karanta

// C interface (loaded with ctypes). Caches are updated in place. Returns the
// CUDA error code of the launch; cudaErrorInvalidValue for a (D, G * T) pair
// without an instantiation. The bf16 instance needs `partials`, float32
// (B * KVH * ceil(M / run_rows) * (32 D + 64)), and `counters`, int32
// (B * KVH), zero before the first call (each call leaves them zero; the
// other split kernels' counters may be the same array on one stream), and
// takes runs of `run_rows` rows (a multiple of 64, at most info[4] of
// karanta_decode_append_multi_quant_info runs a slot; the wrapper's rule
// picks it) and T <= 8; the float32 instance ignores the three.
extern "C" int karanta_decode_append_multi_quant(
    const void* q, const int8_t* new_k, const int8_t* new_v, const void* new_ks,
    const void* new_vs, int8_t* k_cache, int8_t* v_cache, void* ks_cache, void* vs_cache,
    const int* cache_len, void* out, float* partials, int* counters, int B, int TQ, int KVH,
    int G, int M, int D, int layer, int run_rows, float scale, int dtype, void* stream) {
  return karanta::multi_entry(D, G * TQ, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                              ks_cache, vs_cache, cache_len, out, partials, counters, B, TQ,
                              KVH, G, M, layer, run_rows, scale, dtype, stream);
}

#define KARANTA_MULTI_SUPPORTED(DD, NN) \
  if (D == DD && NQ == NN) return 1;

// (D, G * T) pairs with an instantiation, for the wrapper's checks
extern "C" int karanta_decode_multi_supported(int D, int NQ) {
  KARANTA_MULTI_PAIRS(KARANTA_MULTI_SUPPORTED)
  return 0;
}

#define KARANTA_MULTI_INFO(DD, NN) \
  if (D == DD && NQ == NN) return static_cast<int>(karanta::verify_info<DD, NN, 8>(info));

// info[5] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, resident blocks per SM and the most runs a slot
// may have (ceil(M / run_rows)) of the bf16 instance for (D, G * T).
// Returns the CUDA error code.
extern "C" int karanta_decode_append_multi_quant_info(int D, int NQ, int* info) {
  KARANTA_MULTI_PAIRS(KARANTA_MULTI_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
