// Fused int8-KV append + decode attention for one layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/decode_attention.py:887
// paged_decode_append_quant (body _decode_append_quant_kernel :673). For each
// slot b it writes this step's int8 K/V rows and their scales at cache_len[b]
// of layer `layer`, in place in the four cache tensors, then attends over
// rows [0, cache_len[b]) with the per-row scales folded into the scores and
// probabilities, and folds the new row in last, in float32 from its int8
// value times its scale (decode_attention.py:852-873).
//
// What bounds it on this card: every cache byte is used once per step for
// about G * 2 flops (G = query heads per kv head), so the kernel is bound by
// device-memory bytes: B * KVH * live_rows * (D + 2) * 2 per layer at
// 3.35 TB/s.
//
// The bf16 instance is decode_split_kernel (decode_split.cuh, with
// kAppend = true, kBits = 8), the one body it shares with kernels #5, #6,
// #8 and #9: each slot's rows [0, cache_len) split into runs over blocks (the
// run length an argument; the wrapper's rule, quant_run_rows, was measured on
// the card), a cp.async ring of int8 rows and their scales per warp (half
// the bytes of bf16 rows), each landed chunk converted exactly into a bf16
// stage before ldmatrix, Q.K^T and P.V on the tensor cores (mma.sync bf16,
// float32 accumulators) with ksc on the scores and p * vsc rounded to bf16
// before P.V as the TPU kernel rounds it (decode_attention.py:821-846), and
// a last-block merge of the runs' partials in a fixed order. The block of
// run 0 writes the new row and its scales at cache_len (no block reads
// them), and the block that finishes the slot folds the new row in last, in
// float32 from its int8 values times its scales, then normalises.
//
// The float32 instance stays on the CUDA cores (the tensor cores would
// multiply in TF32): one block per (kv head, slot) owns that slab of the
// cache: it writes row cache_len itself and only ever reads rows below it,
// so no block reads a row that is being written and no other block touches
// the slab. Rows stream in chunks of 128, staged in shared memory with
// 16-byte loads; eight lanes share a 128-byte int8 row (16 bytes each), dot
// it against all G query heads held in registers and reduce with three
// shuffles; one warp per head turns the chunk's scores into probabilities
// (online softmax across chunks); then each thread owns one output dim and
// accumulates the chunk's int8 V column for all G heads. Dequantization
// happens in registers; the dequantized cache never exists.
#include "decode_rows.cuh"
#include "decode_split.cuh"

namespace karanta {

constexpr int kDecThreads = 128;
constexpr int kDecChunk = 128;  // cache rows staged per chunk
constexpr int kDecLanesPerRow = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecThreads) decode_append_quant_kernel(
    const T* __restrict__ q,                                   // (B, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, KVH, D)
    const T* __restrict__ new_ks, const T* __restrict__ new_vs,          // (B, KVH)
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,  // (L, B, KVH, M, D)
    T* __restrict__ ks_cache, T* __restrict__ vs_cache,          // (L, B, KVH, M)
    const int* __restrict__ cache_len,                           // (B,)
    T* __restrict__ out,                                         // (B, KVH*G, D)
    int B, int KVH, int M, int layer, float scale) {
  constexpr int DL = D / kDecLanesPerRow;  // int8 dims per lane
  using Vec = typename Bytes<DL>::type;
  constexpr int kWarps = kDecThreads / 32;
  constexpr int kRowsPerPass = kWarps * (32 / kDecLanesPerRow);  // 16

  constexpr int kVecPerRow = D / 16;  // 16-byte vectors per int8 row
  __shared__ float q_s[G][D];
  __shared__ float p_s[G][kDecChunk];
  __shared__ float m_s[G], l_s[G], alpha_s[G], px_s[G];
  __shared__ __align__(16) int8_t k_s[kDecChunk * D];
  __shared__ __align__(16) int8_t v_s[kDecChunk * D];
  __shared__ float ksc_s[kDecChunk], vsc_s[kDecChunk];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = KVH * G;
  // rows already present; the engine keeps it below M, the clamp only
  // keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), M - 1);

  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  int8_t* k_rows = k_cache + slab * D;
  int8_t* v_rows = v_cache + slab * D;
  T* k_sc = ks_cache + slab;
  T* v_sc = vs_cache + slab;
  const size_t nrow = static_cast<size_t>(b) * KVH + kvh;

  // 1. append: row `len` of this slab (read by nobody in this step)
  for (int d = tid; d < D; d += kDecThreads) {
    k_rows[static_cast<size_t>(len) * D + d] = new_k[nrow * D + d];
    v_rows[static_cast<size_t>(len) * D + d] = new_v[nrow * D + d];
  }
  if (tid == 0) {
    k_sc[len] = new_ks[nrow];
    v_sc[len] = new_vs[nrow];
  }

  for (int i = tid; i < G * D; i += kDecThreads) {
    q_s[i / D][i % D] = to_f<T>(q[(static_cast<size_t>(b) * H + kvh * G + i / D) * D + i % D]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int sub = lane % kDecLanesPerRow;   // which DL-wide slice of the row
  const int rg = lane / kDecLanesPerRow;    // row within the warp's pass
  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DL; ++i) qr[g][i] = q_s[g][sub * DL + i];
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  // 2. attend over rows [0, len), one chunk of rows at a time: the block
  //    stages the chunk's int8 K/V rows and scales in shared memory with
  //    16-byte loads (many in flight), then computes from there
  for (int c0 = 0; c0 < len; c0 += kDecChunk) {
    const int n = min(kDecChunk, len - c0);
    for (int t = tid; t < n * kVecPerRow; t += kDecThreads) {
      const size_t off = static_cast<size_t>(c0) * D + static_cast<size_t>(t) * 16;
      reinterpret_cast<uint4*>(k_s)[t] = *reinterpret_cast<const uint4*>(k_rows + off);
      reinterpret_cast<uint4*>(v_s)[t] = *reinterpret_cast<const uint4*>(v_rows + off);
    }
    for (int j = tid; j < n; j += kDecThreads) {
      ksc_s[j] = to_f<T>(k_sc[c0 + j]);
      vsc_s[j] = to_f<T>(v_sc[c0 + j]);
    }
    __syncthreads();

    for (int base = 0; base < n; base += kRowsPerPass) {
      const int jj = base + warp * (32 / kDecLanesPerRow) + rg;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (jj < n) {
        const Vec raw = *reinterpret_cast<const Vec*>(k_s + jj * D + sub * DL);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const float kv = static_cast<float>(kb[i]);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] += qr[g][i] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 1);
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 2);
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 4);
      }
      if (jj < n && sub == 0) {
        const float ksc = ksc_s[jj];
#pragma unroll
        for (int g = 0; g < G; ++g) p_s[g][jj] = part[g] * ksc * scale;
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
        p_s[g][jj] = p * vsc_s[jj];  // V scale folds into p
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
        const float vv = static_cast<float>(v_s[jj * D + tid]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += p_s[g][jj] * vv;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows and p_s
  }

  // 3. fold in the new row, dequantized in float32
  const float nks = to_f<T>(new_ks[nrow]);
  for (int g = warp; g < G; g += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) {
      dot += q_s[g][d] * (static_cast<float>(new_k[nrow * D + d]) * nks);
    }
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
    const float nv = static_cast<float>(new_v[nrow * D + tid]) * to_f<T>(new_vs[nrow]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = acc[g] * alpha_s[g] + px_s[g] * nv;
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];
      out[(static_cast<size_t>(b) * H + kvh * G + g) * D + tid] = from_f<T>(a / l);
    }
  }
}

template <typename T, int D, int G>
cudaError_t launch_decode(const void* q, const int8_t* nk, const int8_t* nv,
                          const void* nks, const void* nvs, int8_t* kc, int8_t* vc,
                          void* ksc, void* vsc, const int* lens, void* out, int B,
                          int KVH, int M, int layer, float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_append_quant_kernel<T, D, G><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), nk, nv, static_cast<const T*>(nks),
      static_cast<const T*>(nvs), kc, vc, static_cast<T*>(ksc), static_cast<T*>(vsc),
      lens, static_cast<T*>(out), B, KVH, M, layer, scale);
  return cudaGetLastError();
}

template <int D, int G>
cudaError_t launch_pair(int dtype, const void* q, const int8_t* nk, const int8_t* nv,
                        const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                        void* vsc, const int* lens, void* out, float* partials, int* counters,
                        int B, int KVH, int M, int layer, int run_rows, float scale,
                        cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_split<D, G, true, 8>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out,
                                          partials, counters, B, KVH, M, layer, run_rows, scale,
                                          st);
  }
  if (dtype == kFloat32) {
    return launch_decode<float, D, G>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, B, KVH,
                                      M, layer, scale, st);
  }
  return cudaErrorInvalidValue;
}

#define KARANTA_DECODE_CASE(DD, GG)                                                          \
  if (D == DD && G == GG)                                                                     \
    return static_cast<int>(launch_pair<DD, GG>(dtype, q, nk, nv, nks, nvs, kc, vc, ksc, vsc, \
                                                lens, out, partials, counters, B, KVH, M,     \
                                                layer, run_rows, scale,                      \
                                                static_cast<cudaStream_t>(stream)));

inline int decode_entry(int D, int G, const void* q, const int8_t* nk, const int8_t* nv,
                        const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                        void* vsc, const int* lens, void* out, float* partials, int* counters,
                        int B, int KVH, int M, int layer, int run_rows, float scale, int dtype,
                        void* stream) {
  KARANTA_ROW_PAIRS(KARANTA_DECODE_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef KARANTA_DECODE_CASE

}  // namespace karanta

// C interface (loaded with ctypes). Caches are updated in place. Returns the
// CUDA error code of the launch; cudaErrorInvalidValue for a (D, G) pair
// without an instantiation. The bf16 instance needs `partials`, float32
// (B * KVH * ceil(M / run_rows) * (8 D + 16)), and `counters`, int32
// (B * KVH), zero before the first call (each call leaves them zero; the
// other split kernels' counters may be the same array on one stream), and
// takes runs of `run_rows` rows (a multiple of 16, at most info[4] of
// karanta_decode_append_quant_info runs a slot; the wrapper's rule picks
// it); the float32 instance ignores the three.
extern "C" int karanta_decode_append_quant(
    const void* q, const int8_t* new_k, const int8_t* new_v, const void* new_ks,
    const void* new_vs, int8_t* k_cache, int8_t* v_cache, void* ks_cache, void* vs_cache,
    const int* cache_len, void* out, float* partials, int* counters, int B, int KVH, int G,
    int M, int D, int layer, int run_rows, float scale, int dtype, void* stream) {
  return karanta::decode_entry(D, G, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                               ks_cache, vs_cache, cache_len, out, partials, counters, B, KVH,
                               M, layer, run_rows, scale, dtype, stream);
}

#define KARANTA_DECODE_SUPPORTED(DD, GG) \
  if (D == DD && G == GG) return 1;

// (D, G) pairs with an instantiation, for the wrapper's checks
extern "C" int karanta_decode_supported(int D, int G) {
  KARANTA_ROW_PAIRS(KARANTA_DECODE_SUPPORTED)
  return 0;
}

#define KARANTA_DECODE_INFO(DD, GG)                                               \
  if (D == DD && G == GG) {                                                        \
    const cudaError_t err = karanta::split_info<DD, GG, true, 8>(info);            \
    info[4] = karanta::SplitTile<DD, 8>::kMaxSplits;                               \
    return static_cast<int>(err);                                                  \
  }

// info[5] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, resident blocks per SM and the most runs a slot
// may have (ceil(M / run_rows)) of the bf16 instance for (D, G). Returns the
// CUDA error code.
extern "C" int karanta_decode_append_quant_info(int D, int G, int* info) {
  KARANTA_ROW_PAIRS(KARANTA_DECODE_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
