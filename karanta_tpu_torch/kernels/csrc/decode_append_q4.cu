// Fused int4-KV append + decode attention for one layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/decode_attention.py:1622
// paged_decode_append_q4 (body _decode_append_q4_kernel :1393). The cache is
// the nibble-packed int4 cache (common.cuh, q4_row): each int8 byte of a
// packed row holds two tokens' values. For each slot b the kernel merges this
// step's K/V nibbles into their bytes at token cache_len[b] of layer `layer`
// and writes their scales, in place, then attends over tokens
// [0, cache_len[b]) with the per-token scales folded into the scores and
// probabilities, and folds the new token in last, in float32 from its int4
// value times its scale.
//
// What bounds it on this card: per live token the kernel reads D bytes of
// packed K and V (half the int8 cache's) and two scales, and uses them for
// about 2 * G * D flops, so device-memory bytes bound it:
// B * KVH * (live_packed_rows * D * 2 + live_tokens * 2 * sizeof(T)) per
// layer at 3.35 TB/s.
//
// The bf16 instance is verify_tma_kernel (verify_tma.cuh, kBits = 4) with
// one fresh token (T = 1, NQ = G query rows): the int4 verify kernel's (#7)
// body, whose causal rule at T = 1 is this kernel's function (the one query
// sees the new token). It replaces the earlier split body (#5's, over packed
// rows: a cp.async ring per warp, each landed 16-row chunk unpacked into two
// 16-key bf16 tiles in shared memory and read back with ldmatrix, a block
// for each (slot, kv head, run)), which reached 4.7% of the bound at
// B = 4 and 12.7% at B = 8 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// a producer warp bulk-copies chunks of 64 packed rows (128 tokens) with the
// low and high scale planes of K and of V into an mbarrier ring; one
// consumer warpgroup turns each packed byte's two nibbles into the B
// operands of two 16-key tiles in registers (no bf16 stage), each key masked
// by its own token index; ksc multiplies the scores and p * vsc is rounded
// to bf16 before P.V, as the TPU kernel rounds it (decode_attention.py:1577);
// every resident block walks fixed (slot, kv head, run) items, so a slot's
// bits do not depend on the other slots. The run length, in tokens, is an
// argument (whole chunks of 128 tokens, so no 64-token window is split); the
// wrapper's rule (ops/decode_attention.py q4_run_tokens) takes the shortest
// run in its range whose runs of full slots fit the resident blocks. The
// first run's block merges the new token's nibbles into their bytes (one
// thread and one store per byte, the other nibble kept) and writes its
// scales; the block that finishes the slot folds the new token in last, in
// float32 from its int4 values times its scales (:1590-1606).
//
// The float32 instance (decode_append_q4_kernel) stays on the CUDA cores
// (the tensor cores would multiply in TF32), decode_append_quant.cu's
// float32 design over packed rows. One block per (kv head,
// slot) owns that slab. It merges the new token's byte itself (one thread per
// byte, one store each): the byte's other nibble, token cache_len - 32 or a
// token not yet written, is kept as it was, so a reader sees the older token
// unchanged whichever byte it reads. Packed rows stream in chunks of 64 (two
// 64-token windows), staged in shared memory with 16-byte loads; eight lanes
// share a row, unpack both nibbles and dot them against the G query heads in
// registers; each nibble is masked by its own token index against cache_len
// (a packed row is not live or dead as a whole). One warp per head turns the
// chunk's 128 token scores into probabilities (online softmax across
// chunks), and each thread then owns one output dim. The TPU kernel's ring,
// slots per program and scale slab are TPU tiling and do not carry over.
#include "common.cuh"
#include "verify_tma.cuh"

namespace karanta {

constexpr int kQ4Threads = 128;
constexpr int kQ4Chunk = 64;           // packed rows staged per chunk
constexpr int kQ4Cols = 2 * kQ4Chunk;  // their tokens
constexpr int kQ4LanesPerRow = 8;

// token column (within a chunk) of packed row jj's low nibble; its high
// nibble's column is 32 further
__device__ __forceinline__ int q4_col(int jj) { return ((jj >> 5) << 6) + (jj & 31); }

template <typename T, int D, int G>
__global__ void __launch_bounds__(kQ4Threads) decode_append_q4_kernel(
    const T* __restrict__ q,                                   // (B, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, KVH, D)
    const T* __restrict__ new_ks, const T* __restrict__ new_vs,          // (B, KVH)
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,  // (L, B, KVH, PM, D)
    T* __restrict__ ks_cache, T* __restrict__ vs_cache,          // (L, B, 2*KVH, PM)
    const int* __restrict__ cache_len,                           // (B,) tokens
    T* __restrict__ out,                                         // (B, KVH*G, D)
    int B, int KVH, int PM, int layer, float scale) {
  constexpr int DL = D / kQ4LanesPerRow;  // packed bytes per lane
  using Vec = typename Bytes<DL>::type;
  constexpr int kWarps = kQ4Threads / 32;
  constexpr int kRowsPerPass = kWarps * (32 / kQ4LanesPerRow);  // 16
  constexpr int kVecPerRow = D / 16;  // 16-byte vectors per packed row

  __shared__ float q_s[G][D];
  __shared__ float p_s[G][kQ4Cols];
  __shared__ float m_s[G], l_s[G], alpha_s[G], px_s[G];
  __shared__ __align__(16) int8_t k_s[kQ4Chunk * D];
  __shared__ __align__(16) int8_t v_s[kQ4Chunk * D];
  __shared__ float ksc_s[kQ4Cols], vsc_s[kQ4Cols];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = KVH * G;
  // tokens already present; the engine keeps it below M = 2 * PM, the clamp
  // only keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), 2 * PM - 1);

  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * PM;
  int8_t* k_rows = k_cache + slab * D;
  int8_t* v_rows = v_cache + slab * D;
  // scale plane 2 * kvh (low nibbles); plane 2 * kvh + 1 follows PM later
  const size_t planes = ((static_cast<size_t>(layer) * B + b) * 2 * KVH + 2 * kvh) * PM;
  T* k_sc = ks_cache + planes;
  T* v_sc = vs_cache + planes;
  const size_t nrow = static_cast<size_t>(b) * KVH + kvh;

  // 1. append: merge the new token's nibbles into their bytes, one thread and
  //    one store per byte, and write its scales
  {
    const int r = q4_row(len), nib = q4_nib(len);
    for (int d = tid; d < D; d += kQ4Threads) {
      const size_t at = static_cast<size_t>(r) * D + d;
      k_rows[at] = q4_merge(k_rows[at], new_k[nrow * D + d], nib);
      v_rows[at] = q4_merge(v_rows[at], new_v[nrow * D + d], nib);
    }
    if (tid == 0) {
      k_sc[static_cast<size_t>(nib) * PM + r] = new_ks[nrow];
      v_sc[static_cast<size_t>(nib) * PM + r] = new_vs[nrow];
    }
  }

  for (int i = tid; i < G * D; i += kQ4Threads) {
    q_s[i / D][i % D] = to_f<T>(q[(static_cast<size_t>(b) * H + kvh * G + i / D) * D + i % D]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int sub = lane % kQ4LanesPerRow;   // which DL-wide slice of the row
  const int rg = lane / kQ4LanesPerRow;    // row within the warp's pass
  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DL; ++i) qr[g][i] = q_s[g][sub * DL + i];
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  // 2. attend over tokens [0, len), one chunk of packed rows at a time
  const int live = q4_live_rows(len);
  for (int c0 = 0; c0 < live; c0 += kQ4Chunk) {
    const int n = min(kQ4Chunk, live - c0);
    for (int t = tid; t < n * kVecPerRow; t += kQ4Threads) {
      const size_t off = static_cast<size_t>(c0) * D + static_cast<size_t>(t) * 16;
      reinterpret_cast<uint4*>(k_s)[t] = *reinterpret_cast<const uint4*>(k_rows + off);
      reinterpret_cast<uint4*>(v_s)[t] = *reinterpret_cast<const uint4*>(v_rows + off);
    }
    // scales in token order; a token at or past len gets 0 (its probability
    // is 0, and 0 times a stale scale must not make a NaN)
    for (int i = tid; i < kQ4Cols; i += kQ4Threads) {
      const int jj = ((i >> 6) << 5) + (i & 31);  // packed row of column i
      const size_t at = static_cast<size_t>((i >> 5) & 1) * PM + c0 + jj;
      const bool ok = jj < n && 2 * c0 + i < len;
      ksc_s[i] = ok ? to_f<T>(k_sc[at]) : 0.f;
      vsc_s[i] = ok ? to_f<T>(v_sc[at]) : 0.f;
    }
    __syncthreads();

    for (int base = 0; base < kQ4Chunk; base += kRowsPerPass) {
      const int jj = base + warp * (32 / kQ4LanesPerRow) + rg;
      float lo[G], hi[G];
#pragma unroll
      for (int g = 0; g < G; ++g) lo[g] = hi[g] = 0.f;
      if (jj < n) {
        const Vec raw = *reinterpret_cast<const Vec*>(k_s + jj * D + sub * DL);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const float kl = static_cast<float>(q4_lo(kb[i]));
          const float kh = static_cast<float>(q4_hi(kb[i]));
#pragma unroll
          for (int g = 0; g < G; ++g) {
            lo[g] += qr[g][i] * kl;
            hi[g] += qr[g][i] * kh;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int o = 1; o < kQ4LanesPerRow; o <<= 1) {
          lo[g] += __shfl_xor_sync(0xffffffffu, lo[g], o);
          hi[g] += __shfl_xor_sync(0xffffffffu, hi[g], o);
        }
      }
      if (sub == 0) {  // every column of the chunk gets a score or the mask
        const int col = q4_col(jj);
        const bool ok_lo = jj < n && 2 * c0 + col < len;
        const bool ok_hi = jj < n && 2 * c0 + col + 32 < len;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          p_s[g][col] = ok_lo ? lo[g] * ksc_s[col] * scale : kNegInf;
          p_s[g][col + 32] = ok_hi ? hi[g] * ksc_s[col + 32] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < kQ4Cols; c += 32) mx = fmaxf(mx, p_s[g][c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kQ4Cols; c += 32) {
        const float p = __expf(p_s[g][c] - m_new);  // 0 for a masked token
        sum += p;
        p_s[g][c] = p * vsc_s[c];  // V scale folds into p
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
        const int byte = v_s[jj * D + tid];
        const float vl = static_cast<float>(q4_lo(byte));
        const float vh = static_cast<float>(q4_hi(byte));
        const int col = q4_col(jj);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += p_s[g][col] * vl + p_s[g][col + 32] * vh;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows and p_s
  }

  // 3. fold in the new token, dequantized in float32
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
cudaError_t launch_q4(const void* q, const int8_t* nk, const int8_t* nv, const void* nks,
                      const void* nvs, int8_t* kc, int8_t* vc, void* ksc, void* vsc,
                      const int* lens, void* out, int B, int KVH, int PM, int layer,
                      float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_append_q4_kernel<T, D, G><<<grid, kQ4Threads, 0, stream>>>(
      static_cast<const T*>(q), nk, nv, static_cast<const T*>(nks),
      static_cast<const T*>(nvs), kc, vc, static_cast<T*>(ksc), static_cast<T*>(vsc),
      lens, static_cast<T*>(out), B, KVH, PM, layer, scale);
  return cudaGetLastError();
}

// (D, G) pairs: Qwen2.5-VL-7B (28 heads over 4), -3B (16 over 2), the tiny
// test config (4 heads over 2) and the shapes of the JAX package's tests
#define KARANTA_Q4_PAIRS(X) \
  X(128, 7) X(128, 8) X(128, 4) X(128, 2) X(64, 4) X(64, 2) X(32, 2) X(16, 2)

template <int D, int G>
cudaError_t launch_pair_q4(int dtype, const void* q, const int8_t* nk, const int8_t* nv,
                           const void* nks, const void* nvs, int8_t* kc, int8_t* vc,
                           void* ksc, void* vsc, const int* lens, void* out, float* partials,
                           int* counters, int B, int KVH, int PM, int layer, int run_tokens,
                           float scale, cudaStream_t st) {
  if (dtype == kBFloat16) {
    // one fresh token: NQ = G query rows, the new token visible to all
    return launch_verify_tma<D, G, 4>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out,
                                      partials, counters, B, 1, KVH, G, PM, layer, run_tokens,
                                      scale, st);
  }
  if (dtype == kFloat32) {
    return launch_q4<float, D, G>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, B, KVH, PM,
                                  layer, scale, st);
  }
  return cudaErrorInvalidValue;
}

#define KARANTA_Q4_CASE(DD, GG)                                                            \
  if (D == DD && G == GG)                                                                   \
    return static_cast<int>(launch_pair_q4<DD, GG>(dtype, q, nk, nv, nks, nvs, kc, vc, ksc, \
                                                   vsc, lens, out, partials, counters, B,    \
                                                   KVH, PM, layer, run_tokens, scale,        \
                                                   static_cast<cudaStream_t>(stream)));

inline int q4_entry(int D, int G, const void* q, const int8_t* nk, const int8_t* nv,
                    const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                    void* vsc, const int* lens, void* out, float* partials, int* counters, int B,
                    int KVH, int PM, int layer, int run_tokens, float scale, int dtype,
                    void* stream) {
  KARANTA_Q4_PAIRS(KARANTA_Q4_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef KARANTA_Q4_CASE

}  // namespace karanta

// C interface (loaded with ctypes). Caches are updated in place; PM is the
// packed row count (M / 2 tokens). Returns the CUDA error code of the launch;
// cudaErrorInvalidValue for a (D, G) pair without an instantiation. The bf16
// instance needs `partials`, float32 (B * KVH * ceil(M / run_tokens) *
// (32 D + 64)), and `counters`, int32 (B * KVH), zero before the first call
// (each call leaves them zero; the other split kernels' counters may be the
// same array on one stream), and takes runs of `run_tokens` tokens (a
// multiple of twice info[5], the packed rows a chunk, at most info[4] of
// karanta_decode_append_q4_info runs a slot; the wrapper's rule picks it);
// the float32 instance ignores the three.
extern "C" int karanta_decode_append_q4(
    const void* q, const int8_t* new_k, const int8_t* new_v, const void* new_ks,
    const void* new_vs, int8_t* k_cache, int8_t* v_cache, void* ks_cache, void* vs_cache,
    const int* cache_len, void* out, float* partials, int* counters, int B, int KVH, int G,
    int PM, int D, int layer, int run_tokens, float scale, int dtype, void* stream) {
  return karanta::q4_entry(D, G, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, ks_cache,
                           vs_cache, cache_len, out, partials, counters, B, KVH, PM, layer,
                           run_tokens, scale, dtype, stream);
}

#define KARANTA_Q4_SUPPORTED(DD, GG) \
  if (D == DD && G == GG) return 1;

// (D, G) pairs with an instantiation, for the wrapper's checks
extern "C" int karanta_decode_q4_supported(int D, int G) {
  KARANTA_Q4_PAIRS(KARANTA_Q4_SUPPORTED)
  return 0;
}

#define KARANTA_Q4_INFO(DD, GG) \
  if (D == DD && G == GG) return static_cast<int>(karanta::verify_tma_info<DD, GG, 4>(info));

// info[8] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block (at B = 0; 12 more a slot), resident blocks per
// SM, the most runs a slot may have (ceil(M / run_tokens)), packed rows a
// chunk, ring stages and consumer warps of the bf16 instance for (D, G).
// Returns the CUDA error code.
extern "C" int karanta_decode_append_q4_info(int D, int G, int* info) {
  KARANTA_Q4_PAIRS(KARANTA_Q4_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
