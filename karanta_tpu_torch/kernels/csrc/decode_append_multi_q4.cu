// Fused multi-token int4-KV append + verify attention for one layer, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/decode_attention.py:1998
// paged_decode_append_multi_q4 (body _decode_append_multi_q4_kernel :1743).
// For each slot b it merges the T speculative tokens' K/V nibbles into their
// bytes at tokens cache_len[b] + [0, T) of layer `layer` of the nibble-packed
// int4 cache (common.cuh, q4_row) and writes their scales, in place, then
// attends all T queries over the old tokens [0, cache_len[b]) with the
// per-token scales folded into the scores and probabilities, and folds the T
// fresh tokens in last, one at a time, in float32 from their int4 values
// times their scales, with the causal rule that query t_q sees fresh token
// t_k iff t_k <= t_q.
//
// What bounds it on this card: each packed byte is used once per verify pass
// for about 4 * G * T flops (two tokens, G query heads per kv head, T
// tokens), far below the card's ~295 bf16 flops per byte, so the bound is
// the bytes one, B * KVH * (live_packed_rows * D * 2 + live_tokens * 2 * 2)
// per layer at 3.35 TB/s. One read of the cache serves all T queries.
//
// The bf16 instance is verify_tma_kernel (verify_tma.cuh, with kBits =
// 4), the int8 verify kernel's (#4) body with the nibbles unpacked in
// registers in place of its int8 conversion. It replaces the earlier split body
// (verify_split.cuh: a chunk of 16 packed rows landed by cp.async and
// unpacked in shared memory into two 16-key bf16 tiles), which reached 6.1%
// of the bound at B = 4 and 13.1% at B = 8 on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md): a producer warp bulk-copies 64 packed rows (128 tokens)
// a chunk with the low and the high scale plane of K and of V into an
// mbarrier ring; each packed byte's two nibbles become the B operands of
// two 16-key tiles (the low plane, tokens 64w + r, and the high plane, 64w
// + 32 + r), each key masked by its own token index; every resident block
// walks fixed (slot, kv head, run) items. The run length, in tokens, is an
// argument (whole chunks of 128 tokens, so no window is split); the
// wrapper's rule (ops/decode_attention.py multi_q4_run_tokens) takes the
// shortest run from 256 to 2,048 tokens whose runs fit the grid with every
// slot full, else 2,048. The first run's block merges the fresh nibbles
// into their bytes (one thread and one store per byte, the other nibble
// kept) and writes their scales.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (bench/flash_ab.py --kernel
// 7, the earlier body built from its source and timed in turns; PERF.md has
// every shape): B = 4 over 4,096 tokens 0.0193-0.0195 ms against
// 0.0215-0.0216, B = 8 ragged 0.0241-0.0247 against 0.0277, one rank's kv
// heads at tp = 2 / 4 1.11-1.15x; a B = 4 call stays a latency chain (7% of
// its bytes bound).
//
// The float32 instance (decode_append_multi_q4_kernel) stays on the CUDA
// cores (the tensor cores would multiply in TF32): one block per (kv head,
// slot) owns that slab. It merges the T fresh tokens' bytes itself, one
// thread and one store per byte: with T <= 32 no two fresh tokens share a
// byte (tokens of one byte are 32 apart), and each byte's other nibble (an
// older token, or one not yet written) is kept as it was. The NQ = G * T
// query rows (row r = t * G + g) live in shared memory and in registers, 4
// dims each; packed rows stream one 64-token window (32 rows) at a time; D/4
// lanes share a row, unpack one nibble plane after the other and dot it
// against all NQ queries; each nibble is masked by its own token index
// against cache_len. The T rows may cross a 32-row or 64-token window
// boundary; nothing in either instance depends on where they fall.
#include "common.cuh"
#include "verify_tma.cuh"

namespace karanta {

constexpr int kMq4Threads = 128;
constexpr int kMq4Chunk = 32;            // packed rows per chunk: one window
constexpr int kMq4Cols = 2 * kMq4Chunk;  // its tokens: column jj + 32 * nibble

template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kMq4Threads) decode_append_multi_q4_kernel(
    const T* __restrict__ q,                                   // (B, TQ, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, TQ, KVH, D)
    const T* __restrict__ new_ks, const T* __restrict__ new_vs,          // (B, TQ, KVH)
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,  // (L, B, KVH, PM, D)
    T* __restrict__ ks_cache, T* __restrict__ vs_cache,          // (L, B, 2*KVH, PM)
    const int* __restrict__ cache_len,                           // (B,) tokens
    T* __restrict__ out,                                         // (B, TQ, KVH*G, D)
    int B, int TQ, int KVH, int G, int PM, int layer, float scale) {
  constexpr int DL = 4;                    // packed bytes per lane
  constexpr int kLanes = D / DL;           // lanes per packed row
  static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "D/4 must be a power of two up to 32");
  constexpr int kWarps = kMq4Threads / 32;
  constexpr int kRowsPerPass = kWarps * (32 / kLanes);
  constexpr int kVecPerRow = D / 16;       // 16-byte vectors per packed row

  __shared__ float q_s[NQ][D];
  __shared__ float p_s[NQ][kMq4Cols];
  __shared__ float m_s[NQ], l_s[NQ], alpha_s[NQ], px_s[NQ];
  __shared__ __align__(16) int8_t k_s[kMq4Chunk * D];
  __shared__ __align__(16) int8_t v_s[kMq4Chunk * D];
  __shared__ float ksc_s[kMq4Cols], vsc_s[kMq4Cols];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = KVH * G;
  // tokens present before the T new ones; the engine keeps len + T <= M - 1,
  // the clamp only keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), 2 * PM - TQ);

  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * PM;
  int8_t* k_rows = k_cache + slab * D;
  int8_t* v_rows = v_cache + slab * D;
  // scale plane 2 * kvh (low nibbles); plane 2 * kvh + 1 follows PM later
  const size_t planes = ((static_cast<size_t>(layer) * B + b) * 2 * KVH + 2 * kvh) * PM;
  T* k_sc = ks_cache + planes;
  T* v_sc = vs_cache + planes;

  // 1. append: merge the T tokens' nibbles, one thread and one store per byte
  for (int i = tid; i < TQ * D; i += kMq4Threads) {
    const int t = i / D, d = i % D;
    const int tok = len + t;
    const size_t at = static_cast<size_t>(q4_row(tok)) * D + d;
    const size_t src = ((static_cast<size_t>(b) * TQ + t) * KVH + kvh) * D + d;
    k_rows[at] = q4_merge(k_rows[at], new_k[src], q4_nib(tok));
    v_rows[at] = q4_merge(v_rows[at], new_v[src], q4_nib(tok));
  }
  if (tid < TQ) {
    const int tok = len + tid;
    const size_t at = static_cast<size_t>(q4_nib(tok)) * PM + q4_row(tok);
    const size_t src = (static_cast<size_t>(b) * TQ + tid) * KVH + kvh;
    k_sc[at] = new_ks[src];
    v_sc[at] = new_vs[src];
  }

  // query row r = t * G + g is q[b, t, kvh * G + g]
  for (int i = tid; i < NQ * D; i += kMq4Threads) {
    const int r = i / D, d = i % D;
    const int t = r / G, g = r % G;
    q_s[r][d] = to_f<T>(q[((static_cast<size_t>(b) * TQ + t) * H + kvh * G + g) * D + d]);
  }
  if (tid < NQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();  // also orders the merged bytes before the reads below

  const int sub = lane % kLanes;   // which 4-byte slice of the row
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

  // 2. attend all NQ query rows over the old tokens [0, len), one window of
  //    packed rows at a time
  const int live = q4_live_rows(len);
  for (int c0 = 0; c0 < live; c0 += kMq4Chunk) {
    const int n = min(kMq4Chunk, live - c0);
    for (int t = tid; t < n * kVecPerRow; t += kMq4Threads) {
      const size_t off = static_cast<size_t>(c0) * D + static_cast<size_t>(t) * 16;
      reinterpret_cast<uint4*>(k_s)[t] = *reinterpret_cast<const uint4*>(k_rows + off);
      reinterpret_cast<uint4*>(v_s)[t] = *reinterpret_cast<const uint4*>(v_rows + off);
    }
    // scales in token order; a token at or past len (a fresh or dead one)
    // gets 0, so that 0 times a stale scale cannot make a NaN
    for (int i = tid; i < kMq4Cols; i += kMq4Threads) {
      const int jj = i & 31;
      const size_t at = static_cast<size_t>(i >> 5) * PM + c0 + jj;
      const bool ok = jj < n && 2 * c0 + i < len;
      ksc_s[i] = ok ? to_f<T>(k_sc[at]) : 0.f;
      vsc_s[i] = ok ? to_f<T>(v_sc[at]) : 0.f;
    }
    __syncthreads();

    for (int base = 0; base < kMq4Chunk; base += kRowsPerPass) {
      const int jj = base + warp * (32 / kLanes) + rg;
      unsigned int raw = 0u;
      if (jj < n) raw = *reinterpret_cast<const unsigned int*>(k_s + jj * D + sub * DL);
      const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int nib = 0; nib < 2; ++nib) {
        float part[NQ];
#pragma unroll
        for (int r = 0; r < NQ; ++r) part[r] = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const float kv = static_cast<float>(nib ? q4_hi(kb[i]) : q4_lo(kb[i]));
#pragma unroll
          for (int r = 0; r < NQ; ++r) part[r] += qr[r][i] * kv;
        }
#pragma unroll
        for (int r = 0; r < NQ; ++r) {
#pragma unroll
          for (int o = kLanes / 2; o > 0; o >>= 1) {
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
          }
        }
        if (sub == 0 && jj < kMq4Chunk) {  // every column gets a score or the mask
          const int col = jj + 32 * nib;
          const bool ok = jj < n && 2 * c0 + col < len;
#pragma unroll
          for (int r = 0; r < NQ; ++r) p_s[r][col] = ok ? part[r] * ksc_s[col] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < NQ; r += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < kMq4Cols; c += 32) mx = fmaxf(mx, p_s[r][c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kMq4Cols; c += 32) {
        const float p = __expf(p_s[r][c] - m_new);  // 0 for a masked token
        sum += p;
        p_s[r][c] = p * vsc_s[c];  // V scale folds into p
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
        const int byte = v_s[jj * D + tid];
        const float vl = static_cast<float>(q4_lo(byte));
        const float vh = static_cast<float>(q4_hi(byte));
#pragma unroll
        for (int r = 0; r < NQ; ++r) acc[r] += p_s[r][jj] * vl + p_s[r][jj + 32] * vh;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows and p_s
  }

  // 3. fold in the T fresh tokens in order, dequantized in float32, causally
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
    __syncthreads();  // the next fresh token rewrites alpha_s and px_s
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
cudaError_t launch_multi_q4(const void* q, const int8_t* nk, const int8_t* nv,
                            const void* nks, const void* nvs, int8_t* kc, int8_t* vc,
                            void* ksc, void* vsc, const int* lens, void* out, int B,
                            int TQ, int KVH, int G, int PM, int layer, float scale,
                            cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_append_multi_q4_kernel<T, D, NQ><<<grid, kMq4Threads, 0, stream>>>(
      static_cast<const T*>(q), nk, nv, static_cast<const T*>(nks),
      static_cast<const T*>(nvs), kc, vc, static_cast<T*>(ksc), static_cast<T*>(vsc),
      lens, static_cast<T*>(out), B, TQ, KVH, G, PM, layer, scale);
  return cudaGetLastError();
}

// (D, G * T) pairs: Qwen2.5-VL-7B (G = 7) and -3B (G = 8) at T = 2..5, two
// query heads per kv head at T = 5, the tiny test config (D = 16, G = 2) at
// T = 2..6 (the int8 verify kernel's pairs)
#define KARANTA_MQ4_PAIRS(X)                                                     \
  X(128, 14) X(128, 21) X(128, 28) X(128, 16) X(128, 24) X(128, 32) X(128, 10) \
  X(16, 4) X(16, 6) X(16, 8) X(16, 10) X(16, 12)

template <int D, int NQ>
cudaError_t launch_pair_q4(int dtype, const void* q, const int8_t* nk, const int8_t* nv,
                           const void* nks, const void* nvs, int8_t* kc, int8_t* vc,
                           void* ksc, void* vsc, const int* lens, void* out, float* partials,
                           int* counters, int B, int TQ, int KVH, int G, int PM, int layer,
                           int run_tokens, float scale, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_verify_tma<D, NQ, 4>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out,
                                   partials, counters, B, TQ, KVH, G, PM, layer, run_tokens,
                                   scale, st);
  }
  if (dtype == kFloat32) {
    return launch_multi_q4<float, D, NQ>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, B,
                                         TQ, KVH, G, PM, layer, scale, st);
  }
  return cudaErrorInvalidValue;
}

#define KARANTA_MQ4_CASE(DD, NN)                                                             \
  if (D == DD && NQ == NN)                                                                    \
    return static_cast<int>(launch_pair_q4<DD, NN>(dtype, q, nk, nv, nks, nvs, kc, vc, ksc,   \
                                                   vsc, lens, out, partials, counters, B, TQ, \
                                                   KVH, G, PM, layer, run_tokens, scale,      \
                                                   static_cast<cudaStream_t>(stream)));

inline int multi_q4_entry(int D, int NQ, const void* q, const int8_t* nk, const int8_t* nv,
                          const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                          void* vsc, const int* lens, void* out, float* partials,
                          int* counters, int B, int TQ, int KVH, int G, int PM, int layer,
                          int run_tokens, float scale, int dtype, void* stream) {
  KARANTA_MQ4_PAIRS(KARANTA_MQ4_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef KARANTA_MQ4_CASE

}  // namespace karanta

// C interface (loaded with ctypes). Caches are updated in place; PM is the
// packed row count (M / 2 tokens). Returns the CUDA error code of the launch;
// cudaErrorInvalidValue for a (D, G * T) pair without an instantiation. The
// bf16 instance needs `partials`, float32 (B * KVH * ceil(M / run_tokens) *
// (32 D + 64)), and `counters`, int32 (B * KVH), zero before the first call
// (each call leaves them zero; the other split kernels' counters may be the
// same array on one stream), and takes runs of `run_tokens` tokens (a
// multiple of twice info[5], the packed rows a chunk, at most info[4] of
// karanta_decode_append_multi_q4_info runs a slot; the wrapper's rule picks
// it) and T <= 8; the float32 instance ignores the three.
extern "C" int karanta_decode_append_multi_q4(
    const void* q, const int8_t* new_k, const int8_t* new_v, const void* new_ks,
    const void* new_vs, int8_t* k_cache, int8_t* v_cache, void* ks_cache, void* vs_cache,
    const int* cache_len, void* out, float* partials, int* counters, int B, int TQ, int KVH,
    int G, int PM, int D, int layer, int run_tokens, float scale, int dtype, void* stream) {
  return karanta::multi_q4_entry(D, G * TQ, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                                 ks_cache, vs_cache, cache_len, out, partials, counters, B, TQ,
                                 KVH, G, PM, layer, run_tokens, scale, dtype, stream);
}

#define KARANTA_MQ4_SUPPORTED(DD, NN) \
  if (D == DD && NQ == NN) return 1;

// (D, G * T) pairs with an instantiation, for the wrapper's checks
extern "C" int karanta_decode_multi_q4_supported(int D, int NQ) {
  KARANTA_MQ4_PAIRS(KARANTA_MQ4_SUPPORTED)
  return 0;
}

#define KARANTA_MQ4_INFO(DD, NN) \
  if (D == DD && NQ == NN) return static_cast<int>(karanta::verify_tma_info<DD, NN, 4>(info));

// info[8] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block (at B = 0; 12 more a slot), resident blocks per
// SM, the most runs a slot may have (ceil(M / run_tokens)), packed rows a
// chunk, ring stages and consumer warps of the bf16 instance for (D, G *
// T). Returns the CUDA error code.
extern "C" int karanta_decode_append_multi_q4_info(int D, int NQ, int* info) {
  KARANTA_MQ4_PAIRS(KARANTA_MQ4_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
