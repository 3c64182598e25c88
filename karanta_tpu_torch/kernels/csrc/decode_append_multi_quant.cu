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
// The bf16 instance (verify_split_kernel) is flash-decoding on the tensor
// cores:
//
// - Runs over blocks. The old rows of one (slot, kv head) are split into runs
//   of run_rows rows, one block of 8 warps each. The wrapper cannot read
//   cache_len without a host sync, so the grid is (ceil(M / run_rows), KVH,
//   B) and a block whose run starts at or past its slot's cache_len exits at
//   once; run 0 always runs: it writes the T new int8 rows and their scales
//   at cache_len + [0, T), and it is the only block of a slot with
//   cache_len = 0. No block reads a row at or past cache_len, so the write
//   cannot race.
// - The run length is an argument (a multiple of 64). The wrapper's rule
//   (ops/decode_attention.py multi_quant_run_rows, measured on the card): the
//   shortest power of two from 256 to 1,024 rows that gives at most one live
//   block per two SMs when the slots are half full; 512 at the served int8
//   point (B = 4, KVH = 4, M = 4096), 1,024 from B = 8. Shorter runs put more
//   SMs to work, but the last block of a slot then merges more partials,
//   which costs more than the SMs save.
// - Tensor cores. The NQ = G * T query rows (row r = t * G + g) are the rows
//   of the A operand, NT = ceil(NQ / 16) tiles of 16 rows (2 at the 7B
//   point's 28 rows). Q.K^T and P.V are mma.sync.m16n8k16 in bf16 with
//   float32 accumulators; K through ldmatrix is the B operand of Q.K^T and V
//   through ldmatrix.trans that of P.V, the read-only kernels' mapping.
// - Chunk streams. The NT warps of a stream share its 16-row chunks (every
//   kStreams-th chunk of the run): each takes one A tile, so a warp holds one
//   tile's O (64 floats a thread at D = 128) and nothing spills; both tiles'
//   O in one warp took 255 registers and spilled. The chunk's int8 K and V
//   rows come through the stream's cp.async ring (kVerifyStages = 3 chunks),
//   each warp copying and converting its half; named barriers (bar.sync
//   1 + stream, 64 threads) order the ring and the stage between the two.
//   The chunk's bf16 K and V scales are plain loads issued with its rows and
//   stored beside them one iteration later (any M, no alignment needed).
// - int8 to bf16. A landed chunk is converted into the stream's bf16 stage
//   (int8 values in [-127, 127] are exact in bf16: the byte becomes the low
//   mantissa bits of 2^23 + 128 + b, one float subtraction, one packed
//   conversion), so ldmatrix applies unchanged. The conversion is one
//   function (stage_int8_rows): the int4 cache's kernel can put a nibble
//   unpack in its place in front of the same loop. Converting straight into
//   B fragments would save the stage's shared-memory round trip but needs V
//   transposed across lanes; the stage was kept as the simpler design.
// - Rounding where the TPU kernel rounds (decode_attention.py:1164-1196):
//   scores are s * ksc[key], then * scale (in the log2 domain); l sums the
//   unrounded p; p * vsc[key] is rounded to bf16 before P.V.
// - Merge, then the fresh rows. The block merges its streams in a fixed
//   order. A slot with more than one run stores a float32 (O, m, l) partial
//   sized for 32 query rows; the last block of the (slot, kv head), found
//   through a counter that it resets to 0, merges the runs in split order
//   (all of a run's float4 loads in flight at once), so two calls give the
//   same bits. Only then does the finishing block fold in the T fresh rows
//   (copied to shared memory by every block at its start), in float32 from
//   their int8 values times their scales, in order t_k = 0..T-1, causally
//   (query t_q sees t_k <= t_q), as :1202-1231 do. The running max starts
//   at the finite kNegInf, so a slot without old rows (m = -1e30, l = 0)
//   meets the first fresh row without a -inf - -inf: the old rows' weight is
//   exp2(-1e30 - s) = 0.
//
// Measured on the card (PERF.md, NVIDIA H100 80GB HBM3, 700 W): 0.024 ms of
// device time at B = 4, T = 4, M = 4096 (1.21 ms before this design); with
// one block of 4 warps (both tiles in each warp) a block's stages were
// latency-bound, and 8 warps were faster at every batch size tried.
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
#include "mma.cuh"

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
// bf16: tensor cores, rows split over blocks
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kVerifyWarps = 8;
constexpr int kVerifyThreads = 32 * kVerifyWarps;
constexpr int kVerifyStages = 3;   // chunks in flight per stream
constexpr int kVerifyMaxRows = 32;   // query rows of a partial record
constexpr int kVerifyMaxT = 8;       // fresh rows a call can fold in
static_assert(kVerifyStages >= 2, "the ring needs two stages");

template <int D, int NQ>
struct VerifyTile {
  static_assert(NQ <= kVerifyMaxRows, "at most 32 query rows: two 16-row tiles");
  static constexpr int NT = (NQ + 15) / 16;  // 16-row A tiles = warps of a stream
  static constexpr int kStreams = kVerifyWarps / NT;  // chunk streams of a block
  static constexpr int kRowsA = 16 * NT;
  static constexpr int kPitch = D + 8;  // bf16 rows of Q and of the stage (elements)
  // one ring stage: int8 K rows [16][D], int8 V rows [16][D], then the 16 K
  // and 16 V scales (bf16)
  static constexpr int kRingStage = 2 * 16 * D + 64;
  static constexpr int kStageBytes = 2 * 16 * kPitch * 2;  // bf16 K, V of one chunk
  static constexpr int kStreamBytes = kVerifyStages * kRingStage + kStageBytes;
  static constexpr int kRingBytes = kStreams * kStreamBytes;
  static constexpr int kQBytes = kRowsA * kPitch * 2;
  static constexpr int kFreshBytes = 2 * kVerifyMaxT * D;  // the fresh int8 K, V rows
  // one (slot, kv head, run) partial: O [32][D], m [32], l [32], float32
  static constexpr int kPartial = kVerifyMaxRows * D + 2 * kVerifyMaxRows;
  // After the row loop the rings hold the merge. First the per-row state: m
  // and l, the fresh rows' scales, scores and fold factors, their
  // dequantized V rows, each row's output offset. Then each stream's O
  // (pitch D + 8, so the fragment stores meet no bank conflict), m, l and
  // factors; stream 0's O becomes the merged O, and the last block of a slot
  // puts every run's m and l behind it.
  static constexpr int kOPitch = D + 8;
  static constexpr int kSmallFloats =
      3 * kRowsA + 2 * kVerifyMaxT + 3 * kRowsA * kVerifyMaxT + kVerifyMaxT * D;
  static constexpr int kMergeFloats = kStreams * kRowsA * (kOPitch + 3);
  static constexpr int kWorkBytes = (kSmallFloats + kMergeFloats) * 4 > kRingBytes
                                        ? (kSmallFloats + kMergeFloats) * 4
                                        : kRingBytes;
  static constexpr size_t kSmem = kQBytes + kWorkBytes + kFreshBytes;
  // runs whose m and l the last block can hold at once
  static constexpr int kMaxSplits =
      (kWorkBytes / 4 - kSmallFloats - kRowsA * kOPitch) / (2 * kRowsA);
  static_assert(kSmallFloats + kRowsA * kOPitch + kVerifyMaxT * D <= kWorkBytes / 4,
                "the dequantized fresh K rows do not fit");
  static_assert(kRingStage % 16 == 0 && kStageBytes % 16 == 0 && kQBytes % 16 == 0 &&
                    kStreamBytes % 16 == 0 && kWorkBytes % 16 == 0 && kSmallFloats % 4 == 0,
                "shared regions must stay 16-byte aligned");
};

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

// Rows [r_lo, r_lo + kRows) of one landed chunk (int8 K rows 0..15, then V
// rows 16..31, pitch D) into the stream's bf16 stage (the same rows, pitch
// P). The int4 cache's verify kernel would put its nibble unpack here, in
// front of the same loop.
template <int D, int P, int kRows>
__device__ __forceinline__ void stage_int8_rows(const int8_t* __restrict__ src,
                                                __nv_bfloat16* __restrict__ dst, int r_lo,
                                                int lane) {
  constexpr int kV = D / 8;  // 8-byte vectors per row
#pragma unroll
  for (int c = lane; c < kRows * kV; c += 32) {
    const int r = r_lo + c / kV, col = (c % kV) * 8;
    *reinterpret_cast<uint4*>(dst + r * P + col) =
        int8x8_to_bf16(*reinterpret_cast<const uint2*>(src + r * D + col));
  }
}

// the NT warps of one chunk stream meet here (named barrier 1 + stream)
template <int NT>
__device__ __forceinline__ void stream_sync(int stream) {
  if constexpr (NT == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + stream), "n"(32 * NT) : "memory");
  }
}

template <int D, int NQ>
__global__ void __launch_bounds__(kVerifyThreads) verify_split_kernel(
    const __nv_bfloat16* __restrict__ q,                                 // (B, TQ, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, TQ, KVH, D)
    const __nv_bfloat16* __restrict__ new_ks,                            // (B, TQ, KVH)
    const __nv_bfloat16* __restrict__ new_vs,
    int8_t* k_cache, int8_t* v_cache,                // (L, B, KVH, M, D), rows appended
    __nv_bfloat16* ks_cache, __nv_bfloat16* vs_cache,  // (L, B, KVH, M)
    const int* __restrict__ cache_len,               // (B,)
    __nv_bfloat16* __restrict__ out,                 // (B, TQ, KVH*G, D)
    float* __restrict__ partials,                    // (B*KVH, gridDim.x, kPartial)
    int* __restrict__ counters,                      // (B*KVH,), 0 between calls
    int B, int TQ, int KVH, int G, int M, int layer, int run_rows, float scale_log2) {
  using Tile = VerifyTile<D, NQ>;
  constexpr int NT = Tile::NT, kRowsA = Tile::kRowsA, P = Tile::kPitch, kKT = D / 16;
  constexpr int kS = kVerifyStages, kSt = Tile::kStreams, kOP = Tile::kOPitch;
  constexpr int kMT = kVerifyMaxT, kV16 = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRowsA][P]
  unsigned char* work = smem_raw + Tile::kQBytes;  // streams' rings, then the merge
  int8_t* fresh = reinterpret_cast<int8_t*>(work + Tile::kWorkBytes);  // [K, V][kMT][D]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warp = stream * NT + tile: the NT warps of a stream share its chunks,
  // each takes 16 query rows (one A tile) and 32 / NT of the chunk's 32
  // K and V rows for the copy and the conversion
  const int stream = warp / NT, tile = warp % NT;
  const int H = KVH * G;
  // rows present before the T new ones; the engine keeps len + T <= M - 1,
  // the clamp only keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), M - TQ);
  const int r0 = split * run_rows;
  if (split > 0 && r0 >= len) return;  // past this slot's old rows
  const int r_end = min(r0 + run_rows, len);
  const int n_splits = max((len + run_rows - 1) / run_rows, 1);
  const int bh = b * KVH + kvh;
  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  int8_t* k_rows = k_cache + slab * D;
  int8_t* v_rows = v_cache + slab * D;
  __nv_bfloat16* k_sc = ks_cache + slab;
  __nv_bfloat16* v_sc = vs_cache + slab;

  // 1. every block copies the T fresh rows and loads their scales now, for
  // whichever block finishes the slot; run 0 appends them to the cache
  // after its row loop (section 3)
  for (int c = tid; c < 2 * TQ * kV16; c += kVerifyThreads) {
    const bool is_v = c >= TQ * kV16;
    const int cc = is_v ? c - TQ * kV16 : c;
    const int tk = cc / kV16, col = (cc % kV16) * 16;
    cp_async16(fresh + (is_v * kMT + tk) * D + col,
               (is_v ? new_v : new_k) + ((static_cast<size_t>(b) * TQ + tk) * KVH + kvh) * D +
                   col,
               16);
  }
  float fresh_scale = 0.f;  // thread tk < T: K scale of fresh row tk; T + tk: its V scale
  if (tid < 2 * TQ) {
    const int tk = tid < TQ ? tid : tid - TQ;
    fresh_scale = __bfloat162float(
        (tid < TQ ? new_ks : new_vs)[(static_cast<size_t>(b) * TQ + tk) * KVH + kvh]);
  }

  // 2. the run's old rows: this stream's chunks start at w0 + 16 kSt i
  constexpr int kStride = 16 * kSt;
  const int w0 = r0 + 16 * stream;
  const int n_mine = w0 < r_end ? (r_end - w0 + kStride - 1) / kStride : 0;
  unsigned char* my_ring = work + stream * Tile::kStreamBytes;  // [stages][kRingStage]
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(my_ring + kS * Tile::kRingStage);
  constexpr int kMyRows = 32 / NT;                 // of the chunk's 32 K and V rows
  constexpr int kMyVecs = kMyRows * kV16;          // 16-byte vectors of them
  const int row_lo = tile * kMyRows;
  auto load_rows = [&](int i) {
    const int c0 = w0 + kStride * i;
    int8_t* st = reinterpret_cast<int8_t*>(my_ring + (i % kS) * Tile::kRingStage);
#pragma unroll
    for (int c = lane; c < kMyVecs; c += 32) {
      const int rr = row_lo + c / kV16, col = (c % kV16) * 16;  // rr: K 0..15, V 16..31
      const int r = rr & 15;
      const bool ok = c0 + r < r_end;  // rows past the run are zeros
      const size_t off = static_cast<size_t>(ok ? c0 + r : c0) * D + col;
      cp_async16(st + rr * D + col, (rr < 16 ? k_rows : v_rows) + off, ok ? 16 : 0);
    }
  };
  // lane l < 32 / NT carries scale row_lo + l of the chunk (K scales 0..15,
  // V scales 16..31): loaded one iteration ahead, stored beside the rows
  const int sc_idx = row_lo + lane;
  auto load_scale = [&](int i) {
    const int r = w0 + kStride * i + (sc_idx & 15);
    return lane < kMyRows && r < r_end ? (sc_idx < 16 ? k_sc : v_sc)[r]
                                       : __float2bfloat16_rn(0.f);
  };
  auto store_scale = [&](int i, __nv_bfloat16 v) {
    if (lane < kMyRows) {
      reinterpret_cast<__nv_bfloat16*>(my_ring + (i % kS) * Tile::kRingStage + 32 * D)[sc_idx] =
          v;
    }
  };
  // the NQ query rows (row r = t * G + g is q[b, t, kvh * G + g]) as the A
  // tiles' rows, zero rows below them; this group also holds the fresh rows
  for (int c = tid; c < kRowsA * (D / 8); c += kVerifyThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int rq = r < NQ ? r : 0;
    cp_async16(q_s + r * P + col,
               q + ((static_cast<size_t>(b) * TQ + rq / G) * H + kvh * G + rq % G) * D + col,
               r < NQ ? 16 : 0);
  }
  cp_async_commit();
  __nv_bfloat16 sc_first[kS - 1];
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_mine) load_rows(st);
    cp_async_commit();
    sc_first[st] = st < n_mine ? load_scale(st) : __float2bfloat16_rn(0.f);
  }
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_mine) store_scale(st, sc_first[st]);
  }
  cp_async_wait<kS - 1>();  // Q and the fresh rows (the ring's groups may fly)
  __syncthreads();

  // lane offsets as in flash_attention.cu: K as B of Q.K^T, V as B of P.V
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * P + (lane >> 4) * 8;
  const __nv_bfloat16* q_tile = q_s + (tile * 16 + (lane & 15)) * P + (lane >> 4) * 8;
  const __nv_bfloat16* v_st = stage + 16 * P;
  // this warp's tile: fragment rows g (h = 0) and g + 8 (h = 1)
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // a chunk's scales are loaded when its rows are requested and stored one
  // iteration later (their ring stage is free by then), so no load latency
  // stalls the loop
  __nv_bfloat16 sc_pending = __float2bfloat16_rn(0.f);
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kS - 2>();
    // chunk i landed for every lane of the stream; chunk i - 1's ring stage
    // and the bf16 stage are no longer read
    stream_sync<NT>(stream);
    if (i >= 1 && i + kS - 2 < n_mine) store_scale(i + kS - 2, sc_pending);
    const bool more = i + kS - 1 < n_mine;
    if (more) load_rows(i + kS - 1);
    cp_async_commit();
    if (more) sc_pending = load_scale(i + kS - 1);
    const unsigned char* st = my_ring + (i % kS) * Tile::kRingStage;
    stage_int8_rows<D, P, kMyRows>(reinterpret_cast<const int8_t*>(st), stage, row_lo, lane);
    stream_sync<NT>(stream);  // the stage holds the whole chunk

    // the scales of this lane's keys c0 + 8j + 2t + e
    const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(st + 32 * D);
    float ksc[2][2], vsc[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 kf =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + 8 * j + 2 * t));
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sc + 16 + 8 * j + 2 * t));
      ksc[j][0] = kf.x;
      ksc[j][1] = kf.y;
      vsc[j][0] = vf.x;
      vsc[j][1] = vf.y;
    }
    const int c0 = w0 + kStride * i;

    // S = Q K^T over the chunk's 16 rows for this warp's 16 query rows
    // (two accumulation chains, even and odd kk, for the tensor cores'
    // latency)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      uint32_t bb[4], qa[4];
      ldmatrix_x4(bb, stage + k_lane + kk * 16);
      ldmatrix_x4(qa, q_tile + kk * 16);
      float(&acc2)[2][4] = kk % 2 ? s2 : s;
      mma_bf16_16816(acc2[0], qa, bb[0], bb[1]);
      mma_bf16_16816(acc2[1], qa, bb[2], bb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
    }
    // online softmax per fragment row: scores s * ksc, then * scale (log2
    // domain); l sums the unrounded p; P is p * vsc rounded to bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live = c0 + 8 * j + 2 * t + e < r_end;
          float& x = s[j][2 * h + e];
          x = live ? (x * ksc[j][e]) * scale_log2 : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = fast_exp2(m[h] - mx);
      m[h] = mx;
      float sum = l[h] * alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * h + e];
          const float p = fast_exp2(x - mx);
          sum += p;
          x = p * vsc[j][e];
        }
      }
      l[h] = sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    // O += P V
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, v_st + v_lane + np * 16);
      mma_bf16_16816(o[2 * np], pa, bb[0], bb[1]);
      mma_bf16_16816(o[2 * np + 1], pa, bb[2], bb[3]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // 3. merge the streams in shared memory (the rings are free), stream
  // order fixed
  __syncthreads();
  float* row_m = reinterpret_cast<float*>(work);  // [kRowsA]
  float* row_l = row_m + kRowsA;
  float* fsc = row_l + kRowsA;          // [2 kMT]: fresh K scales, then V scales
  float* s_new = fsc + 2 * kMT;         // [kRowsA][kMT]
  float* fold_a = s_new + kRowsA * kMT;
  float* fold_p = fold_a + kRowsA * kMT;
  float* nv_s = fold_p + kRowsA * kMT;  // [kMT][D]
  int* out_row = reinterpret_cast<int*>(nv_s + kMT * D);  // [kRowsA]
  float* red_o = row_m + Tile::kSmallFloats;    // [streams][kRowsA][kOP]
  float* red_m = red_o + kSt * kRowsA * kOP;    // [streams][kRowsA]
  float* red_l = red_m + kSt * kRowsA;
  float* fac = red_l + kSt * kRowsA;
  float* acc_s = red_o;                         // [kRowsA][kOP]: stream 0's O, merged
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = stream * kRowsA + tile * 16 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(red_o + row * kOP + 8 * n + 2 * t) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
    if (t == 0) {
      red_m[row] = m[h];
      red_l[row] = l[h];
    }
  }
  if (tid < 2 * TQ) fsc[tid] = fresh_scale;
  __syncthreads();
  if (split == 0) {
    // the T rows and scales at len .. len+T-1 (read by no block of this call)
    for (int c = tid; c < 2 * TQ * kV16; c += kVerifyThreads) {
      const bool is_v = c >= TQ * kV16;
      const int cc = is_v ? c - TQ * kV16 : c;
      const int tk = cc / kV16, col = (cc % kV16) * 16;
      *reinterpret_cast<uint4*>((is_v ? v_rows : k_rows) + static_cast<size_t>(len + tk) * D +
                                col) =
          *reinterpret_cast<const uint4*>(fresh + (is_v * kMT + tk) * D + col);
    }
    if (tid < 2 * TQ) {
      const int tk = tid < TQ ? tid : tid - TQ;
      (tid < TQ ? k_sc : v_sc)[len + tk] = __float2bfloat16_rn(fsc[tid]);  // exact: bf16 values
    }
  }
  if (tid < NQ) {
    float mx = red_m[tid];
    for (int w = 1; w < kSt; ++w) mx = fmaxf(mx, red_m[w * kRowsA + tid]);
    float sum = 0.f;
    for (int w = 0; w < kSt; ++w) {
      const float f = fast_exp2(red_m[w * kRowsA + tid] - mx);  // a stream without rows: 0
      fac[w * kRowsA + tid] = f;
      sum += red_l[w * kRowsA + tid] * f;
    }
    row_m[tid] = mx;
    row_l[tid] = sum;
  }
  __syncthreads();
  // each element in place: stream 0's slot of red_o becomes the merged O
  for (int e = tid; e < NQ * D; e += kVerifyThreads) {
    const int r = e / D, d = e % D;
    float a = 0.f;
    for (int w = 0; w < kSt; ++w) a += red_o[(w * kRowsA + r) * kOP + d] * fac[w * kRowsA + r];
    acc_s[r * kOP + d] = a;
  }
  if (n_splits > 1) {
    const float* parts = partials + static_cast<size_t>(bh) * gridDim.x * Tile::kPartial;
    float* part = partials + (static_cast<size_t>(bh) * gridDim.x + split) * Tile::kPartial;
    __syncthreads();
    for (int e4 = tid; e4 < NQ * D / 4; e4 += kVerifyThreads) {
      reinterpret_cast<float4*>(part)[e4] =
          *reinterpret_cast<const float4*>(acc_s + (4 * e4 / D) * kOP + 4 * e4 % D);
    }
    if (tid < NQ) {
      part[kVerifyMaxRows * D + tid] = row_m[tid];
      part[kVerifyMaxRows * D + kVerifyMaxRows + tid] = row_l[tid];
    }

    // the last block of this (slot, kv head) merges the runs' partials
    __shared__ int is_last;
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(counters + bh, 1) == n_splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // every run's m and l at once, then each run's weight exp2(m_run - m)
    // per row, in split order
    float* pm = acc_s + kRowsA * kOP;  // [n_splits][kRowsA]
    float* pl = pm + n_splits * kRowsA;
    for (int c = tid; c < n_splits * NQ; c += kVerifyThreads) {
      const int sp = c / NQ, r = c % NQ;
      const float* ps = parts + sp * Tile::kPartial + kVerifyMaxRows * D;
      pm[sp * kRowsA + r] = __ldcg(ps + r);
      pl[sp * kRowsA + r] = __ldcg(ps + kVerifyMaxRows + r);
    }
    __syncthreads();
    if (tid < NQ) {
      float mx = kNegInf;
      for (int sp = 0; sp < n_splits; ++sp) mx = fmaxf(mx, pm[sp * kRowsA + tid]);
      float sum = 0.f;
      for (int sp = 0; sp < n_splits; ++sp) {
        const float f = fast_exp2(pm[sp * kRowsA + tid] - mx);
        pm[sp * kRowsA + tid] = f;
        sum += pl[sp * kRowsA + tid] * f;
      }
      row_m[tid] = mx;
      row_l[tid] = sum;
    }
    __syncthreads();
    // this thread's float4s e4 = tid + kVerifyThreads k (elements 4 e4 ..
    // 4 e4 + 3 of one row), summed in registers; a run's loads are all
    // issued before its products
    constexpr int kQuads = NQ * D / 4;
    constexpr int kPer = (kQuads + kVerifyThreads - 1) / kVerifyThreads;
    float4 acc[kPer], part_v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_splits; ++sp) {
      const float4* ps = reinterpret_cast<const float4*>(parts + sp * Tile::kPartial);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e4 = tid + kVerifyThreads * k;
        part_v[k] = e4 < kQuads ? __ldcg(ps + e4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e4 = tid + kVerifyThreads * k;
        if (e4 < kQuads) {
          const float w = pm[sp * kRowsA + 4 * e4 / D];
          acc[k].x += part_v[k].x * w;
          acc[k].y += part_v[k].y * w;
          acc[k].z += part_v[k].z * w;
          acc[k].w += part_v[k].w * w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e4 = tid + kVerifyThreads * k;
      if (e4 < kQuads) {
        *reinterpret_cast<float4*>(acc_s + (4 * e4 / D) * kOP + 4 * e4 % D) = acc[k];
      }
    }
  }

  // 4. fold in the T fresh rows in float32, dequantized (int8 value times
  // its scale), in order t_k = 0..T-1; query row r (t_q = r / G) sees
  // t_k <= t_q. One thread per (row, fresh row) score, from shared memory.
  float* nk_s = acc_s + kRowsA * kOP;  // [kMT][D]: the fresh K rows, dequantized
  __syncthreads();  // the merge no longer reads what nk_s covers
  for (int c = tid; c < TQ * D; c += kVerifyThreads) {
    nk_s[c] = static_cast<float>(fresh[c]) * fsc[c / D];
    nv_s[c] = static_cast<float>(fresh[kMT * D + c]) * fsc[TQ + c / D];
  }
  __syncthreads();
  for (int idx = tid; idx < NQ * TQ; idx += kVerifyThreads) {
    const int r = idx / TQ, tk = idx % TQ;
    if (tk > r / G) continue;  // masked
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 qv = *reinterpret_cast<const uint4*>(q_s + r * P + 8 * c);
      const float4 k0 = *reinterpret_cast<const float4*>(nk_s + tk * D + 8 * c);
      const float4 k1 = *reinterpret_cast<const float4*>(nk_s + tk * D + 8 * c + 4);
      const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
      const float ke[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j & 3] += __bfloat162float(qe[j]) * ke[j];
    }
    s_new[r * kMT + tk] = ((part[0] + part[1]) + (part[2] + part[3])) * scale_log2;
  }
  __syncthreads();
  if (tid < NQ) {
    const int tq_r = tid / G;
    out_row[tid] = (b * TQ + tq_r) * H + kvh * G + tid % G;
    float mm = row_m[tid], ll = row_l[tid];
    for (int tk = 0; tk < TQ; ++tk) {
      float a = 1.f, p = 0.f;
      if (tk <= tq_r) {
        const float sx = s_new[tid * kMT + tk];
        const float m_new = fmaxf(mm, sx);
        a = fast_exp2(mm - m_new);  // no old rows: exp2(-1e30 - s) = 0
        p = fast_exp2(sx - m_new);
        ll = a * ll + p;
        mm = m_new;
      }
      fold_a[tid * kMT + tk] = a;
      fold_p[tid * kMT + tk] = p;
    }
    row_l[tid] = ll;
  }
  __syncthreads();
  // thread tid writes column tid % D of rows tid / D, tid / D + 128 / D, ...
  static_assert(kVerifyThreads % D == 0, "a head dim that divides the block");
  const int d = tid % D;
  float nv[kMT];
#pragma unroll
  for (int tk = 0; tk < kMT; ++tk) nv[tk] = tk < TQ ? nv_s[tk * D + d] : 0.f;
#pragma unroll
  for (int r = tid / D; r < NQ; r += kVerifyThreads / D) {
    float a = acc_s[r * kOP + d];
#pragma unroll
    for (int tk = 0; tk < kMT; ++tk) {
      if (tk < TQ) a = a * fold_a[r * kMT + tk] + fold_p[r * kMT + tk] * nv[tk];
    }
    out[static_cast<size_t>(out_row[r]) * D + d] =
        __float2bfloat16_rn(a / row_l[r]);  // >= 1: the max score's exp2(0)
  }
  if (n_splits > 1 && tid == 0) counters[bh] = 0;  // ready for the next call
}

template <int D, int NQ>
cudaError_t launch_verify(const void* q, const int8_t* nk, const int8_t* nv, const void* nks,
                          const void* nvs, int8_t* kc, int8_t* vc, void* ksc, void* vsc,
                          const int* lens, void* out, float* partials, int* counters, int B,
                          int TQ, int KVH, int G, int M, int layer, int run_rows, float scale,
                          cudaStream_t stream) {
  using Tile = VerifyTile<D, NQ>;
  if (run_rows < 64 || run_rows % 64 || TQ > kVerifyMaxT ||
      (M + run_rows - 1) / run_rows > Tile::kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  auto kernel = verify_split_kernel<D, NQ>;
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + run_rows - 1) / run_rows, KVH, B);
  kernel<<<grid, kVerifyThreads, Tile::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, static_cast<const __nv_bfloat16*>(nks),
      static_cast<const __nv_bfloat16*>(nvs), kc, vc, static_cast<__nv_bfloat16*>(ksc),
      static_cast<__nv_bfloat16*>(vsc), lens, static_cast<__nv_bfloat16*>(out), partials,
      counters, B, TQ, KVH, G, M, layer, run_rows, scale * kLog2e);
  return cudaGetLastError();
}

// registers, local (spilled) bytes, dynamic shared bytes, resident blocks per
// SM and rows per run of the bf16 instance
template <int D, int NQ>
cudaError_t verify_info(int* info) {
  using Tile = VerifyTile<D, NQ>;
  auto kernel = verify_split_kernel<D, NQ>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(Tile::kSmem);
  info[4] = Tile::kMaxSplits;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, kVerifyThreads,
                                                       Tile::kSmem);
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
    return launch_verify<D, NQ>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, partials,
                                counters, B, TQ, KVH, G, M, layer, run_rows, scale, st);
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
  if (D == DD && NQ == NN) return static_cast<int>(karanta::verify_info<DD, NN>(info));

// info[5] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, resident blocks per SM and the most runs a slot
// may have (ceil(M / run_rows)) of the bf16 instance for (D, G * T).
// Returns the CUDA error code.
extern "C" int karanta_decode_append_multi_quant_info(int D, int NQ, int* info) {
  KARANTA_MULTI_PAIRS(KARANTA_MULTI_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
