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
// The bf16 instance (decode_quant_tma_kernel) replaces the one that ran
// #5's split body over int8 rows (decode_split.cuh: a cp.async ring per
// warp, each landed 16-row chunk converted into a bf16 stage and read back
// with ldmatrix, blocks of (slot, kv head, run) in a grid whose last wave
// was ragged at B = 80), which reached 47% of the bound at B = 80 on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md). Its design (the pieces the
// verify kernels #4 and #7 share are in quant_tma.cuh):
//
// - Work. A (slot, kv head) segment's live rows are cut into chunks of
//   kQRows rows (one chunk when cache_len is 0) and the chunks into runs
//   of run_rows rows: the items, in a fixed order (every segment's first
//   run, then every second run, and so on). The grid is every block the
//   card holds at once, and walks the items in rounds: block i takes item
//   i of each even round and grid - 1 - i of each odd one. When all the
//   items fit the grid a block takes one; when they do not, a block goes
//   on to its next item as it finishes one (its producer starts that
//   item's loads while the consumers merge), and the order evens the
//   blocks' rows out (no block takes a first, longest run every round).
//   Every block reads cache_len and finds its items itself (the host
//   cannot read it without a sync). An item's rows and so its partial
//   depend only on its slot's length and run_rows, not on the other slots
//   or on which block took it. A segment of one run finishes in its block;
//   one of several (at most kQMaxPieces) is finished by the last of its
//   blocks, which a counter taken with acquire-release semantics names,
//   merging the runs' partials in run order in one round of loads, so two
//   calls give the same bits. The block of a segment's first run writes
//   the new row and its scales at cache_len (no block loads that row as a
//   key).
// - Loads. A producer warpgroup, one warp of it working, issues 1-D bulk
//   copies (cp.async.bulk, no tensor map) into a ring of kQStages stages,
//   each under a full and an empty mbarrier: a chunk's K rows, its V rows
//   and its two scale columns are each one contiguous range of the slab,
//   four copies a chunk, under an L2 evict-first policy (the cache is read
//   once a step); Q and this step's K/V rows come the same way, once an
//   item, into a two-slot ring of their own, beside the new row's two
//   scales (a producer lane's plain loads). Only the live rows are copied.
//   When M is not a multiple of 8 a slab's scales are not 16-byte aligned,
//   and the producer's lanes load the chunk's scales with plain loads. The
//   producer warpgroup gives its registers to the consumers (setmaxnreg),
//   so two blocks fit an SM without spills.
// - No bf16 stage. The consumer warpgroup's 4 warps share each stage, two
//   16-key tiles a warp, and turn the landed int8 bytes into mma.sync
//   operands in registers (each byte into a float 2^23 + 128 + b, minus
//   the bias, its upper half the exact bf16). Q.K^T sums over D in any
//   order, so D is permuted alike in Q's A fragments (read once an item)
//   and in the K bytes: lane (g, t) reads D / 4 contiguous bytes of key g
//   and of key g + 8 (two 16-byte loads at D = 128, taken in an order set
//   by g's parity, so a warp's loads meet no bank conflict). P.V sums over
//   the keys: P comes from the S accumulators as they are (the A operand),
//   and lane (g, t) reads D / 8 contiguous bytes of each of its four keys,
//   whose byte n and its pair's make the B operand of output column
//   g D / 8 + n (those reads meet 4-way bank conflicts, which cost less
//   than a stage would). A stage's scales are read beside the rows.
// - Stale bytes. Rows past a chunk's live rows are whatever the stage held
//   (NaN or inf scales included), so a dead key's score and its p * vsc are
//   selected away, never multiplied away.
// - Products on mma.sync.m16n8k16 (bf16, float32 accumulators), not wgmma:
//   the G <= 8 query heads would fill 8 of wgmma's 64 rows, and its B
//   operand would have to be bf16 in shared memory, the stage this design
//   removes. Each warp keeps an online softmax (log2 domain) and a float32
//   (m, l, O); p * vsc is rounded to bf16 before P.V, as the TPU kernel
//   rounds it (decode_attention.py:821-846), and l sums the unrounded p.
//   At an item's start the consumers compute the new row's score (while
//   the first chunk lands); at its end they merge their warps in shared
//   memory in a fixed order, then store a partial or finish: the new row
//   folded in float32 from its int8 values times its scales, then the
//   division.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (bench/flash_ab.py --kernel
// 3, the old instance built from its source and timed in turns; PERF.md
// has every shape): at B = 80 filled to 1,650 of 1,920 rows 0.0658 ms
// against 0.089 (63% of the 0.0414 ms bound), at B = 4 0.0106-0.0109 ms
// against 0.0138. Equal shares of the chunks in place of the items were
// 7% faster at B = 80 but cut a slot where the shares fell, so its bits
// depended on the other slots; a walk of one direction left blocks three
// first runs (0.0734 ms); runs of 256 or 512 rows at B = 80 cost more in
// item starts and merges (0.090 / 0.071 ms) than they gain in balance. A
// per-phase trace (bench/flash_trace.py --kernel 3) showed an item's
// start and end as the cost at small B; 64-row stages (one 16-key tile a
// warp) in rings of 3, 4 or 5 were slower than two 128-row stages; without
// the evict-first policy B = 80 took 6% longer.
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
#include "hopper.cuh"
#include "quant_tma.cuh"

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

// --- the bf16 instance ---------------------------------------------------------

// D / 8 bytes of one stored V row at byte g * D / 8 (D = 16: two bytes in
// the low half of the word), each word XORed with 0x80808080
template <int D>
__device__ __forceinline__ void load_v_words(const int8_t* row, int g,
                                             uint32_t (&w)[D >= 32 ? D / 32 : 1]) {
  const int8_t* p = row + g * (D / 8);
  if constexpr (D == 128) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (D == 64) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else if constexpr (D == 32) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
#pragma unroll
  for (int i = 0; i < (D >= 32 ? D / 32 : 1); ++i) w[i] ^= 0x80808080u;
}

constexpr int kQWarps = 4;                     // consumer warps (a warpgroup)
constexpr int kQThreads = (kQWarps + 4) * 32;  // and a producer warpgroup (one warp works)
// registers a thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers, so two blocks fit an SM without spills
constexpr int kQProducerRegs = 40, kQConsumerRegs = 216;
constexpr int kQRows = 128;                    // cache rows a chunk (one stage)
constexpr int kQStages = 2;                    // ring depth
constexpr int kQTiles = kQRows / (16 * kQWarps);  // 16-key tiles of a chunk a warp takes
static_assert(kQTiles >= 1 && kQRows == 16 * kQWarps * kQTiles, "whole 16-key tiles a warp");

template <int D, int G>
struct QuantTma {
  // a stage: K rows [kQRows][D], V rows, then K and V scales [kQRows] each
  static constexpr int kStage = 2 * kQRows * D + 4 * kQRows;
  static constexpr int kBarBytes = ((2 * kQStages + 4) * 8 + 15) / 16 * 16;
  // an item's slot (a ring of two): Q [8][D] bf16 (G rows written), the new K and V rows,
  // the new row's scores s_x [8], its K and V scales (bf16), padding
  static constexpr int kSeg = 18 * D + 48;
  static constexpr int kOffSeg = kBarBytes + kQStages * kStage;
  static constexpr int kOffRed = kOffSeg + 2 * kSeg;
  // the warps' O [W][G][D], m and l [W][8]; the pieces' m and l
  // [kQMaxPieces][8] each; m and l [8]; the last-block flag
  static constexpr int kRedFloats = kQWarps * G * D + 16 * kQWarps + 16 * kQMaxPieces + 16 + 4;
  static constexpr int kOffLens = kOffRed + (kRedFloats * 4 + 15) / 16 * 16;
  // one (slot, kv head, piece) partial: O [8][D], m [8], l [8], float32
  static constexpr int kPartial = 8 * D + 16;
  // behind the rest: the item offsets of each run [kQMaxPieces + 1], then
  // each slot's clamped cache_len and runs [B] each
  static size_t smem(int B) {
    return kOffLens + static_cast<size_t>(kQMaxPieces + 1 + 2 * B) * 4;
  }
  static_assert(kStage % 16 == 0 && kSeg % 16 == 0, "16-byte aligned regions");
};

template <int D, int G>
__global__ void __launch_bounds__(kQThreads, 2) decode_quant_tma_kernel(
    const __nv_bfloat16* __restrict__ q,                                 // (B, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, KVH, D)
    const __nv_bfloat16* __restrict__ new_ks,                            // (B, KVH)
    const __nv_bfloat16* __restrict__ new_vs,
    int8_t* k_cache, int8_t* v_cache,                  // (L, B, KVH, M, D)
    __nv_bfloat16* ks_cache, __nv_bfloat16* vs_cache,  // (L, B, KVH, M)
    const int* __restrict__ cache_len,                 // (B,)
    __nv_bfloat16* __restrict__ out,                   // (B, KVH*G, D)
    float* __restrict__ partials,  // (B*KVH, ceil(M / run_rows), kPartial)
    int* __restrict__ counters,    // (B*KVH,), 0 between calls
    int B, int KVH, int M, int layer, int run_rows, float scale_log2) {
  static_assert(G <= 8, "the query heads fill at most half the 16-row tile");
  using L = QuantTma<D, G>;
  constexpr int kKT = D / 16, kNT = D / 8, kVW = D >= 32 ? D / 32 : 1;
  constexpr int kCT = kQWarps * 32;  // consumer threads
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kQStages;
  uint64_t* seg_full = empty + kQStages;
  uint64_t* seg_empty = seg_full + 2;
  unsigned char* ring = smem + L::kBarBytes;
  float* red_o = reinterpret_cast<float*>(smem + L::kOffRed);  // [W][G][D]
  float* red_m = red_o + kQWarps * G * D;                       // [W][8]
  float* red_l = red_m + 8 * kQWarps;                           // [W][8], then factors
  float* pm = red_l + 8 * kQWarps;                              // [pieces][8], then weights
  float* pl = pm + 8 * kQMaxPieces;                             // [pieces][8]
  float* row_m = pl + 8 * kQMaxPieces;                          // [8]
  float* row_l = row_m + 8;                                     // [8]
  int* flag = reinterpret_cast<int*>(row_l + 8);
  int* lvl = reinterpret_cast<int*>(smem + L::kOffLens);  // [n_runs + 1]
  int* lens = lvl + kQMaxPieces + 1;                       // [B]
  int* nruns = lens + B;                                   // [B]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int run = run_rows / kQRows;                    // chunks an item (a run)
  const int n_runs = (M + run_rows - 1) / run_rows;    // the partials' stride

  if (tid == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes (scales when M % 8 != 0)
      mbar_init(&empty[s], kQWarps);
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(&seg_full[p], 2);  // the copies' lane and the new scales' lane
      mbar_init(&seg_empty[p], kCT);
    }
    fence_barrier_init();
  }
  // every slot's live rows (the clamp keeps a bad value inside the slab; the
  // new row goes to len) and runs (of max(1, ceil(len / kQRows)) chunks),
  // then the items before each run r: KVH for every slot with more than r
  for (int b = tid; b < B; b += kQThreads) {
    const int len = min(max(cache_len[b], 0), M - 1);
    lens[b] = len;
    nruns[b] = (max(1, (len + kQRows - 1) / kQRows) + run - 1) / run;
  }
  __syncthreads();
  if (warp == 0) item_offsets(nruns, B, KVH, n_runs, lvl, lane);
  __syncthreads();

  // This block's items: walk_item(k) for k = 0, 1, ... below n_items
  const int n_items = lvl[n_runs];
  if (static_cast<int>(blockIdx.x) >= n_items) return;

  if (warp >= kQWarps) {
    regs_dec<kQProducerRegs>();
    if (warp > kQWarps) return;
    // the producer: an item's Q, new rows and new scales into its slot, then
    // every chunk's live K and V rows and their scales into the ring
    const bool sc_bulk = M % 8 == 0;  // every slab's scales 16-byte aligned
    const uint64_t stream = l2_evict_first();  // the cache is read once a step
    int i = 0, seg = 0;  // chunks and items so far
    for (int k = 0; k * static_cast<int>(gridDim.x) < n_items; ++k) {
      const int it = walk_item(k);
      if (it >= n_items) continue;
      const QuantItem w = find_item<kQRows>(lens, nruns, lvl, B, KVH, run, it, lane);
      const size_t bh = static_cast<size_t>(w.b) * KVH + w.kvh;
      const size_t slab = (static_cast<size_t>(layer) * B * KVH + bh) * M;
      const int p = seg & 1;
      mbar_wait(&seg_empty[p], ((seg >> 1) & 1) ^ 1);
      unsigned char* sg = smem + L::kOffSeg + p * L::kSeg;
      if (lane == 0) {
        mbar_expect_tx(&seg_full[p], G * D * 2 + 2 * D);
        bulk_load(sg, q + bh * G * D, G * D * 2, &seg_full[p]);
        bulk_load(sg + 16 * D, new_k + bh * D, D, &seg_full[p]);
        bulk_load(sg + 17 * D, new_v + bh * D, D, &seg_full[p]);
      } else if (lane == 1) {
        __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(sg + 18 * D + 32);
        sc[0] = new_ks[bh];
        sc[1] = new_vs[bh];
        mbar_arrive(&seg_full[p]);
      }
      for (int c = w.c; c < w.c + w.nc; ++c, ++i) {
        const int s = i % kQStages;
        mbar_wait(&empty[s], ((i / kQStages) & 1) ^ 1);
        const int c0 = c * kQRows, n = max(0, min(kQRows, w.len - c0));
        unsigned char* st = ring + s * L::kStage;
        __nv_bfloat16* st_sc = reinterpret_cast<__nv_bfloat16*>(st + 2 * kQRows * D);
        if (!sc_bulk) {
          // unaligned scales: the lanes load them (before they arrive)
          for (int j = lane; j < n; j += 32) {
            st_sc[j] = ks_cache[slab + c0 + j];
            st_sc[kQRows + j] = vs_cache[slab + c0 + j];
          }
        }
        if (lane == 0) {
          // whole 16-byte words of scales: up to 7 past the live rows, all
          // inside the slab (M % 8 == 0)
          const int n_sc = sc_bulk ? (n + 7) & ~7 : 0;
          mbar_expect_tx(&full[s], 2 * n * D + 4 * n_sc);
          if (n > 0) {
            bulk_load_hint(st, k_cache + (slab + c0) * D, n * D, &full[s], stream);
            bulk_load_hint(st + kQRows * D, v_cache + (slab + c0) * D, n * D, &full[s], stream);
          }
          if (n_sc > 0) {
            bulk_load_hint(st_sc, ks_cache + slab + c0, 2 * n_sc, &full[s], stream);
            bulk_load_hint(st_sc + kQRows, vs_cache + slab + c0, 2 * n_sc, &full[s], stream);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
      ++seg;
    }
    return;
  }

  // the consumers
  regs_inc<kQConsumerRegs>();
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[kKT][4];
  float o[kNT][2];
  int i = 0, seg = 0;  // chunks and items so far
  for (int k = 0; k * static_cast<int>(gridDim.x) < n_items; ++k) {
    const int it = walk_item(k);
    if (it >= n_items) continue;
    // an item starts: Q, the new row's scores and the append
    const QuantItem w = find_item<kQRows>(lens, nruns, lvl, B, KVH, run, it, lane);
    const int p = seg & 1, piece = w.piece, n_pieces = w.pieces;
    const size_t bh = static_cast<size_t>(w.b) * KVH + w.kvh;
    const unsigned char* sg = smem + L::kOffSeg + p * L::kSeg;
    mbar_wait(&seg_full[p], (seg >> 1) & 1);
    const __nv_bfloat16* q_s = reinterpret_cast<const __nv_bfloat16*>(sg);
    const __nv_bfloat16* nsc = reinterpret_cast<const __nv_bfloat16*>(sg + 18 * D + 32);
    // lane (g, t): q[g][t D/4 + 4 kk .. + 3] as a0 and a2 of k-step kk (the
    // K bytes below are read in the same order of D); rows g >= G zero
    {
      uint32_t qw[D / 8];
      const uint32_t* src = reinterpret_cast<const uint32_t*>(q_s + g * D + t * (D / 4));
#pragma unroll
      for (int x = 0; x < D / 8; ++x) qw[x] = g < G ? src[x] : 0u;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        qa[kk][0] = qw[2 * kk];
        qa[kk][1] = 0u;
        qa[kk][2] = qw[2 * kk + 1];
        qa[kk][3] = 0u;
      }
    }
    // the new row's score per head, log2 domain: s_x = q . (k_new * ks_new),
    // a warp a head, in float32 (while the first chunk lands)
    const int8_t* nk_s = reinterpret_cast<const int8_t*>(sg + 16 * D);
    float* sx = reinterpret_cast<float*>(const_cast<unsigned char*>(sg) + 18 * D);
    const float nks = __bfloat162float(nsc[0]), nvs = __bfloat162float(nsc[1]);
    for (int h = warp; h < G; h += kQWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        dot += __bfloat162float(q_s[h * D + d]) * (static_cast<float>(nk_s[d]) * nks);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) sx[h] = dot * scale_log2;
    }
    if (piece == 0) {
      // the block of the segment's first run writes the new row and its
      // scales at len (no block loads that row as a key)
      const size_t at = (static_cast<size_t>(layer) * B * KVH + bh) * M + w.len;
      constexpr int kVec = D / 16;
      if (tid < 2 * kVec) {
        const bool is_v = tid >= kVec;
        const int col = (is_v ? tid - kVec : tid) * 16;
        *reinterpret_cast<uint4*>((is_v ? v_cache : k_cache) + at * D + col) =
            *reinterpret_cast<const uint4*>(sg + (is_v ? 17 : 16) * D + col);
      } else if (tid == 2 * kVec) {
        ks_cache[at] = nsc[0];
      } else if (tid == 2 * kVec + 1) {
        vs_cache[at] = nsc[1];
      }
    }
    float m = kNegInf, l = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) o[nt][0] = o[nt][1] = 0.f;

    for (int c = w.c; c < w.c + w.nc; ++c, ++i) {
      const int s = i % kQStages;
      const int n = max(0, min(kQRows, w.len - c * kQRows));  // live rows of the chunk
      mbar_wait(&full[s], (i / kQStages) & 1);
      const int8_t* st = reinterpret_cast<const int8_t*>(ring + s * L::kStage);
      const __nv_bfloat16* st_ks = reinterpret_cast<const __nv_bfloat16*>(st + 2 * kQRows * D);
      const __nv_bfloat16* st_vs = st_ks + kQRows;
      // S = Q K^T over this warp's keys: element (j, e) of lane (g, t) is key
      // r0 + 8 j + 2 t + e of head g
      float sc[kQTiles][2][4];
      float vsc[kQTiles][2][2];
      uint32_t vw[kQTiles][4][kVW];
      float mx = m;
#pragma unroll
      for (int tt = 0; tt < kQTiles; ++tt) {
        const int r0 = 16 * (warp * kQTiles + tt);
        uint32_t kw[2][kKT];
        load_k_words<D>(st + (r0 + g) * D, t, g & 1, kw[0]);
        load_k_words<D>(st + (r0 + g + 8) * D, t, g & 1, kw[1]);
        // V: keys 2t, 2t + 1, 2t + 8, 2t + 9 of the tile
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          load_v_words<D>(st + kQRows * D + (r0 + 8 * (e4 >> 1) + 2 * t + (e4 & 1)) * D, g,
                          vw[tt][e4]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[tt][j][0] = sc[tt][j][1] = sc[tt][j][2] = sc[tt][j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t u = kw[j][kk] ^ 0x80808080u;
            mma_bf16_16816(sc[tt][j], qa[kk], upper_halves(biased_byte(u, 0), biased_byte(u, 1)),
                           upper_halves(biased_byte(u, 2), biased_byte(u, 3)));
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(st_ks + r0 + 8 * j + 2 * t));
          const float2 vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(st_vs + r0 + 8 * j + 2 * t));
          vsc[tt][j][0] = vf.x;
          vsc[tt][j][1] = vf.y;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // a dead key is selected away: its bytes and scales may be stale
            const bool live = r0 + 8 * j + 2 * t + e < n;
            const float x = sc[tt][j][e] * (e ? kf.y : kf.x) * scale_log2;
            sc[tt][j][e] = live ? x : -CUDART_INF_F;
            mx = fmaxf(mx, sc[tt][j][e]);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = fast_exp2(m - mx);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        o[nt][0] *= alpha;
        o[nt][1] *= alpha;
      }
#pragma unroll
      for (int tt = 0; tt < kQTiles; ++tt) {
        const int r0 = 16 * (warp * kQTiles + tt);
        float pv[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = fast_exp2(sc[tt][j][e] - mx);
            l += pe;  // the unrounded p
            pv[j][e] = r0 + 8 * j + 2 * t + e < n ? pe * vsc[tt][j][e] : 0.f;
          }
        }
        // O += P V: P (rounded to bf16) as the A operand, the padding rows
        // zero; V's bytes n of keys (2t, 2t + 1) and (2t + 8, 2t + 9) as B
        const uint32_t pa[4] = {pack_bf16(pv[0][0], pv[0][1]), 0u, pack_bf16(pv[1][0], pv[1][1]),
                                0u};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t b0 = upper_halves(biased_byte(vw[tt][0][nt >> 2], nt & 3),
                                           biased_byte(vw[tt][1][nt >> 2], nt & 3));
          const uint32_t b1 = upper_halves(biased_byte(vw[tt][2][nt >> 2], nt & 3),
                                           biased_byte(vw[tt][3][nt >> 2], nt & 3));
          float cc[4] = {o[nt][0], o[nt][1], 0.f, 0.f};
          mma_bf16_16816(cc, pa, b0, b1);
          o[nt][0] = cc[0];
          o[nt][1] = cc[1];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the item ends: merge the warps in a fixed order; a segment of one run
    // finishes here, one of several through the partials
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (g < G) {
      // lane (g, t) holds O[g][t D/4 + x]: x < D/8 in o[x][0], else o[x - D/8][1]
      float* dst = red_o + (warp * G + g) * D + t * (D / 4);
#pragma unroll
      for (int x = 0; x < kNT; x += 2) {
        *reinterpret_cast<float2*>(dst + x) = make_float2(o[x][0], o[x + 1][0]);
        *reinterpret_cast<float2*>(dst + kNT + x) = make_float2(o[x][1], o[x + 1][1]);
      }
      if (t == 0) {
        red_m[warp * 8 + g] = m;
        red_l[warp * 8 + g] = l;
      }
    }
    named_sync(1, kCT);
    // per head: the warps' max, each warp's factor exp2(m_w - m) (a warp
    // without keys: 0) in place of its l, and the merged l
    if (tid < G) {
      float wm = red_m[tid];
#pragma unroll
      for (int ww = 1; ww < kQWarps; ++ww) wm = fmaxf(wm, red_m[ww * 8 + tid]);
      float ls = 0.f;
#pragma unroll
      for (int ww = 0; ww < kQWarps; ++ww) {
        const float f = fast_exp2(red_m[ww * 8 + tid] - wm);
        ls += red_l[ww * 8 + tid] * f;
        red_l[ww * 8 + tid] = f;
      }
      row_m[tid] = wm;
      row_l[tid] = ls;
    }
    named_sync(1, kCT);
    // this thread's elements e = tid + kCT k of the G x D output
    constexpr int kPer = (G * D + kCT - 1) / kCT;
    float acc[kPer];
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      const int e = tid + kCT * kk, h = e / D, d = e % D;
      acc[kk] = 0.f;
      if (e >= G * D) continue;
#pragma unroll
      for (int ww = 0; ww < kQWarps; ++ww) {
        acc[kk] += red_o[(ww * G + h) * D + d] * red_l[ww * 8 + h];
      }
    }
    bool finish = n_pieces == 1;
    if (!finish) {
      float* rec = partials + (bh * n_runs + piece) * L::kPartial;
#pragma unroll
      for (int kk = 0; kk < kPer; ++kk) {
        const int e = tid + kCT * kk;
        if (e < G * D) rec[e] = acc[kk];
      }
      if (tid < G) {
        rec[8 * D + tid] = row_m[tid];
        rec[8 * D + 8 + tid] = row_l[tid];
      }
      // the last block of this segment merges the pieces: a release of this
      // block's partial, an acquire of the others'
      named_sync(1, kCT);
      if (tid == 0) {
        int before;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                     : "=r"(before) : "l"(counters + bh), "r"(1) : "memory");
        *flag = before == n_pieces - 1;
      }
      named_sync(1, kCT);
      finish = *flag;
      if (finish) {
        // every piece's m and l into shared memory and the first four
        // pieces' O into registers, in one round of loads
        const float* base = partials + bh * n_runs * L::kPartial;
        for (int x = tid; x < n_pieces * 8; x += kCT) {
          if ((x & 7) < G) {
            pm[x] = __ldcg(base + (x >> 3) * L::kPartial + 8 * D + (x & 7));
            pl[x] = __ldcg(base + (x >> 3) * L::kPartial + 8 * D + 8 + (x & 7));
          }
        }
        constexpr int kBatch = 4;
        float v[kBatch][kPer];
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
#pragma unroll
          for (int kk = 0; kk < kPer; ++kk) {
            const int e = tid + kCT * kk;
            v[jj][kk] = jj < n_pieces && e < G * D ? __ldcg(base + jj * L::kPartial + e) : 0.f;
          }
        }
        named_sync(1, kCT);
        if (tid < G) {
          float wm = kNegInf;
          for (int j = 0; j < n_pieces; ++j) wm = fmaxf(wm, pm[j * 8 + tid]);
          float ls = 0.f;
          for (int j = 0; j < n_pieces; ++j) {
            const float f = fast_exp2(pm[j * 8 + tid] - wm);
            ls += pl[j * 8 + tid] * f;
            pm[j * 8 + tid] = f;
          }
          row_m[tid] = wm;
          row_l[tid] = ls;
        }
        named_sync(1, kCT);
        // the pieces' O in order: the first four from registers, any more
        // four at a time
#pragma unroll
        for (int kk = 0; kk < kPer; ++kk) {
          const int e = tid + kCT * kk;
          acc[kk] = 0.f;
          if (e >= G * D) continue;
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj) {
            if (jj < n_pieces) acc[kk] += v[jj][kk] * pm[jj * 8 + e / D];
          }
        }
        for (int j0 = kBatch; j0 < n_pieces; j0 += 4) {
          float u[4][kPer];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int kk = 0; kk < kPer; ++kk) {
              const int e = tid + kCT * kk;
              u[jj][kk] = j0 + jj < n_pieces && e < G * D
                              ? __ldcg(base + (j0 + jj) * L::kPartial + e)
                              : 0.f;
            }
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int kk = 0; kk < kPer; ++kk) {
              const int e = tid + kCT * kk;
              if (j0 + jj < n_pieces && e < G * D) {
                acc[kk] += u[jj][kk] * pm[(j0 + jj) * 8 + e / D];
              }
            }
          }
        }
        if (tid == 0) counters[bh] = 0;  // ready for the next call
      }
    }
    if (finish) {
      // fold in the new row in float32 after the old rows, then normalise
      const int8_t* nv_s = reinterpret_cast<const int8_t*>(sg + 17 * D);
      __nv_bfloat16* out_bh = out + bh * G * D;
#pragma unroll
      for (int kk = 0; kk < kPer; ++kk) {
        const int e = tid + kCT * kk, h = e / D, d = e % D;
        if (e >= G * D) continue;
        const float s_x = sx[h], hm = row_m[h];
        const float m_new = fmaxf(hm, s_x);
        const float p_x = fast_exp2(s_x - m_new);
        const float a = fast_exp2(hm - m_new);  // no old rows: exp2(-1e30 - s) = 0
        const float vd = static_cast<float>(nv_s[d]) * nvs;
        out_bh[e] = __float2bfloat16_rn((acc[kk] * a + p_x * vd) / (a * row_l[h] + p_x));
      }
    }
    mbar_arrive(&seg_empty[p]);
    named_sync(1, kCT);  // the merge area is free again
    ++seg;
  }
}

// internal linkage: its cache is this library's own (a function-local static
// of a template with external linkage is one object in the whole process,
// shared by every library built from this source)
namespace {

template <int D, int G>
cudaError_t launch_quant_tma(const void* q, const int8_t* nk, const int8_t* nv, const void* nks,
                             const void* nvs, int8_t* kc, int8_t* vc, void* ksc, void* vsc,
                             const int* lens, void* out, float* partials, int* counters, int B,
                             int KVH, int M, int layer, int run_rows, float scale,
                             cudaStream_t stream) {
  if (run_rows < kQRows || run_rows % kQRows || (M + run_rows - 1) / run_rows > kQMaxPieces) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decode_quant_tma_kernel<D, G>;
  const size_t smem = QuantTma<D, G>::smem(B);
  // the grid: every block the card holds at once
  static ResidentGrid cache;
  int grid = 0;
  const cudaError_t err = resident_grid(kernel, kQThreads, smem, cache, &grid);
  if (err != cudaSuccess) return err;
  // the kernel's item indices (items and the grid) stay in 32 bits
  const long long items = static_cast<long long>(B) * KVH * ((M + kQRows - 1) / kQRows);
  if (items + grid >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<grid, kQThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, static_cast<const __nv_bfloat16*>(nks),
      static_cast<const __nv_bfloat16*>(nvs), kc, vc, static_cast<__nv_bfloat16*>(ksc),
      static_cast<__nv_bfloat16*>(vsc), lens, static_cast<__nv_bfloat16*>(out), partials,
      counters, B, KVH, M, layer, run_rows, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// registers, local (spilled) bytes, dynamic shared bytes (at B = 0; 8 bytes
// more a slot), resident blocks per SM at that size, the most runs a slot
// may have, rows a chunk, ring stages and consumer warps of the bf16 instance
template <int D, int G>
cudaError_t quant_tma_info(int* info) {
  auto kernel = decode_quant_tma_kernel<D, G>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const size_t smem = QuantTma<D, G>::smem(0);
  cudaFuncAttributes attr;
  cudaError_t err = allow_all_smem(kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[4] = kQMaxPieces;
  info[5] = kQRows;
  info[6] = kQStages;
  info[7] = kQWarps;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, kQThreads, smem);
}

template <int D, int G>
cudaError_t launch_pair(int dtype, const void* q, const int8_t* nk, const int8_t* nv,
                        const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                        void* vsc, const int* lens, void* out, float* partials, int* counters,
                        int B, int KVH, int M, int layer, int run_rows, float scale,
                        cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_quant_tma<D, G>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, partials,
                                  counters, B, KVH, M, layer, run_rows, scale, st);
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
// cuts each (slot, kv head) into runs of `run_rows` rows (a multiple of
// info[5], with ceil(M / run_rows) at most info[4] of
// karanta_decode_append_quant_info; the wrapper's rule picks it); the
// float32 instance ignores the three.
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

#define KARANTA_DECODE_INFO(DD, GG) \
  if (D == DD && G == GG) return static_cast<int>(karanta::quant_tma_info<DD, GG>(info));

// info[8] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block (at B = 0; 8 more a slot), resident blocks per SM,
// the most runs a slot may have (ceil(M / run_rows)), rows a chunk, ring
// stages and consumer warps of the bf16 instance for (D, G). Returns the
// CUDA error code.
extern "C" int karanta_decode_append_quant_info(int D, int G, int* info) {
  KARANTA_ROW_PAIRS(KARANTA_DECODE_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
