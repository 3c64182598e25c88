// Multi-token append + verify attention over a quantized cache on the tensor
// cores, rows split over blocks: the one kernel body of the bf16 instances of
//
// - kernel #4, paged_decode_append_multi_quant (decode_append_multi_quant.cu,
//   kBits = 8): int8 rows, one token each, a bf16 scale per row;
// - kernel #7, paged_decode_append_multi_q4 (decode_append_multi_q4.cu,
//   kBits = 4): the nibble-packed int4 cache (common.cuh, q4_row): packed
//   row 32w + r holds token 64w + r in its low nibble and token 64w + 32 + r
//   in its high nibble, with the scales of kv head h in the two planes 2h
//   (low) and 2h + 1 (high), M packed rows apart.
//
// For each slot b it appends the T speculative tokens' K/V values and their
// scales at tokens cache_len[b] + [0, T) of layer `layer`, in place (the
// int4 cache merges each nibble into its byte and keeps the other one), then
// attends all T queries over the old tokens [0, cache_len[b]) with the
// per-token scales folded into the scores and probabilities, and folds the
// T fresh tokens in last, one at a time, in float32 from their integer
// values times their scales, with the causal rule that query t_q sees fresh
// token t_k iff t_k <= t_q (karanta_tpu/ops/decode_attention.py:1202-1231,
// :1963-1992).
//
// - Runs over blocks. The old rows of one (slot, kv head) are split into runs
//   of run_tokens tokens (a multiple of 64, so no int4 window is split), one
//   block of 8 warps each. The wrapper cannot read cache_len without a host
//   sync, so the grid is (ceil(tokens / run_tokens), KVH, B) and a block
//   whose run starts at or past its slot's live rows exits at once; run 0
//   always runs: it appends the T fresh tokens after its row loop, and it is
//   the only block of a slot with cache_len = 0. No block reads a live value
//   that the append changes: an int4 byte that takes a fresh nibble keeps its
//   other nibble, and a fresh token is masked (its scales read as 0).
// - Tensor cores. The NQ = G * T query rows (row r = t * G + g) are the rows
//   of the A operand, NT = ceil(NQ / 16) tiles of 16 rows (2 at the 7B
//   point's 28 rows). Q.K^T and P.V are mma.sync.m16n8k16 in bf16 with
//   float32 accumulators; K through ldmatrix is the B operand of Q.K^T and V
//   through ldmatrix.trans that of P.V. Each warp holds its Q tile's A
//   fragments in registers across the row loop (measured faster than
//   reloading them each chunk, with no spills: PERF.md).
// - Chunk streams. The NT warps of a stream share its chunks of 16 stored
//   rows (every kStreams-th chunk of the run): each takes one A tile, so a
//   warp holds one tile's O (64 floats a thread at D = 128) and nothing
//   spills; both tiles' O in one warp took 255 registers and spilled. The
//   chunk's K and V rows come through the stream's cp.async ring
//   (kVerifyStages = 3 chunks; 2 for int4 at NQ <= 16), each warp copying
//   and converting its half; named barriers (bar.sync 1 + stream, 64
//   threads) order the ring and the stage between the two. The chunk's bf16 K and V scales are plain loads
//   issued with its rows and stored beside them one iteration later (any M,
//   no alignment needed); a token at or past cache_len gets 0, so that a
//   stale scale cannot make a NaN.
// - Staging (the policy of kBits). A landed chunk is converted into the
//   stream's bf16 stage so ldmatrix applies unchanged: int8 rows into one
//   16-key tile each of K and V (int8x8_to_bf16, mma.cuh); packed int4 rows
//   into two 16-key tiles each, the low plane (tokens 64w + r) and the high
//   plane (64w + 32 + r), with int4x8_to_bf16. Values in [-127, 127] and
//   [-8, 7] are exact in bf16. Each key is masked by its own token index.
//   An int4 chunk carries the same bytes as an int8 chunk and twice the keys.
// - Rounding where the TPU kernels round (decode_attention.py:1164-1196,
//   :1919-1950): scores are s * ksc[key], then * scale (in the log2 domain);
//   l sums the unrounded p; p * vsc[key] is rounded to bf16 before P.V.
// - Merge, then the fresh tokens. The block merges its streams in a fixed
//   order. A slot with more than one run stores a float32 (O, m, l) partial
//   sized for 32 query rows; the last block of the (slot, kv head), found
//   through a counter that it resets to 0, merges the runs in split order
//   (all of a run's float4 loads in flight at once), so two calls give the
//   same bits. Only then does the finishing block fold in the T fresh tokens
//   (copied to shared memory by every block at its start), in float32, in
//   order t_k = 0..T-1, causally. The running max starts at the finite
//   kNegInf, so a slot without old rows (m = -1e30, l = 0) meets the first
//   fresh token without a -inf - -inf: the old rows' weight is
//   exp2(-1e30 - s) = 0.
//
// Measured on the card (PERF.md, NVIDIA H100 80GB HBM3, 700 W): kernel #4 at
// B = 4, T = 4, M = 4096 took 0.024 ms of device time (1.21 ms before this
// design); with one block of 4 warps (both tiles in each warp) a block's
// stages were latency-bound, and 8 warps were faster at every batch size
// tried.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace karanta {

constexpr int kVerifyWarps = 8;
constexpr int kVerifyThreads = 32 * kVerifyWarps;
constexpr int kVerifyStages = 3;   // chunks in flight per stream (VerifyTile::kStages)
constexpr int kVerifyMaxRows = 32;   // query rows of a partial record
constexpr int kVerifyMaxT = 8;       // fresh tokens a call can fold in
static_assert(kVerifyStages >= 2, "the ring needs two stages");

template <int D, int NQ, int kBits>
struct VerifyTile {
  static_assert(NQ <= kVerifyMaxRows, "at most 32 query rows: two 16-row tiles");
  static_assert(kBits == 8 || kBits == 4, "int8 rows or packed int4 rows");
  static constexpr int kTokPerRow = kBits == 8 ? 1 : 2;  // tokens of a stored row
  static constexpr int kKeyTiles = kTokPerRow;  // 16-key tiles of a 16-row chunk
  static constexpr int kScales = 32 * kKeyTiles;  // K, then V scales of a chunk
  static constexpr int NT = (NQ + 15) / 16;  // 16-row A tiles = warps of a stream
  static constexpr int kStreams = kVerifyWarps / NT;  // chunk streams of a block
  // ring depth: an int4 block of 8 one-tile streams (NQ <= 16) holds two
  // chunks a stream, three would take 240 KB of shared memory
  static constexpr int kStages = kBits == 4 && NT == 1 ? 2 : kVerifyStages;
  static constexpr int kRowsA = 16 * NT;
  static constexpr int kPitch = D + 8;  // bf16 rows of Q and of the stage (elements)
  // one ring stage: stored K rows [16][D], stored V rows [16][D], then the
  // chunk's kScales scales (bf16)
  static constexpr int kRingStage = 2 * 16 * D + 2 * kScales;
  // the bf16 stage: K tiles, then V tiles, 16 keys each
  static constexpr int kStageBytes = 2 * 16 * kKeyTiles * kPitch * 2;
  static constexpr int kStreamBytes = kStages * kRingStage + kStageBytes;
  static constexpr int kRingBytes = kStreams * kStreamBytes;
  static constexpr int kQBytes = kRowsA * kPitch * 2;
  static constexpr int kFreshBytes = 2 * kVerifyMaxT * D;  // the fresh K, V values
  // one (slot, kv head, run) partial: O [32][D], m [32], l [32], float32
  static constexpr int kPartial = kVerifyMaxRows * D + 2 * kVerifyMaxRows;
  // After the row loop the rings hold the merge. First the per-row state: m
  // and l, the fresh tokens' scales, scores and fold factors, their
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

// the NT warps of one chunk stream meet here (named barrier 1 + stream)
template <int NT>
__device__ __forceinline__ void stream_sync(int stream) {
  if constexpr (NT == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + stream), "n"(32 * NT) : "memory");
  }
}

template <int D, int NQ, int kBits>
__global__ void __launch_bounds__(kVerifyThreads) verify_split_kernel(
    const __nv_bfloat16* __restrict__ q,                                 // (B, TQ, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, TQ, KVH, D)
    const __nv_bfloat16* __restrict__ new_ks,                            // (B, TQ, KVH)
    const __nv_bfloat16* __restrict__ new_vs,
    int8_t* k_cache, int8_t* v_cache,  // (L, B, KVH, M, D) stored rows, appended
    __nv_bfloat16* ks_cache,           // int8: (L, B, KVH, M); int4: (L, B, 2*KVH, M)
    __nv_bfloat16* vs_cache,
    const int* __restrict__ cache_len,  // (B,) tokens
    __nv_bfloat16* __restrict__ out,    // (B, TQ, KVH*G, D)
    float* __restrict__ partials,       // (B*KVH, gridDim.x, kPartial)
    int* __restrict__ counters,         // (B*KVH,), 0 between calls
    int B, int TQ, int KVH, int G, int M, int layer, int run_tokens, float scale_log2) {
  using Tile = VerifyTile<D, NQ, kBits>;
  constexpr int NT = Tile::NT, kRowsA = Tile::kRowsA, P = Tile::kPitch, kKT = D / 16;
  constexpr int kS = Tile::kStages, kSt = Tile::kStreams, kOP = Tile::kOPitch;
  constexpr int kMT = kVerifyMaxT, kV16 = D / 16;
  constexpr int kTok = Tile::kTokPerRow, kKeyT = Tile::kKeyTiles, kSc = Tile::kScales;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRowsA][P]
  unsigned char* work = smem_raw + Tile::kQBytes;  // streams' rings, then the merge
  int8_t* fresh = reinterpret_cast<int8_t*>(work + Tile::kWorkBytes);  // [K, V][kMT][D]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warp = stream * NT + tile: the NT warps of a stream share its chunks,
  // each takes 16 query rows (one A tile) and 32 / NT of the chunk's 32
  // stored K and V rows for the copy and the conversion
  const int stream = warp / NT, tile = warp % NT;
  const int H = KVH * G;
  // tokens present before the T new ones; the engine keeps len + T <= M - 1,
  // the clamp only keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), kTok * M - TQ);
  // stored rows: runs, this slot's rows that hold a live token
  const int run_rows = run_tokens / kTok;
  const int live = kBits == 8 ? len : q4_live_rows(len);
  const int r0 = split * run_rows;
  if (split > 0 && r0 >= live) return;  // past this slot's old rows
  const int r_end = min(r0 + run_rows, live);
  const int n_splits = max((live + run_rows - 1) / run_rows, 1);
  const int bh = b * KVH + kvh;
  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  int8_t* k_rows = k_cache + slab * D;
  int8_t* v_rows = v_cache + slab * D;
  // int8: the slab's scales; int4: the low plane, the high plane M later
  __nv_bfloat16* k_sc = ks_cache + kTok * slab;
  __nv_bfloat16* v_sc = vs_cache + kTok * slab;

  // 1. every block copies the T fresh tokens and loads their scales now, for
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
  float fresh_scale = 0.f;  // thread tk < T: K scale of fresh token tk; T + tk: its V scale
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
  // this warp carries scales tile * kWarpSc + lane + 32 j of each chunk
  // (slot s: K scales below kSc / 2, then V; key tile (s / 16) % kKeyT, key
  // s % 16): loaded one iteration ahead, stored beside the rows
  constexpr int kWarpSc = kSc / NT;
  constexpr int kScLane = (kWarpSc + 31) / 32;
  auto load_scales = [&](int i, __nv_bfloat16 (&v)[kScLane]) {
    const int c0 = w0 + kStride * i;
#pragma unroll
    for (int j = 0; j < kScLane; ++j) {
      const int local = lane + 32 * j, s = tile * kWarpSc + local;
      const int p = (s >> 4) % kKeyT, r = s & 15;
      const bool ok = local < kWarpSc && chunk_token<kBits>(c0, p, r) < len;
      v[j] = ok ? (s < kSc / 2 ? k_sc : v_sc)[static_cast<size_t>(p) * M + c0 + r]
                : __float2bfloat16_rn(0.f);
    }
  };
  auto store_scales = [&](int i, const __nv_bfloat16 (&v)[kScLane]) {
    __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(my_ring + (i % kS) * Tile::kRingStage +
                                                         32 * D);
#pragma unroll
    for (int j = 0; j < kScLane; ++j) {
      const int local = lane + 32 * j;
      if (local < kWarpSc) sc[tile * kWarpSc + local] = v[j];
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
  __nv_bfloat16 sc_first[kS - 1][kScLane];
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_mine) load_rows(st);
    cp_async_commit();
    if (st < n_mine) load_scales(st, sc_first[st]);
  }
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_mine) store_scales(st, sc_first[st]);
  }
  cp_async_wait<kS - 1>();  // Q and the fresh rows (the ring's groups may fly)
  __syncthreads();

  // lane offsets as in flash_attention.cu: K as B of Q.K^T, V as B of P.V
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * P + (lane >> 4) * 8;
  const __nv_bfloat16* q_tile = q_s + (tile * 16 + (lane & 15)) * P + (lane >> 4) * 8;
  const __nv_bfloat16* v_st = stage + 16 * kKeyT * P;
  // this warp's tile: fragment rows g (h = 0) and g + 8 (h = 1)
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // this warp's Q tile as A fragments, held across the row loop
  uint32_t qa_r[kKT][4];
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) ldmatrix_x4(qa_r[kk], q_tile + kk * 16);

  // a chunk's scales are loaded when its rows are requested and stored one
  // iteration later (their ring stage is free by then), so no load latency
  // stalls the loop
  __nv_bfloat16 sc_pending[kScLane];
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kS - 2>();
    // chunk i landed for every lane of the stream; chunk i - 1's ring stage
    // and the bf16 stage are no longer read
    stream_sync<NT>(stream);
    if (i >= 1 && i + kS - 2 < n_mine) store_scales(i + kS - 2, sc_pending);
    const bool more = i + kS - 1 < n_mine;
    if (more) load_rows(i + kS - 1);
    cp_async_commit();
    if (more) load_scales(i + kS - 1, sc_pending);
    const unsigned char* st = my_ring + (i % kS) * Tile::kRingStage;
    stage_rows<kBits, D, P, kMyRows>(reinterpret_cast<const int8_t*>(st), stage, row_lo, lane);
    stream_sync<NT>(stream);  // the stage holds the whole chunk

    // the scales of this lane's keys 8j + 2t + e of key tile p
    const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(st + 32 * D);
    float ksc[kKeyT][2][2], vsc[kKeyT][2][2];
#pragma unroll
    for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sc + 16 * p + 8 * j + 2 * t));
        const float2 vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sc + kSc / 2 + 16 * p + 8 * j + 2 * t));
        ksc[p][j][0] = kf.x;
        ksc[p][j][1] = kf.y;
        vsc[p][j][0] = vf.x;
        vsc[p][j][1] = vf.y;
      }
    }
    const int c0 = w0 + kStride * i;

    // S = Q K^T over the chunk's keys for this warp's 16 query rows (with
    // one key tile, two accumulation chains, even and odd kk, for the tensor
    // cores' latency; two key tiles are two chains already)
    constexpr int kChains = kKeyT == 1 ? 2 : 1;
    float s[kChains][kKeyT][2][4];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
#pragma unroll
      for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
        for (int j = 0; j < 2; ++j) s[c][p][j][0] = s[c][p][j][1] = s[c][p][j][2] = s[c][p][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      const uint32_t(&qa)[4] = qa_r[kk];
#pragma unroll
      for (int p = 0; p < kKeyT; ++p) {
        uint32_t bb[4];
        ldmatrix_x4(bb, stage + 16 * p * P + k_lane + kk * 16);
        float(&acc2)[2][4] = s[kk % kChains][p];
        mma_bf16_16816(acc2[0], qa, bb[0], bb[1]);
        mma_bf16_16816(acc2[1], qa, bb[2], bb[3]);
      }
    }
    if constexpr (kChains == 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][0][j][e] += s[1][0][j][e];
      }
    }
    // online softmax per fragment row: scores s * ksc, then * scale (log2
    // domain); l sums the unrounded p; P is p * vsc rounded to bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live_key = chunk_token<kBits>(c0, p, 8 * j + 2 * t + e) < len;
            float& x = s[0][p][j][2 * h + e];
            x = live_key ? (x * ksc[p][j][e]) * scale_log2 : -CUDART_INF_F;
            mx = fmaxf(mx, x);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = fast_exp2(m[h] - mx);
      m[h] = mx;
      float sum = l[h] * alpha;
#pragma unroll
      for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[0][p][j][2 * h + e];
            const float pr = fast_exp2(x - mx);
            sum += pr;
            x = pr * vsc[p][j][e];
          }
        }
      }
      l[h] = sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    // O += P V, one k-step per key tile
#pragma unroll
    for (int p = 0; p < kKeyT; ++p) {
      const float(&sp)[2][4] = s[0][p];
      const uint32_t pa[4] = {pack_bf16(sp[0][0], sp[0][1]), pack_bf16(sp[0][2], sp[0][3]),
                              pack_bf16(sp[1][0], sp[1][1]), pack_bf16(sp[1][2], sp[1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, v_st + 16 * p * P + v_lane + np * 16);
        mma_bf16_16816(o[2 * np], pa, bb[0], bb[1]);
        mma_bf16_16816(o[2 * np + 1], pa, bb[2], bb[3]);
      }
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
    // the T tokens and scales at len .. len+T-1 (no block of this call reads
    // a value that changes)
    if constexpr (kBits == 8) {
      for (int c = tid; c < 2 * TQ * kV16; c += kVerifyThreads) {
        const bool is_v = c >= TQ * kV16;
        const int cc = is_v ? c - TQ * kV16 : c;
        const int tk = cc / kV16, col = (cc % kV16) * 16;
        *reinterpret_cast<uint4*>((is_v ? v_rows : k_rows) +
                                  static_cast<size_t>(len + tk) * D + col) =
            *reinterpret_cast<const uint4*>(fresh + (is_v * kMT + tk) * D + col);
      }
    } else {
      // one thread and one store per byte: with T <= 32 no two fresh tokens
      // share a byte (the tokens of a byte are 32 apart)
      for (int c = tid; c < 2 * TQ * D; c += kVerifyThreads) {
        const bool is_v = c >= TQ * D;
        const int cc = is_v ? c - TQ * D : c;
        const int tk = cc / D, d = cc % D, tok = len + tk;
        int8_t* at = (is_v ? v_rows : k_rows) + static_cast<size_t>(q4_row(tok)) * D + d;
        *at = q4_merge(*at, fresh[(is_v * kMT + tk) * D + d], q4_nib(tok));
      }
    }
    if (tid < 2 * TQ) {
      const int tk = tid < TQ ? tid : tid - TQ, tok = len + tk;
      const size_t at = kBits == 8 ? static_cast<size_t>(tok)
                                   : static_cast<size_t>(q4_nib(tok)) * M + q4_row(tok);
      (tid < TQ ? k_sc : v_sc)[at] = __float2bfloat16_rn(fsc[tid]);  // exact: bf16 values
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

  // 4. fold in the T fresh tokens in float32, dequantized (integer value
  // times its scale), in order t_k = 0..T-1; query row r (t_q = r / G) sees
  // t_k <= t_q. One thread per (row, fresh token) score, from shared memory.
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

// M: stored rows per slab (tokens for int8, packed rows for int4);
// run_tokens: a multiple of 64
template <int D, int NQ, int kBits>
cudaError_t launch_verify(const void* q, const int8_t* nk, const int8_t* nv, const void* nks,
                          const void* nvs, int8_t* kc, int8_t* vc, void* ksc, void* vsc,
                          const int* lens, void* out, float* partials, int* counters, int B,
                          int TQ, int KVH, int G, int M, int layer, int run_tokens, float scale,
                          cudaStream_t stream) {
  using Tile = VerifyTile<D, NQ, kBits>;
  const int tokens = Tile::kTokPerRow * M;
  if (run_tokens < 64 || run_tokens % 64 || TQ > kVerifyMaxT ||
      (tokens + run_tokens - 1) / run_tokens > Tile::kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  auto kernel = verify_split_kernel<D, NQ, kBits>;
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((tokens + run_tokens - 1) / run_tokens, KVH, B);
  kernel<<<grid, kVerifyThreads, Tile::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, static_cast<const __nv_bfloat16*>(nks),
      static_cast<const __nv_bfloat16*>(nvs), kc, vc, static_cast<__nv_bfloat16*>(ksc),
      static_cast<__nv_bfloat16*>(vsc), lens, static_cast<__nv_bfloat16*>(out), partials,
      counters, B, TQ, KVH, G, M, layer, run_tokens, scale * kLog2e);
  return cudaGetLastError();
}

// registers, local (spilled) bytes, dynamic shared bytes, resident blocks per
// SM and the most runs a slot may have of one bf16 instance
template <int D, int NQ, int kBits>
cudaError_t verify_info(int* info) {
  using Tile = VerifyTile<D, NQ, kBits>;
  auto kernel = verify_split_kernel<D, NQ, kBits>;
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

}  // namespace karanta
