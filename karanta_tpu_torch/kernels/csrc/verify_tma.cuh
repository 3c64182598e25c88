// Multi-token append + verify attention over a quantized cache, for Hopper
// (sm_90a): the one kernel body of the bf16 instances of
//
// - kernel #4, paged_decode_append_multi_quant (decode_append_multi_quant.cu,
//   kBits = 8): int8 rows, one token each, a bf16 scale per row;
// - kernel #7, paged_decode_append_multi_q4 (decode_append_multi_q4.cu,
//   kBits = 4): the nibble-packed int4 cache (common.cuh, q4_row): packed
//   row 32w + r holds token 64w + r in its low nibble and token 64w + 32 + r
//   in its high nibble, with the scales of kv head h in the two planes 2h
//   (low) and 2h + 1 (high), M packed rows apart;
// - kernel #6, paged_decode_append_q4 (decode_append_q4.cu, kBits = 4, T =
//   1): the int4 decode step, #7's function with one fresh token, which the
//   one query row of each head sees (NQ = G).
//
// For each slot b it appends the T speculative tokens' K/V values and their
// scales at tokens cache_len[b] + [0, T) of layer `layer`, in place (the
// int4 cache merges each nibble into its byte and keeps the other one), then
// attends the NQ = G * T query rows (row r = t * G + g) over the old tokens
// [0, cache_len[b]) with the per-token scales folded into the scores and
// probabilities, and folds the T fresh tokens in last, one at a time, in
// float32 from their integer values times their scales, with the causal
// rule that query t_q sees fresh token t_k iff t_k <= t_q
// (karanta_tpu/ops/decode_attention.py:1202-1231, :1963-1992).
//
// The design is the int8 decode kernel's (#3, decode_append_quant.cu; the
// pieces both use are in quant_tma.cuh) with up to 32 query rows:
//
// - Work. A (slot, kv head) segment's live stored rows (int4: the packed
//   rows that hold a live token) are cut into chunks of 128 keys (128 int8
//   rows, 64 packed int4 rows) and the chunks into runs of run_tokens
//   tokens (whole chunks, so no 64-token window is split): the items, in a
//   fixed order. The grid is every block the card holds at once (two an
//   SM) and walks the items in rounds, turning direction each round; a
//   segment of several runs is finished by its last block, which a counter
//   taken with acquire-release semantics names, merging the runs' partials
//   in run order, so two calls give the same bits and a slot's bits do not
//   depend on the other slots' lengths. The block of a segment's first run
//   writes the T fresh tokens and scales; no block loads them as keys (an
//   int4 byte that takes a fresh nibble keeps its other nibble, and a fresh
//   token is masked, its stale scale selected away).
// - Loads. A producer warp issues 1-D bulk copies (cp.async.bulk) into a
//   ring of 64 KB under full and empty mbarriers: a chunk's live K rows,
//   its V rows and its scale ranges (int4: the low and the high plane of
//   each), under an L2 evict-first policy; Q (T ranges of G rows) and the T
//   fresh K/V rows come once an item into a two-slot ring of their own,
//   each range a bulk copy from its own lane, beside the fresh scales
//   (other lanes' loads). When M is not a multiple of 8 a slab's scales
//   are not 16-byte aligned and the producer's lanes load them. The
//   producer is one warp, not #3's warpgroup: an SM quarter holds 16K
//   registers, so with ten warps an SM (two blocks of five) ptxas gives
//   each thread 168, which the consumers need; a warpgroup's setmaxnreg did
//   not raise ptxas's allocation.
// - The consumers (design (b) of the redesign). The NQ rows are NT =
//   ceil(NQ / 16) query tiles of 16 rows, whose A fragments sit in shared
//   memory. One warpgroup shares each chunk: for Q.K^T warp w takes keys
//   32 w .. 32 w + 31 (int8: two 16-row tiles; int4: one packed tile, its
//   low and high nibbles two key tiles) and every query tile, so each
//   converted K byte is the B operand of NT products; the warps exchange
//   their rows' maxima (one running max for the block), write P = p * vsc
//   (rounded to bf16) to shared memory and meet again; for P.V warp w owns
//   a quarter of the output columns over all the chunk's keys (A from P by
//   ldmatrix), so each V byte is converted once. l sums each warp's
//   unrounded p and the warps' sums at an item's end; O needs no merge.
//   Against design (a), a warpgroup per query tile, each converting every
//   byte of each chunk (both built and timed: PERF.md), (b) converts half
//   the bytes.
// - No bf16 stage. The landed bytes become mma.sync operands in registers:
//   int8 bytes through the exact 2^23 + 128 + b float, packed int4 bytes
//   through the exact bf16 128 + (n + 8) of each nibble (nibble_pair). Q.K^T
//   sums over D in any order, so D is permuted alike in Q's A fragments and
//   in the K bytes (a lane's D / 4 contiguous bytes of a key); P.V sums over
//   the keys, so a lane reads its columns' bytes of four keys and the
//   output columns are permuted (a lane's kWN consecutive columns).
// - Stale bytes. Rows past a chunk's live rows are whatever the stage held
//   (NaN or inf scales included): a dead key's score and its p * vsc are
//   selected away, never multiplied away. Each key is masked by its own
//   token index.
// - Rounding where the TPU kernels round (decode_attention.py:1164-1196,
//   :1919-1950): scores are s * ksc[key], then * scale (in the log2 domain);
//   l sums the unrounded p; p * vsc[key] is rounded to bf16 before P.V
//   (relative to the block's running max).
// - An item's start and end. At the start the query tiles' warps write the
//   A fragments and take the T fresh tokens' scores, (q . k) * ks * scale,
//   on the tensor cores (while the first chunk lands). At the end the block
//   stores a float32 (O, m, l) partial, or, when it finishes the segment,
//   merges the runs' partials (the first two pieces' loads in flight with
//   the runs' m and l) and folds in the T fresh tokens in float32 (each
//   row's sequence of steps as one weight of the old rows' O and one of
//   each fresh V row).
#pragma once

#include "quant_tma.cuh"

namespace karanta {

constexpr int kVKeys = 128;     // keys (tokens) a chunk: one ring stage
constexpr int kVMaxRows = 32;   // query rows of a partial record (two tiles)
constexpr int kVMaxT = 8;       // fresh tokens a call can fold in
constexpr int kVWarps = 4;      // consumer warps (a warpgroup)

template <int D, int NQ, int kBits>
struct VerifyTma {
  static_assert(NQ <= kVMaxRows, "at most 32 query rows: two 16-row tiles");
  static_assert(kBits == 8 || kBits == 4, "int8 rows or packed int4 rows");
  static constexpr int NT = (NQ + 15) / 16;        // 16-row query tiles
  static constexpr int kThreads = kVWarps * 32 + 32;  // and a producer warp
  static constexpr int kTok = kBits == 8 ? 1 : 2;  // tokens a stored row
  static constexpr int kCRows = kVKeys / kTok;     // stored rows a chunk
  static constexpr int kStages = 2 * kTok;         // ring depth: 64 KB in flight
  static constexpr int kRowsA = 16 * NT;
  // P.V: each of kPVWarps warps owns kCols output columns, kWN n-tiles: a
  // lane's columns are a word of a V row where each warp keeps 32 columns
  // (D = 128: four warps; D = 64: two), else a byte (D = 32: four warps;
  // D = 16: two)
  static constexpr int kWN = D >= 64 ? 4 : 1;
  static constexpr int kCols = 8 * kWN;
  static constexpr int kPVWarps = D / kCols;
  // a stage: K rows [kCRows][D], V rows, then the scales of K [kTok][kCRows]
  // and of V (bf16; int4: the low plane, then the high plane)
  static constexpr int kStage = 2 * kCRows * D + 4 * kTok * kCRows;
  static constexpr int kBarBytes = ((2 * kStages + 4) * 8 + 15) / 16 * 16;
  // an item's slot (a ring of two): Q [kRowsA][D] bf16 (NQ rows written),
  // the fresh K and V values [kVMaxT][D] int8 each, their K and V scales
  // [kVMaxT] bf16 each, the fresh scores [kRowsA][kVMaxT] float
  static constexpr int kSegK = kRowsA * D * 2;
  static constexpr int kSegV = kSegK + kVMaxT * D;
  static constexpr int kSegSc = kSegV + kVMaxT * D;
  static constexpr int kSegS = kSegSc + 4 * kVMaxT;
  static constexpr int kSeg = kSegS + 4 * kRowsA * kVMaxT;
  static constexpr int kOffSeg = kBarBytes + kStages * kStage;
  // the query tiles' A fragments [NT][D / 16][32 lanes] (uint4); at an
  // item's end the fresh V rows, dequantized [T][D] float
  static constexpr int kOffQf = kOffSeg + 2 * kSeg;
  // P [kRowsA][kPP] bf16 (rows 16 bytes apart in the banks); at an item's
  // end the runs' m and l [kQMaxPieces][kRowsA] each
  static constexpr int kPP = kVKeys + 8;
  static constexpr int kOffP = kOffQf + NT * (D / 16) * 32 * 16;
  static constexpr int kPBytes = kRowsA * kPP * 2 > 8 * kQMaxPieces * kRowsA
                                     ? kRowsA * kPP * 2
                                     : 8 * kQMaxPieces * kRowsA;
  // the warps' row maxima and l [kVWarps][kRowsA] each; the rows' m and l
  // (then 1 / l) [kRowsA] each; the fold's weights of the old rows' O
  // (fold_a[r][0]) and of each fresh V row [kRowsA][kVMaxT]; the last-block
  // flag
  static constexpr int kOffRed = kOffP + (kPBytes + 15) / 16 * 16;
  static constexpr int kRedFloats = 2 * kVWarps * kRowsA + 2 * kRowsA + 2 * kRowsA * kVMaxT + 1;
  static constexpr int kOffLens = kOffRed + (kRedFloats * 4 + 15) / 16 * 16;
  // one (slot, kv head, run) partial: O [32][D], m [32], l [32], float32
  static constexpr int kPartial = kVMaxRows * D + 2 * kVMaxRows;
  // behind the rest: the item offsets of each run [kQMaxPieces + 1], then
  // each slot's live stored rows, tokens and runs [B] each
  static size_t smem(int B) {
    return kOffLens + static_cast<size_t>(kQMaxPieces + 1 + 3 * B) * 4;
  }
  static_assert(kStage % 16 == 0 && kSeg % 16 == 0 && kSegSc % 16 == 0 && kSegS % 16 == 0,
                "16-byte aligned regions");
  static_assert(kPVWarps >= 1 && kPVWarps <= kVWarps && D % kCols == 0,
                "P.V's columns over at most a warpgroup");
};

// two biased nibbles n + 8 in bits 0-3 and 16-19 (the other bits zero) ->
// bf16x2 of n, exactly: 128 + (n + 8) - 136
__device__ __forceinline__ uint32_t nibble_pair(uint32_t x) {
  uint32_t y = x | 0x43004300u;
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a lane's kWN bytes of one stored V row at column `col` (kWN = 4: a word;
// 1: a byte), XORed with kBias
template <int kWN, uint32_t kBias>
__device__ __forceinline__ uint32_t v_bytes(const int8_t* row, int col) {
  if constexpr (kWN == 4) {
    return *reinterpret_cast<const uint32_t*>(row + col) ^ kBias;
  } else {
    static_assert(kWN == 1, "4 or 1 columns a lane");
    return static_cast<uint32_t>(static_cast<uint8_t>(row[col])) ^ kBias;
  }
}

template <int D, int NQ, int kBits>
__global__ void __launch_bounds__(VerifyTma<D, NQ, kBits>::kThreads, 2)
verify_tma_kernel(const __nv_bfloat16* __restrict__ q,                   // (B, TQ, KVH*G, D)
                  const int8_t* __restrict__ new_k,                      // (B, TQ, KVH, D)
                  const int8_t* __restrict__ new_v,
                  const __nv_bfloat16* __restrict__ new_ks,              // (B, TQ, KVH)
                  const __nv_bfloat16* __restrict__ new_vs,
                  int8_t* k_cache, int8_t* v_cache,  // (L, B, KVH, M, D) stored rows
                  __nv_bfloat16* ks_cache,  // int8: (L, B, KVH, M); int4: (L, B, 2*KVH, M)
                  __nv_bfloat16* vs_cache,
                  const int* __restrict__ cache_len,  // (B,) tokens
                  __nv_bfloat16* __restrict__ out,    // (B, TQ, KVH*G, D)
                  float* __restrict__ partials,  // (B*KVH, ceil(tokens / run_tokens), kPartial)
                  int* __restrict__ counters,    // (B*KVH,), 0 between calls
                  int B, int TQ, int KVH, int G, int M, int layer, int run_tokens,
                  float scale_log2) {
  using L = VerifyTma<D, NQ, kBits>;
  constexpr int NT = L::NT, kS = L::kStages, kTok = L::kTok, kCR = L::kCRows;
  constexpr int kRowsA = L::kRowsA, kPP = L::kPP, kWN = L::kWN, kKT = D / 16;
  constexpr int kCT = kVWarps * 32;  // consumer threads
  constexpr uint32_t kBias = kBits == 8 ? 0x80808080u : 0x88888888u;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kS;
  uint64_t* seg_full = empty + kS;
  uint64_t* seg_empty = seg_full + 2;
  unsigned char* ring = smem + L::kBarBytes;
  uint4* qf = reinterpret_cast<uint4*>(smem + L::kOffQf);  // [NT][kKT][32]
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffP);  // [kRowsA][kPP]
  float* pm = reinterpret_cast<float*>(smem + L::kOffP);  // [pieces][kRowsA], then weights
  float* pl_ = pm + kQMaxPieces * kRowsA;                  // [pieces][kRowsA]
  float* red_mx = reinterpret_cast<float*>(smem + L::kOffRed);  // [kVWarps][kRowsA]
  float* red_l = red_mx + kVWarps * kRowsA;                     // [kVWarps][kRowsA]
  float* row_m = red_l + kVWarps * kRowsA;                      // [kRowsA]
  float* row_l = row_m + kRowsA;                                // [kRowsA]
  float* fold_a = row_l + kRowsA;                               // [kRowsA][kVMaxT]
  float* fold_p = fold_a + kRowsA * kVMaxT;                     // [kRowsA][kVMaxT]
  int* flag = reinterpret_cast<int*>(fold_p + kRowsA * kVMaxT);
  int* lvl = reinterpret_cast<int*>(smem + L::kOffLens);  // [n_runs + 1]
  int* lens = lvl + kQMaxPieces + 1;                       // [B] live stored rows
  int* toks = lens + B;                                    // [B] tokens
  int* nruns = toks + B;                                   // [B]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int run = run_tokens / kVKeys;                     // chunks an item (a run)
  const int n_runs = (kTok * M + run_tokens - 1) / run_tokens;  // the partials' stride
  const int H = KVH * G;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes (scales when M % 8 != 0)
      mbar_init(&empty[s], kVWarps);
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(&seg_full[p], 32);  // the producer's lanes
      mbar_init(&seg_empty[p], kCT);
    }
    fence_barrier_init();
  }
  // every slot's tokens before the T fresh ones (the clamp keeps a bad value
  // inside the slab), its live stored rows and runs, then the items before
  // each run r
  for (int b = tid; b < B; b += L::kThreads) {
    const int len = min(max(cache_len[b], 0), kTok * M - TQ);
    const int rows = kBits == 8 ? len : q4_live_rows(len);
    toks[b] = len;
    lens[b] = rows;
    nruns[b] = (max(1, (rows + kCR - 1) / kCR) + run - 1) / run;
  }
  __syncthreads();
  if (warp == 0) item_offsets(nruns, B, KVH, n_runs, lvl, lane);
  __syncthreads();

  // This block's items: walk_item(k) for k = 0, 1, ... below n_items
  const int n_items = lvl[n_runs];
  if (static_cast<int>(blockIdx.x) >= n_items) return;

  if (warp == kVWarps) {
    // the producer: an item's Q, fresh rows and fresh scales into its slot,
    // then every chunk's live K and V rows and their scales into the ring
    const bool sc_bulk = M % 8 == 0;  // every slab's scales 16-byte aligned
    const uint64_t stream = l2_evict_first();  // the cache is read once a pass
    int i = 0, seg = 0;  // chunks and items so far
    for (int k = 0; k * static_cast<int>(gridDim.x) < n_items; ++k) {
      const int it = walk_item(k);
      if (it >= n_items) continue;
      const QuantItem w = find_item<kCR>(lens, nruns, lvl, B, KVH, run, it, lane);
      const size_t bh = static_cast<size_t>(w.b) * KVH + w.kvh;
      const size_t slab = (static_cast<size_t>(layer) * B * KVH + bh) * M;
      const size_t planes = kTok * slab;  // int4: plane 2 kvh, plane 2 kvh + 1 M later
      const int p = seg & 1;
      mbar_wait(&seg_empty[p], ((seg >> 1) & 1) ^ 1);
      unsigned char* sg = smem + L::kOffSeg + p * L::kSeg;
      // lane tq < T bulk-copies Q's range tq (G rows), lane 8 + tq fresh K
      // row tq, lane 16 + tq fresh V row tq, each counting its bytes on the
      // slot's barrier (the copies issued in parallel); lane 24 + x loads
      // fresh scale x (K scales, then V scales)
      {
        const int tq = lane & 7, part = lane >> 3;
        const size_t row = static_cast<size_t>(w.b) * TQ + tq;
        if (part < 3 && tq < TQ) {
          const uint32_t bytes = part == 0 ? G * D * 2 : D;
          mbar_expect_tx(&seg_full[p], bytes);
          if (part == 0) {
            bulk_load(sg + tq * G * D * 2, q + (row * H + w.kvh * G) * D, bytes, &seg_full[p]);
          } else {
            bulk_load(sg + (part == 1 ? L::kSegK : L::kSegV) + tq * D,
                      (part == 1 ? new_k : new_v) + (row * KVH + w.kvh) * D, bytes,
                      &seg_full[p]);
          }
        } else {
          if (part == 3 && tq < TQ) {
            const size_t at = row * KVH + w.kvh;
            __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(sg + L::kSegSc);
            sc[tq] = new_ks[at];
            sc[kVMaxT + tq] = new_vs[at];
          }
          mbar_arrive(&seg_full[p]);
        }
      }
      for (int c = w.c; c < w.c + w.nc; ++c, ++i) {
        const int s = i % kS;
        mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);
        const int c0 = c * kCR, n = max(0, min(kCR, w.len - c0));
        unsigned char* st = ring + s * L::kStage;
        __nv_bfloat16* st_sc = reinterpret_cast<__nv_bfloat16*>(st + 2 * kCR * D);
        if (!sc_bulk) {
          // unaligned scales: the lanes load them (before they arrive)
          for (int j = lane; j < n; j += 32) {
#pragma unroll
            for (int pl = 0; pl < kTok; ++pl) {
              st_sc[pl * kCR + j] = ks_cache[planes + pl * M + c0 + j];
              st_sc[(kTok + pl) * kCR + j] = vs_cache[planes + pl * M + c0 + j];
            }
          }
        }
        if (lane == 0) {
          // whole 16-byte words of scales: up to 7 past the live rows, all
          // inside the plane (M % 8 == 0)
          const int n_sc = sc_bulk ? (n + 7) & ~7 : 0;
          mbar_expect_tx(&full[s], 2 * n * D + 4 * kTok * n_sc);
          if (n > 0) {
            bulk_load_hint(st, k_cache + (slab + c0) * D, n * D, &full[s], stream);
            bulk_load_hint(st + kCR * D, v_cache + (slab + c0) * D, n * D, &full[s], stream);
          }
          if (n_sc > 0) {
#pragma unroll
            for (int pl = 0; pl < kTok; ++pl) {
              bulk_load_hint(st_sc + pl * kCR, ks_cache + planes + pl * M + c0, 2 * n_sc,
                             &full[s], stream);
              bulk_load_hint(st_sc + (kTok + pl) * kCR, vs_cache + planes + pl * M + c0,
                             2 * n_sc, &full[s], stream);
            }
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
      ++seg;
    }
    return;
  }

  // the consumers. Q.K^T: warp w takes the chunk's keys 32 w .. 32 w + 31
  // (int8: stored rows 32 w .., two 16-row tiles; int4: packed rows 16 w ..,
  // its low and high plane), key tile 2 w + x, for every query tile. P.V:
  // warp w < kPVWarps takes output columns w kCols .. + kCols - 1 over all
  // the chunk's keys.
  const int g = lane >> 2, t = lane & 3;
  float o[NT][kWN][4];
  int i = 0, seg = 0;  // chunks and items so far
  for (int k = 0; k * static_cast<int>(gridDim.x) < n_items; ++k) {
    const int it = walk_item(k);
    if (it >= n_items) continue;
    // an item starts: Q, the fresh tokens' scores and the append
    const QuantItem w = find_item<kCR>(lens, nruns, lvl, B, KVH, run, it, lane);
    const int p = seg & 1, piece = w.piece, n_pieces = w.pieces, len = toks[w.b];
    const size_t bh = static_cast<size_t>(w.b) * KVH + w.kvh;
    unsigned char* sg = smem + L::kOffSeg + p * L::kSeg;
    mbar_wait(&seg_full[p], (seg >> 1) & 1);
    const __nv_bfloat16* q_s = reinterpret_cast<const __nv_bfloat16*>(sg);
    const int8_t* fk = reinterpret_cast<const int8_t*>(sg + L::kSegK);
    const int8_t* fv = reinterpret_cast<const int8_t*>(sg + L::kSegV);
    const __nv_bfloat16* fsc = reinterpret_cast<const __nv_bfloat16*>(sg + L::kSegSc);
    float* s_new = reinterpret_cast<float*>(sg + L::kSegS);  // [kRowsA][kVMaxT]
    // by warp qt < NT: query tile qt's A fragments (lane (g, t) of k-step
    // kk takes rows 16 qt + g and + 8, q[.][t D/4 + 4 kk .. + 3] as a0/a1
    // and a2/a3, the K bytes read in the same order of D; rows past NQ
    // zero), and the tile's scores of the T fresh tokens on the tensor
    // cores, log2 domain: (q . k) * ks * scale, fresh token g's values the
    // B operand (while the first chunk lands)
    if (warp < NT) {
      const int ra = 16 * warp + g, rb = ra + 8;
      const uint32_t* sa = reinterpret_cast<const uint32_t*>(q_s + ra * D + t * (D / 4));
      const uint32_t* sb = reinterpret_cast<const uint32_t*>(q_s + rb * D + t * (D / 4));
      uint32_t kw[kKT];
      load_k_words<D>(fk + g * D, t, g & 1, kw);  // tokens g >= T: not read below
      float sf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const uint2 xa = *reinterpret_cast<const uint2*>(sa + 2 * kk);
        const uint2 xb = *reinterpret_cast<const uint2*>(sb + 2 * kk);
        const uint32_t qa[4] = {ra < NQ ? xa.x : 0u, rb < NQ ? xb.x : 0u, ra < NQ ? xa.y : 0u,
                                rb < NQ ? xb.y : 0u};
        qf[(warp * kKT + kk) * 32 + lane] = make_uint4(qa[0], qa[1], qa[2], qa[3]);
        const uint32_t u = kw[kk] ^ 0x80808080u;
        mma_bf16_16816(sf, qa, upper_halves(biased_byte(u, 0), biased_byte(u, 1)),
                       upper_halves(biased_byte(u, 2), biased_byte(u, 3)));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ra + 8 * h, tk = 2 * t + e;
          if (r < NQ && tk < TQ) {
            s_new[r * kVMaxT + tk] =
                sf[2 * h + e] * __bfloat162float(fsc[tk]) * scale_log2;
          }
        }
      }
    }
    if (piece == 0) {
      // the block of the segment's first run appends the T fresh tokens and
      // their scales (no block loads them as keys)
      const size_t slab = (static_cast<size_t>(layer) * B * KVH + bh) * M;
      if constexpr (kBits == 8) {
        constexpr int kVec = D / 16;
        for (int c = tid; c < 2 * TQ * kVec; c += kCT) {
          const bool is_v = c >= TQ * kVec;
          const int cc = is_v ? c - TQ * kVec : c;
          const int tk = cc / kVec, col = (cc % kVec) * 16;
          *reinterpret_cast<uint4*>((is_v ? v_cache : k_cache) +
                                    (slab + len + tk) * D + col) =
              *reinterpret_cast<const uint4*>((is_v ? fv : fk) + tk * D + col);
        }
      } else {
        // one thread and one store per byte: with T <= 32 no two fresh
        // tokens share a byte (the tokens of a byte are 32 apart)
        for (int c = tid; c < 2 * TQ * D; c += kCT) {
          const bool is_v = c >= TQ * D;
          const int cc = is_v ? c - TQ * D : c;
          const int tk = cc / D, d = cc % D, tok = len + tk;
          int8_t* at = (is_v ? v_cache : k_cache) + (slab + q4_row(tok)) * D + d;
          *at = q4_merge(*at, (is_v ? fv : fk)[tk * D + d], q4_nib(tok));
        }
      }
      if (tid < 2 * TQ) {
        const bool is_v = tid >= TQ;
        const int tk = is_v ? tid - TQ : tid, tok = len + tk;
        const size_t at = kBits == 8 ? slab + tok
                                     : kTok * slab + static_cast<size_t>(q4_nib(tok)) * M +
                                           q4_row(tok);
        (is_v ? vs_cache : ks_cache)[at] = fsc[(is_v ? kVMaxT : 0) + tk];
      }
    }
    // the running max and l of fragment rows 16 qt + g + 8 h, the same in
    // every warp (the chunks' maxima are exchanged)
    float m[NT][2], l[NT][2];
#pragma unroll
    for (int qt = 0; qt < NT; ++qt) {
      m[qt][0] = m[qt][1] = kNegInf;
      l[qt][0] = l[qt][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < kWN; ++nt) o[qt][nt][0] = o[qt][nt][1] = o[qt][nt][2] = o[qt][nt][3] = 0.f;
    }
    named_sync(1, kCT);  // the fragments are in place

    for (int c = w.c; c < w.c + w.nc; ++c, ++i) {
      const int s = i % kS;
      const int c0 = c * kCR;
      // token of key 8 j + 2 t + e of this warp's key tile x
      const int tok0 = kBits == 8 ? c0 + 32 * warp : 64 * (c0 / 32 + (warp >> 1)) + 16 * (warp & 1);
      mbar_wait(&full[s], (i / kS) & 1);
      const int8_t* st = reinterpret_cast<const int8_t*>(ring + s * L::kStage);
      const __nv_bfloat16* st_ks = reinterpret_cast<const __nv_bfloat16*>(st + 2 * kCR * D);
      const __nv_bfloat16* st_vs = st_ks + kTok * kCR;
      // S = Q K^T over this warp's keys: element (j, 2 h + e) of lane (g, t)
      // in query tile qt, key tile x is row 16 qt + g + 8 h, key 8 j + 2 t + e
      float sc[NT][2][2][4];
#pragma unroll
      for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
#pragma unroll
          for (int j = 0; j < 2; ++j) sc[qt][x][j][0] = sc[qt][x][j][1] = sc[qt][x][j][2] = sc[qt][x][j][3] = 0.f;
        }
      }
#pragma unroll
      for (int x = 0; x < 3 - kTok; ++x) {
        // int8: the 16-row tile x of the warp's rows; int4: its one packed
        // tile, whose low and high nibbles are key tiles 0 and 1
        const int r0 = kBits == 8 ? 32 * warp + 16 * x : 16 * warp;
        uint32_t kw[2][kKT];
        load_k_words<D>(st + (r0 + g) * D, t, g & 1, kw[0]);
        load_k_words<D>(st + (r0 + g + 8) * D, t, g & 1, kw[1]);
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          uint32_t qa[NT][4];
#pragma unroll
          for (int qt = 0; qt < NT; ++qt) {
            const uint4 qv = qf[(qt * kKT + kk) * 32 + lane];
            qa[qt][0] = qv.x, qa[qt][1] = qv.y, qa[qt][2] = qv.z, qa[qt][3] = qv.w;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t u = kw[j][kk] ^ kBias;
            if constexpr (kBits == 8) {
              const uint32_t b0 = upper_halves(biased_byte(u, 0), biased_byte(u, 1));
              const uint32_t b1 = upper_halves(biased_byte(u, 2), biased_byte(u, 3));
#pragma unroll
              for (int qt = 0; qt < NT; ++qt) mma_bf16_16816(sc[qt][x][j], qa[qt], b0, b1);
            } else {
              // bytes 0, 1 and 2, 3 to the halves of a word; the low nibbles
              // are the low plane's keys, the high ones the high plane's
              const uint32_t p01 = __byte_perm(u, 0u, 0x4140);
              const uint32_t p23 = __byte_perm(u, 0u, 0x4342);
              const uint32_t lo0 = nibble_pair(p01 & 0x000F000Fu);
              const uint32_t lo1 = nibble_pair(p23 & 0x000F000Fu);
              const uint32_t hi0 = nibble_pair((p01 >> 4) & 0x000F000Fu);
              const uint32_t hi1 = nibble_pair((p23 >> 4) & 0x000F000Fu);
#pragma unroll
              for (int qt = 0; qt < NT; ++qt) {
                mma_bf16_16816(sc[qt][0][j], qa[qt], lo0, lo1);
                mma_bf16_16816(sc[qt][1][j], qa[qt], hi0, hi1);
              }
            }
          }
        }
      }
      // scores s * ksc * scale; a dead key is selected away (its bytes and
      // scales may be stale); the rows' maxima over this warp's keys
      float mx[NT][2];
#pragma unroll
      for (int qt = 0; qt < NT; ++qt) mx[qt][0] = mx[qt][1] = kNegInf;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int srow = (kBits == 8 ? 32 * warp + 16 * x : 16 * warp) + 2 * t;
        const int plane = kBits == 8 ? 0 : x;
        const int x_tok = tok0 + (kBits == 8 ? 16 * x : 32 * x) + 2 * t;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              st_ks + plane * kCR + srow + 8 * j));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = x_tok + 8 * j + e < len;
#pragma unroll
            for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float y = sc[qt][x][j][2 * h + e] * (e ? kf.y : kf.x) * scale_log2;
                sc[qt][x][j][2 * h + e] = live ? y : -CUDART_INF_F;
                mx[qt][h] = fmaxf(mx[qt][h], sc[qt][x][j][2 * h + e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[qt][h] = fmaxf(mx[qt][h], __shfl_xor_sync(0xffffffffu, mx[qt][h], 1));
          mx[qt][h] = fmaxf(mx[qt][h], __shfl_xor_sync(0xffffffffu, mx[qt][h], 2));
          if (t == 0) red_mx[warp * kRowsA + 16 * qt + g + 8 * h] = mx[qt][h];
        }
      }
      named_sync(1, kCT);  // the warps' maxima are in; the last P.V has read P
      // the chunk's max over the warps, in a fixed order: the same m in
      // every warp
      float alpha[NT][2];
#pragma unroll
      for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * qt + g + 8 * h;
          float mn = m[qt][h];
#pragma unroll
          for (int ww = 0; ww < kVWarps; ++ww) mn = fmaxf(mn, red_mx[ww * kRowsA + row]);
          alpha[qt][h] = fast_exp2(m[qt][h] - mn);
          m[qt][h] = mn;
          l[qt][h] *= alpha[qt][h];
        }
#pragma unroll
        for (int nt = 0; nt < kWN; ++nt) {
          o[qt][nt][0] *= alpha[qt][0];
          o[qt][nt][1] *= alpha[qt][0];
          o[qt][nt][2] *= alpha[qt][1];
          o[qt][nt][3] *= alpha[qt][1];
        }
      }
      // P = p * vsc rounded to bf16 into shared memory (l sums the
      // unrounded p): key tile 2 w + x, columns 16 (2 w + x) + 8 j + 2 t
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int srow = (kBits == 8 ? 32 * warp + 16 * x : 16 * warp) + 2 * t;
        const int plane = kBits == 8 ? 0 : x;
        const int x_tok = tok0 + (kBits == 8 ? 16 * x : 32 * x) + 2 * t;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              st_vs + plane * kCR + srow + 8 * j));
#pragma unroll
          for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float pv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float pe = fast_exp2(sc[qt][x][j][2 * h + e] - m[qt][h]);
                l[qt][h] += pe;
                pv[e] = x_tok + 8 * j + e < len ? pe * (e ? vf.y : vf.x) : 0.f;
              }
              *reinterpret_cast<uint32_t*>(p_s + (16 * qt + g + 8 * h) * kPP +
                                           16 * (2 * warp + x) + 8 * j + 2 * t) =
                  pack_bf16(pv[0], pv[1]);
            }
          }
        }
      }
      named_sync(1, kCT);  // P is whole
      // O += P V over the chunk's keys in this warp's columns: V's bytes n
      // of keys (2t, 2t + 1) and (2t + 8, 2t + 9) of a key tile as B of
      // output column w kCols + g kWN + n
      if (warp < L::kPVWarps) {
        const int col = warp * L::kCols + g * kWN;
#pragma unroll
        for (int pt = 0; pt < kVKeys / 16 / kTok; ++pt) {
          const int8_t* vrow = st + kCR * D + (16 * pt + 2 * t) * D;
          const uint32_t v0 = v_bytes<kWN, kBias>(vrow, col);
          const uint32_t v1 = v_bytes<kWN, kBias>(vrow + D, col);
          const uint32_t v8 = v_bytes<kWN, kBias>(vrow + 8 * D, col);
          const uint32_t v9 = v_bytes<kWN, kBias>(vrow + 9 * D, col);
#pragma unroll
          for (int pl = 0; pl < kTok; ++pl) {
            const int kt = kTok * pt + pl;  // key tile: P columns 16 kt ..
            uint32_t pa[NT][4];
#pragma unroll
            for (int qt = 0; qt < NT; ++qt) {
              ldmatrix_x4(pa[qt], p_s + (16 * qt + (lane & 15)) * kPP + 16 * kt + 8 * (lane >> 4));
            }
#pragma unroll
            for (int nt = 0; nt < kWN; ++nt) {
              uint32_t b0, b1;
              if constexpr (kBits == 8) {
                b0 = upper_halves(biased_byte(v0, nt), biased_byte(v1, nt));
                b1 = upper_halves(biased_byte(v8, nt), biased_byte(v9, nt));
              } else {
                // byte nt of two keys' words to the halves of a word, then
                // the plane's nibbles
                const uint32_t sel = nt | ((nt + 4) << 8);
                b0 = nibble_pair((__byte_perm(v0, v1, sel) >> (4 * pl)) & 0x000F000Fu);
                b1 = nibble_pair((__byte_perm(v8, v9, sel) >> (4 * pl)) & 0x000F000Fu);
              }
#pragma unroll
              for (int qt = 0; qt < NT; ++qt) mma_bf16_16816(o[qt][nt], pa[qt], b0, b1);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the item ends. Lane (g, t) of a P.V warp holds O[16 qt + g + 8 h][w
    // kCols + (2 t + e) kWN + nt] in o[qt][nt][2 h + e]; m is every warp's;
    // l sums over the warps, in a fixed order
#pragma unroll
    for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[qt][h] += __shfl_xor_sync(0xffffffffu, l[qt][h], 1);
        l[qt][h] += __shfl_xor_sync(0xffffffffu, l[qt][h], 2);
        if (t == 0) {
          red_l[warp * kRowsA + 16 * qt + g + 8 * h] = l[qt][h];
          if (warp == 0) row_m[16 * qt + g + 8 * h] = m[qt][h];
        }
      }
    }
    named_sync(1, kCT);
    if (tid < NQ) {
      float ls = red_l[tid];
#pragma unroll
      for (int ww = 1; ww < kVWarps; ++ww) ls += red_l[ww * kRowsA + tid];
      row_l[tid] = ls;
    }
    const bool pv_warp = warp < L::kPVWarps;
    const int col0 = warp * L::kCols;
    bool finish = n_pieces == 1;
    if (!finish) {
      float* rec = partials + (bh * n_runs + piece) * L::kPartial;
      if (pv_warp) {
#pragma unroll
        for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * qt + g + 8 * h;
            if (row >= NQ) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* dst = rec + row * D + col0 + (2 * t + e) * kWN;
              if constexpr (kWN == 4) {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(o[qt][0][2 * h + e], o[qt][1][2 * h + e], o[qt][2][2 * h + e],
                                o[qt][3][2 * h + e]);
              } else {
                dst[0] = o[qt][0][2 * h + e];
              }
            }
          }
        }
      }
      if (tid < NQ) {
        rec[kVMaxRows * D + tid] = row_m[tid];
        rec[kVMaxRows * D + kVMaxRows + tid] = row_l[tid];
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
        // the first two pieces' O into registers and every piece's m and l
        // into shared memory (P's area is free), in one round of loads;
        // then each piece's weight exp2(m_piece - m) per row
        const float* base = partials + bh * n_runs * L::kPartial;
        float u[2][NT][2][2][kWN];
        auto load_two = [&](int j0) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = 16 * qt + g + 8 * h;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float* src =
                      base + (j0 + jj) * L::kPartial + row * D + col0 + (2 * t + e) * kWN;
                  const bool ok = pv_warp && j0 + jj < n_pieces && row < NQ;
                  if constexpr (kWN == 4) {
                    const float4 v4 = ok ? __ldcg(reinterpret_cast<const float4*>(src))
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
                    u[jj][qt][h][e][0] = v4.x, u[jj][qt][h][e][1] = v4.y;
                    u[jj][qt][h][e][2] = v4.z, u[jj][qt][h][e][3] = v4.w;
                  } else {
                    u[jj][qt][h][e][0] = ok ? __ldcg(src) : 0.f;
                  }
                }
              }
            }
          }
        };
        load_two(0);
        for (int x = tid; x < n_pieces * kRowsA; x += kCT) {
          const int r = x % kRowsA;
          if (r < NQ) {
            pm[x] = __ldcg(base + (x / kRowsA) * L::kPartial + kVMaxRows * D + r);
            pl_[x] = __ldcg(base + (x / kRowsA) * L::kPartial + kVMaxRows * D + kVMaxRows + r);
          }
        }
        named_sync(1, kCT);
        if (tid < NQ) {
          float wm = kNegInf;
          for (int j = 0; j < n_pieces; ++j) wm = fmaxf(wm, pm[j * kRowsA + tid]);
          float ls = 0.f;
          for (int j = 0; j < n_pieces; ++j) {
            const float f = fast_exp2(pm[j * kRowsA + tid] - wm);
            ls += pl_[j * kRowsA + tid] * f;
            pm[j * kRowsA + tid] = f;
          }
          row_m[tid] = wm;
          row_l[tid] = ls;
        }
        named_sync(1, kCT);
        // the pieces' O in run order, this lane's elements, two pieces a
        // round
#pragma unroll
        for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
          for (int nt = 0; nt < kWN; ++nt) o[qt][nt][0] = o[qt][nt][1] = o[qt][nt][2] = o[qt][nt][3] = 0.f;
        }
        for (int j0 = 0; j0 < n_pieces; j0 += 2) {
          if (j0 > 0) load_two(j0);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            if (j0 + jj >= n_pieces) continue;
#pragma unroll
            for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = 16 * qt + g + 8 * h;
                const float f = row < NQ ? pm[(j0 + jj) * kRowsA + row] : 0.f;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
#pragma unroll
                  for (int nt = 0; nt < kWN; ++nt) o[qt][nt][2 * h + e] += u[jj][qt][h][e][nt] * f;
                }
              }
            }
          }
        }
        if (tid == 0) counters[bh] = 0;  // ready for the next call
      }
    }
    if (finish) {
      // fold in the T fresh tokens in float32, in order t_k = 0..T-1: query
      // row r (t_q = r / G) sees t_k <= t_q. Each row's steps a = a * fa +
      // fp * v become one weight of the old rows' O and one of each fresh
      // V row (fold_a[r][0], fold_p[r][tk]) and 1 / l; the fresh V rows,
      // dequantized, go to the fragments' area (free at an item's end)
      float* vd = reinterpret_cast<float*>(qf);  // [TQ][D]
      for (int x = tid; x < TQ * D; x += kCT) {
        vd[x] = static_cast<float>(fv[x]) * __bfloat162float(fsc[kVMaxT + x / D]);
      }
      if (tid < NQ) {
        const int tq_r = tid / G;
        float mm = row_m[tid], ll = row_l[tid];
        float fa[kVMaxT], fp[kVMaxT];
#pragma unroll
        for (int tk = 0; tk < kVMaxT; ++tk) {
          fa[tk] = 1.f, fp[tk] = 0.f;
          if (tk < TQ && tk <= tq_r) {
            const float sx = s_new[tid * kVMaxT + tk];
            const float m_new = fmaxf(mm, sx);
            fa[tk] = fast_exp2(mm - m_new);  // no old rows: exp2(-1e30 - s) = 0
            fp[tk] = fast_exp2(sx - m_new);
            ll = fa[tk] * ll + fp[tk];
            mm = m_new;
          }
        }
        float wgt = 1.f;
#pragma unroll
        for (int tk = kVMaxT - 1; tk >= 0; --tk) {
          fold_p[tid * kVMaxT + tk] = fp[tk] * wgt;
          wgt *= fa[tk];
        }
        fold_a[tid * kVMaxT] = wgt;
        row_l[tid] = 1.f / ll;  // l >= the latest max's exp2(0)
      }
      named_sync(1, kCT);
      if (pv_warp) {
#pragma unroll
        for (int qt = 0; qt < NT; ++qt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * qt + g + 8 * h;
            if (row >= NQ) continue;
            const float wa = fold_a[row * kVMaxT], inv = row_l[row];
            const size_t orow = (static_cast<size_t>(w.b) * TQ + row / G) * H + w.kvh * G + row % G;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cc = col0 + (2 * t + e) * kWN;
              float y[kWN];
#pragma unroll
              for (int nt = 0; nt < kWN; ++nt) y[nt] = o[qt][nt][2 * h + e] * wa;
              for (int tk = 0; tk < TQ; ++tk) {
                const float wp = fold_p[row * kVMaxT + tk];
                if constexpr (kWN == 4) {
                  const float4 v4 = *reinterpret_cast<const float4*>(vd + tk * D + cc);
                  y[0] += wp * v4.x, y[1] += wp * v4.y, y[2] += wp * v4.z, y[3] += wp * v4.w;
                } else {
                  y[0] += wp * vd[tk * D + cc];
                }
              }
              if constexpr (kWN == 4) {
                *reinterpret_cast<uint2*>(out + orow * D + cc) =
                    make_uint2(pack_bf16(y[0] * inv, y[1] * inv), pack_bf16(y[2] * inv, y[3] * inv));
              } else {
                out[orow * D + cc] = __float2bfloat16_rn(y[0] * inv);
              }
            }
          }
        }
      }
    }
    mbar_arrive(&seg_empty[p]);
    named_sync(1, kCT);  // P's area, the merge's and the flag are free again
    ++seg;
  }
}

namespace {

// the launcher of one bf16 instance, in this library's own storage (its
// grid cache): M stored rows a slab (tokens for int8, packed rows for
// int4), runs of run_tokens tokens (a multiple of a chunk's)
template <int D, int NQ, int kBits>
cudaError_t launch_verify_tma(const void* q, const int8_t* nk, const int8_t* nv, const void* nks,
                              const void* nvs, int8_t* kc, int8_t* vc, void* ksc, void* vsc,
                              const int* lens, void* out, float* partials, int* counters, int B,
                              int TQ, int KVH, int G, int M, int layer, int run_tokens,
                              float scale, cudaStream_t stream) {
  using L = VerifyTma<D, NQ, kBits>;
  if (TQ < 1 || TQ > kVMaxT || run_tokens < kVKeys || run_tokens % kVKeys ||
      (L::kTok * M + run_tokens - 1) / run_tokens > kQMaxPieces) {
    return cudaErrorInvalidValue;
  }
  auto kernel = verify_tma_kernel<D, NQ, kBits>;
  const size_t smem = L::smem(B);
  static ResidentGrid cache;
  int grid = 0;
  const cudaError_t err = resident_grid(kernel, L::kThreads, smem, cache, &grid);
  if (err != cudaSuccess) return err;
  // the kernel's item indices (items and the grid) stay in 32 bits
  const long long items = static_cast<long long>(B) * KVH * ((M + L::kCRows - 1) / L::kCRows);
  if (items + grid >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<grid, L::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, static_cast<const __nv_bfloat16*>(nks),
      static_cast<const __nv_bfloat16*>(nvs), kc, vc, static_cast<__nv_bfloat16*>(ksc),
      static_cast<__nv_bfloat16*>(vsc), lens, static_cast<__nv_bfloat16*>(out), partials,
      counters, B, TQ, KVH, G, M, layer, run_tokens, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// registers, local (spilled) bytes, dynamic shared bytes (at B = 0; 12
// bytes more a slot), resident blocks per SM at that size, the most runs a
// slot may have, stored rows a chunk, ring stages and consumer warps of one
// bf16 instance
template <int D, int NQ, int kBits>
cudaError_t verify_tma_info(int* info) {
  using L = VerifyTma<D, NQ, kBits>;
  auto kernel = verify_tma_kernel<D, NQ, kBits>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const size_t smem = L::smem(0);
  cudaFuncAttributes attr;
  cudaError_t err = allow_all_smem(kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[4] = kQMaxPieces;
  info[5] = L::kCRows;
  info[6] = L::kStages;
  info[7] = kVWarps;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, L::kThreads, smem);
}

}  // namespace karanta
