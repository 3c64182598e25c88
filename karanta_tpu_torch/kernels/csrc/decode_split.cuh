// Flash-decoding over a bf16, int8 or packed int4 cache on the tensor cores,
// rows split over blocks: the one kernel body of the bf16 instances of
//
// - kernel #5, paged_decode_append (decode_append.cu, kAppend = true): slot b
//   attends over the rows [0, cache_len[b]) already in the cache; the block
//   of run 0 writes this step's K/V row at cache_len[b], and the block that
//   finishes the slot folds that row in last, in float32, from the inputs
//   (karanta_tpu/ops/decode_attention.py:496-512);
// - kernel #3, paged_decode_append_quant (decode_append_quant.cu, kAppend =
//   true, kBits = 8): the same over the int8 cache with a bf16 scale per
//   row: ksc multiplies the scores, vsc multiplies p before p is rounded
//   (decode_attention.py:821-846), and the new row folds in float32 from its
//   int8 values times its scales (:852-873);
// - kernel #6, paged_decode_append_q4 (decode_append_q4.cu, kAppend = true,
//   kBits = 4): the same over the nibble-packed int4 cache (common.cuh,
//   q4_row; scales in two planes 2h and 2h + 1, M packed rows apart): run 0
//   merges the new token's nibble into its byte and keeps the other one
//   (decode_attention.py:1463-1468), and writes the two scales; a landed
//   chunk of 16 packed rows is unpacked into two 16-key bf16 tiles (tokens
//   64w + r and 64w + 32 + r, int4x8_to_bf16), each key masked by its own
//   token index and its scales read as 0 at or past cache_len (a packed row
//   is not live or dead as a whole); runs are whole 64-token windows. No
//   block reads a value the merge changes: the byte's other nibble is the
//   same before and after, and the new token is masked;
// - kernels #8 and #9, paged_decode_attention(_stacked) (decode_attention.cu,
//   kAppend = false): slot b attends over the rows [0, cache_len[b]], this
//   step's row having been written at cache_len[b] before the call;
// - the attention phase of kernel #11, decode_megakernel (decode_stream.cu),
//   #3's body over its int8 cache: the per-item function split_item runs in
//   each half of the megakernel's persistent blocks, with a named barrier
//   per half in place of the block barrier.
//
// What bounds it on this card: every live cache byte is used once per call
// for about G flops, so device-memory bytes bound it:
// KVH * sum_b live_rows[b] * 2 * (D * sizeof(row) + scale bytes) at
// 3.35 TB/s.
//
// The rows of one (slot, kv head) are split into runs of run_rows rows (an
// argument: kSplitRows = 1,024 for the bf16 cache; the int8 cache's wrapper
// picks it by a rule measured on the card), one block of 4 warps each, so a
// 4,096-row slot spreads over 4 blocks instead of one. The wrapper cannot
// read cache_len without a host sync, so the grid is sized from M and a
// block whose run starts past its slot's rows exits at once; run 0 always
// runs (with kAppend it is the block that writes the new row, and the only
// block of a slot with no old rows). No block reads row cache_len, so the
// write cannot race. Inside a block each warp takes every fourth 16-row
// chunk of the run and streams it through its own cp.async ring
// (kDecodeStages = 3 chunks of K and V; rows past the slot's length are
// zero-filled), so no block barrier sits in the row loop and the next
// chunks load while this one computes. bf16 rows land padded by 16 bytes
// for conflict-free ldmatrix; int8 rows land as they are stored, half the
// bytes, with the chunk's 32 scales (plain loads issued with the rows and
// stored beside them one iteration later; a row past the slot reads 0), and
// the warp converts the landed chunk into its own bf16 stage
// (int8x8_to_bf16 or int4x8_to_bf16, exact; stage_rows) before ldmatrix. Q.K^T and P.V are
// mma.sync.m16n8k16 in bf16 with float32 accumulators, the flash kernel's
// mapping: the G query heads of the kv head are rows of the 16-row A tile
// (G <= 8 live; the dead rows cost nothing in a byte-bound kernel), K
// through ldmatrix is the B operand of Q.K^T, and P, rounded to bf16 as the
// TPU kernels round it (decode_attention.py:107, :244, :487, :846), is the A
// operand of P.V with V through ldmatrix.trans. Each warp keeps an online
// softmax (log2 domain, ex2, quad shuffles) and a float32 (m, l, O); the
// block merges its 4 warps in shared memory in a fixed order. A slot that
// fits in one run finishes there; otherwise the block stores its (m, l, O)
// partial in a float32 workspace the wrapper allocates, and the last block
// of the (slot, kv head) to finish, which it learns from a counter it then
// resets to 0, merges the partials in split order: every run's m and l
// loaded at once, then each thread's output elements with all of a run's
// loads in flight. The merge order is fixed, so two calls give the same
// bits, and no second launch is needed. The finishing block then folds in
// the new row (kAppend; every block copies it into shared memory with its
// first chunk, so the fold waits on no global load) and normalises.
// The running max starts at the finite kNegInf, so a slot with no old rows
// (m = -1e30, l = 0) meets the new row's score without a -inf - -inf: its
// weight is exp2(-1e30 - s) = 0.
//
// Measured on the card at B = 32, M = 4096 with ragged lengths over the
// bf16 cache (PERF.md): runs of 1,024 rows with a 3-stage ring (two blocks
// an SM, 150 registers) were fastest; runs of 256 rows were much slower
// (more partials, more merges), runs of 512 or 2,048 rows and rings of 2 or
// 4 stages a little slower. Over the int8 cache a 4-stage ring was no
// faster either. A per-phase timer trace showed the finishing block's tail
// (the runs' merge, the new row's fold, the output) as a third of a call
// at B = 4 while it loaded the partials' m and the new row one global load
// at a time; the batched loads above shortened the call by about a fifth.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace karanta {

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
// 16-row chunks a warp takes from one run, and its ring depth (measured on
// the card: PERF.md)
constexpr int kDecodeChunks = 16;
constexpr int kDecodeStages = 3;
static_assert(kDecodeStages >= 2, "the ring needs two stages");
// rows per run over the bf16 cache
constexpr int kSplitRows = kSplitWarps * 16 * kDecodeChunks;

// kBits: 16 for bf16 rows, 8 for int8 rows, 4 for packed int4 rows
template <int D, int kBits>
struct SplitTile {
  static_assert(kBits == 16 || kBits == 8 || kBits == 4, "bf16, int8 or int4 rows");
  static constexpr bool kQuant = kBits != 16;
  static constexpr int kKeyT = kBits == 4 ? 2 : 1;  // 16-key tiles of a 16-row chunk
  static constexpr int kScales = kQuant ? 32 * kKeyT : 0;  // K, then V scales of a chunk
  static constexpr int kPitch = D + 8;  // bf16 rows in shared memory (elements)
  static constexpr int kStageBytes = 2 * 16 * kKeyT * kPitch * 2;  // bf16 K and V tiles
  // ring depth: an int4 warp's 2 stages keep two blocks an SM
  static constexpr int kStages = kBits == 4 ? 2 : kDecodeStages;
  // one ring stage: bf16 K and V rows (pitch kPitch), or stored K and V rows
  // (pitch D) and the chunk's kScales scales
  static constexpr int kRingStage = kQuant ? 2 * 16 * D + 2 * kScales : kStageBytes;
  static constexpr int kWarpBytes = kStages * kRingStage + (kQuant ? kStageBytes : 0);
  static constexpr int kNewRowBytes = 2 * D * 2;  // the new K and V rows (append kernels)
  static constexpr size_t kSmem =
      16 * kPitch * 2 + static_cast<size_t>(kSplitWarps) * kWarpBytes + kNewRowBytes;
  // one item's shared memory: the above and the last-block flag, 16 bytes
  static constexpr size_t kItemSmem = kSmem + 16;
  // one (slot, kv head, run) partial: O [8][D], m [8], l [8], float32
  static constexpr int kPartial = 8 * D + 16;
  // the warps' merge (O, m, l and factors of each warp, then m, l and the
  // new row's two factors per row) reuses the rings; behind it the last
  // block of a slot puts every run's m and l, 8 rows each
  static constexpr int kMergeFloats = kSplitWarps * (8 * D + 24) + 32;
  static constexpr int kMaxSplits = (kSplitWarps * kWarpBytes / 4 - kMergeFloats) / 16;
  static_assert(kMaxSplits >= 8, "the warps' merge does not fit in the ring");
  static_assert(kRingStage % 16 == 0 && kWarpBytes % 16 == 0, "16-byte aligned regions");
};

// The 4 warps of one block, or of one half of a larger block (bar_id names
// the half's barrier; 0 for a block of its own), meet here.
__device__ __forceinline__ void split_sync(int bar_id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "n"(kSplitThreads) : "memory");
}

// One (slot b, kv head kvh, run `split`) item of the kernel below, for the
// 4 warps that call it (tid in [0, 128)). smem holds SplitTile::kSmem bytes
// and an int behind them; n_runs is the partials' stride in runs. The
// kernel calls it once a block; the decode megakernel (decode_stream.cu)
// calls it from each half of its persistent blocks.
template <int D, int G, bool kAppend, int kBits>
__device__ __forceinline__ void split_item(
    const __nv_bfloat16* __restrict__ q,  // (B, KVH*G, D)
    const void* __restrict__ new_k_,      // (B, KVH, D) rows of the cache's type; kAppend only
    const void* __restrict__ new_v_,
    const __nv_bfloat16* __restrict__ new_ks,  // (B, KVH); quantized caches only
    const __nv_bfloat16* __restrict__ new_vs,
    const void* k_cache_,  // (L, B, KVH, M, D) stored rows; written if kAppend
    const void* v_cache_,
    __nv_bfloat16* ks_cache,  // int8: (L, B, KVH, M), int4: (L, B, 2*KVH, M); written
    __nv_bfloat16* vs_cache,
    const int* __restrict__ cache_len,  // (B,) tokens
    __nv_bfloat16* __restrict__ out,    // (B, KVH*G, D)
    float* __restrict__ partials,       // (B*KVH, n_runs, kPartial)
    int* __restrict__ counters,         // (B*KVH,), 0 between calls
    int B, int KVH, int M, int layer, int run_rows, float scale_log2, int split, int kvh,
    int b, int n_runs, unsigned char* smem_raw, int tid, int bar_id) {
  static_assert(G <= 8, "the query heads fill at most half the 16-row tile");
  using Tile = SplitTile<D, kBits>;
  constexpr bool kQuant = Tile::kQuant;
  static_assert(kAppend || !kQuant, "a quantized cache is read by the append kernels only");
  using Row = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  constexpr int P = Tile::kPitch, kVecs = D / 8, kKT = D / 16;
  constexpr int kS = Tile::kStages, kKeyT = Tile::kKeyT, kSc = Tile::kScales;
  constexpr int kTok = kBits == 4 ? 2 : 1;  // tokens of a stored row
  constexpr int kRowVecs = D * sizeof(Row) / 16;  // 16-byte vectors of a stored row
  const Row* new_k = static_cast<const Row*>(new_k_);
  const Row* new_v = static_cast<const Row*>(new_v_);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][P]
  unsigned char* ring = smem_raw + 16 * P * 2;  // [warps][stages][ring stage] (+ bf16 stage)
  // append kernels: this step's K row, then its V row, as the inputs hold them
  Row* new_s = reinterpret_cast<Row*>(ring + kSplitWarps * Tile::kWarpBytes);

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the clamp keeps a bad value inside the slab. Read-only: tokens [0, len];
  // append: tokens [0, len), the new one goes to len.
  const int len = min(max(cache_len[b], 0), kTok * M - 1);
  const int n_tok = kAppend ? len : len + 1;
  // stored rows that hold a live token
  const int n_rows = kBits == 4 ? q4_live_rows(n_tok) : n_tok;
  const int r0 = split * run_rows;
  if (split > 0 && r0 >= n_rows) return;  // past this slot's rows
  const int r_end = min(r0 + run_rows, n_rows);
  const int n_splits = max((n_rows + run_rows - 1) / run_rows, 1);
  const int bh = b * KVH + kvh;
  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  const Row* k_rows = static_cast<const Row*>(k_cache_) + slab * D;
  const Row* v_rows = static_cast<const Row*>(v_cache_) + slab * D;
  // int8: the slab's scales; int4: the low plane, the high plane M later
  __nv_bfloat16* k_sc = kQuant ? ks_cache + kTok * slab : nullptr;
  __nv_bfloat16* v_sc = kQuant ? vs_cache + kTok * slab : nullptr;

  if constexpr (kAppend) {
    // run 0 writes this step's row (and its scales) at len (read by no
    // block of this call)
    if (split == 0) {
      if constexpr (kBits == 4) {
        // one thread and one store per byte: the new nibble merged, the
        // byte's other nibble (token len - 32, or one not yet written) kept
        const int r = q4_row(len), nib = q4_nib(len);
        for (int c = tid; c < 2 * D; c += kSplitThreads) {
          const bool is_v = c >= D;
          const int d = is_v ? c - D : c;
          int8_t* at = const_cast<int8_t*>(is_v ? v_rows : k_rows) +
                       static_cast<size_t>(r) * D + d;
          *at = q4_merge(*at, (is_v ? new_v : new_k)[static_cast<size_t>(bh) * D + d], nib);
        }
        if (tid < 2) {
          (tid ? v_sc : k_sc)[static_cast<size_t>(nib) * M + r] = (tid ? new_vs : new_ks)[bh];
        }
      } else {
        for (int c = tid; c < 2 * kRowVecs; c += kSplitThreads) {
          const bool is_v = c >= kRowVecs;
          const int col = (is_v ? c - kRowVecs : c) * (16 / sizeof(Row));
          const Row* src = (is_v ? new_v : new_k) + static_cast<size_t>(bh) * D;
          Row* dst = const_cast<Row*>(is_v ? v_rows : k_rows) + static_cast<size_t>(len) * D;
          *reinterpret_cast<uint4*>(dst + col) = *reinterpret_cast<const uint4*>(src + col);
        }
        if constexpr (kQuant) {
          if (tid < 2) (tid ? v_sc : k_sc)[len] = (tid ? new_vs : new_ks)[bh];
        }
      }
    }
  }

  // this warp's chunks start at w0 + 64 i
  constexpr int kStride = 16 * kSplitWarps;
  const int w0 = r0 + 16 * warp;
  const int n_mine = w0 < r_end ? (r_end - w0 + kStride - 1) / kStride : 0;
  unsigned char* my_ring = ring + warp * Tile::kWarpBytes;
  // quantized: the warp's bf16 stage, after its ring stages
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(my_ring + kS * Tile::kRingStage);
  auto load_chunk = [&](int i) {
    const int c0 = w0 + kStride * i;
    unsigned char* st = my_ring + (i % kS) * Tile::kRingStage;
#pragma unroll
    for (int c = lane; c < 16 * kRowVecs; c += 32) {
      const int r = c / kRowVecs, col = (c % kRowVecs) * (16 / sizeof(Row));
      const bool ok = c0 + r < r_end;  // rows past the slot are zeros
      const size_t off = static_cast<size_t>(ok ? c0 + r : r0) * D + col;
      if constexpr (kQuant) {
        cp_async16(st + r * D + col, k_rows + off, ok ? 16 : 0);
        cp_async16(st + (16 + r) * D + col, v_rows + off, ok ? 16 : 0);
      } else {
        __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(st);
        cp_async16(ks + r * P + col, k_rows + off, ok ? 16 : 0);
        cp_async16(ks + (16 + r) * P + col, v_rows + off, ok ? 16 : 0);
      }
    }
  };
  // quantized: lane l carries scale slots l + 32 j of each chunk (slot s:
  // K below kSc / 2, then V; key tile (s / 16) % kKeyT, key s % 16), loaded
  // one iteration ahead and stored beside the rows; a key at or past the
  // slot's tokens reads 0
  constexpr int kScLane = kQuant ? kSc / 32 : 1;
  auto load_scales = [&](int i, __nv_bfloat16 (&v)[kScLane]) {
    const int c0 = w0 + kStride * i;
#pragma unroll
    for (int j = 0; j < kScLane; ++j) {
      const int s = lane + 32 * j, p = (s >> 4) % kKeyT, r = s & 15;
      v[j] = chunk_token<kBits>(c0, p, r) < n_tok
                 ? (s < kSc / 2 ? k_sc : v_sc)[static_cast<size_t>(p) * M + c0 + r]
                 : __float2bfloat16_rn(0.f);
    }
  };
  auto store_scales = [&](int i, const __nv_bfloat16 (&v)[kScLane]) {
    __nv_bfloat16* sc =
        reinterpret_cast<__nv_bfloat16*>(my_ring + (i % kS) * Tile::kRingStage + 32 * D);
#pragma unroll
    for (int j = 0; j < kScLane; ++j) sc[lane + 32 * j] = v[j];
  };
  if constexpr (kAppend) {
    // every block copies the new row now, for whichever block finishes the
    // slot (it lands with the ring's first chunk)
    for (int c = tid; c < 2 * kRowVecs; c += kSplitThreads) {
      const bool is_v = c >= kRowVecs;
      const int col = (is_v ? c - kRowVecs : c) * (16 / sizeof(Row));
      cp_async16(new_s + is_v * D + col,
                 (is_v ? new_v : new_k) + static_cast<size_t>(bh) * D + col, 16);
    }
  }
  __nv_bfloat16 sc_first[kS - 1][kScLane];
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_mine) load_chunk(st);
    cp_async_commit();
    if constexpr (kQuant) {
      if (st < n_mine) load_scales(st, sc_first[st]);
    }
  }
  if constexpr (kQuant) {
#pragma unroll
    for (int st = 0; st < kS - 1; ++st) {
      if (st < n_mine) store_scales(st, sc_first[st]);
    }
  }

  // the G query heads as rows of the A tile, zero rows below them (loaded
  // while the ring fills)
  for (int c = tid; c < 16 * kVecs; c += kSplitThreads) {
    const int r = c / kVecs, col = (c % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < G) {
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * KVH * G + kvh * G + r) * D + col);
    }
    *reinterpret_cast<uint4*>(q_s + r * P + col) = val;
  }
  split_sync(bar_id);
  uint32_t qa[kKT][4];
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    ldmatrix_x4(qa[kk], q_s + (lane & 15) * P + (lane >> 4) * 8 + kk * 16);
  }

  // lane offsets as in flash_attention.cu: K as B of Q.K^T, V as B of P.V
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * P + (lane >> 4) * 8;
  // only row g of each fragment is a query head (rows g + 8 are padding)
  float o[D / 8][2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = 0.f;
  float m = kNegInf, l = 0.f;

  __nv_bfloat16 sc_pending[kScLane];
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kS - 2>();
    __syncwarp();  // chunk i landed for every lane; chunk i - 1's stage is free
    if constexpr (kQuant) {
      if (i >= 1 && i + kS - 2 < n_mine) store_scales(i + kS - 2, sc_pending);
    }
    const bool more = i + kS - 1 < n_mine;
    if (more) load_chunk(i + kS - 1);
    cp_async_commit();
    const unsigned char* st = my_ring + (i % kS) * Tile::kRingStage;
    const __nv_bfloat16* ks;
    float ksc[kKeyT][2][2], vsc[kKeyT][2][2];
    if constexpr (kQuant) {
      if (more) load_scales(i + kS - 1, sc_pending);
      // the landed chunk into the bf16 stage: K tiles, then V tiles
      stage_rows<kBits, D, P, 32>(reinterpret_cast<const int8_t*>(st), stage, 0, lane);
      __syncwarp();
      ks = stage;
      // the scales of this lane's keys 8j + 2t + e of key tile p
      const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(st + 32 * D);
#pragma unroll
      for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sc + 16 * p + 8 * j + 2 * t));
          const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              sc + kSc / 2 + 16 * p + 8 * j + 2 * t));
          ksc[p][j][0] = kf.x;
          ksc[p][j][1] = kf.y;
          vsc[p][j][0] = vf.x;
          vsc[p][j][1] = vf.y;
        }
      }
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(st);
    }
    const __nv_bfloat16* vs = ks + 16 * kKeyT * P;
    const int c0 = w0 + kStride * i;

    // S = Q K^T over the chunk's keys: fragment j, element e of row g is key
    // 8j + 2t + e of key tile p
    float s[kKeyT][2][4];
#pragma unroll
    for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j) s[p][j][0] = s[p][j][1] = s[p][j][2] = s[p][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
      for (int p = 0; p < kKeyT; ++p) {
        uint32_t bb[4];
        ldmatrix_x4(bb, ks + 16 * p * P + k_lane + kk * 16);
        mma_bf16_16816(s[p][0], qa[kk], bb[0], bb[1]);
        mma_bf16_16816(s[p][1], qa[kk], bb[2], bb[3]);
      }
    }
    float mx = m;
#pragma unroll
    for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live = chunk_token<kBits>(c0, p, 8 * j + 2 * t + e) < n_tok;
          float x = s[p][j][e];
          if constexpr (kQuant) x *= ksc[p][j][e];  // the K scale, then the softmax scale
          s[p][j][e] = live ? x * scale_log2 : -CUDART_INF_F;
          mx = fmaxf(mx, s[p][j][e]);
        }
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = fast_exp2(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int p = 0; p < kKeyT; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[p][j][e] = fast_exp2(s[p][j][e] - mx);
          l += s[p][j][e];  // this lane's share of the row sum, unrounded P
          if constexpr (kQuant) s[p][j][e] *= vsc[p][j][e];  // the V scale folds into p
        }
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    // O += P V, one k-step per key tile: P rounded to bf16, the padding
    // rows zero
#pragma unroll
    for (int p = 0; p < kKeyT; ++p) {
      const uint32_t pa[4] = {pack_bf16(s[p][0][0], s[p][0][1]), 0u,
                              pack_bf16(s[p][1][0], s[p][1][1]), 0u};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vs + 16 * p * P + v_lane + np * 16);
        float c0f[4] = {o[2 * np][0], o[2 * np][1], 0.f, 0.f};
        float c1f[4] = {o[2 * np + 1][0], o[2 * np + 1][1], 0.f, 0.f};
        mma_bf16_16816(c0f, pa, bb[0], bb[1]);
        mma_bf16_16816(c1f, pa, bb[2], bb[3]);
        o[2 * np][0] = c0f[0];
        o[2 * np][1] = c0f[1];
        o[2 * np + 1][0] = c1f[0];
        o[2 * np + 1][1] = c1f[1];
      }
    }
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // merge the 4 warps in shared memory (the ring is free), warp order fixed
  split_sync(bar_id);
  float* red_o = reinterpret_cast<float*>(ring);  // [warps][8][D]
  float* red_m = red_o + kSplitWarps * 8 * D;     // [warps][8]
  float* red_l = red_m + kSplitWarps * 8;         // [warps][8]
  float* fac = red_l + kSplitWarps * 8;           // [warps][8]
  float* row_m = fac + kSplitWarps * 8;           // [8]
  float* row_l = row_m + 8;                       // [8]
  float* new_a = row_l + 8;                       // [8] the new row's factors
  float* new_p = new_a + 8;                       // [8]
  float* run_w = new_p + 8;                       // [runs][8] the last block's
  float* run_l = run_w + 8 * n_splits;            // [runs][8]
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(red_o + (warp * 8 + g) * D + 8 * n + 2 * t) =
        make_float2(o[n][0], o[n][1]);
  }
  if (t == 0) {
    red_m[warp * 8 + g] = m;
    red_l[warp * 8 + g] = l;
  }
  split_sync(bar_id);
  if (tid < G) {
    float mx = red_m[tid];
    for (int w = 1; w < kSplitWarps; ++w) mx = fmaxf(mx, red_m[w * 8 + tid]);
    float sum = 0.f;
    for (int w = 0; w < kSplitWarps; ++w) {
      const float f = fast_exp2(red_m[w * 8 + tid] - mx);  // a warp without rows: 0
      fac[w * 8 + tid] = f;
      sum += red_l[w * 8 + tid] * f;
    }
    row_m[tid] = mx;
    row_l[tid] = sum;
  }
  split_sync(bar_id);
  __nv_bfloat16* out_bh = out + static_cast<size_t>(bh) * G * D;
  const float* parts = partials + static_cast<size_t>(bh) * n_runs * Tile::kPartial;
  if (n_splits > 1) {
    float* part = partials + (static_cast<size_t>(bh) * n_runs + split) * Tile::kPartial;
    for (int e = tid; e < G * D; e += kSplitThreads) {
      const int gg = e / D, d = e % D;
      float acc = 0.f;
      for (int w = 0; w < kSplitWarps; ++w) acc += red_o[(w * 8 + gg) * D + d] * fac[w * 8 + gg];
      part[gg * D + d] = acc;
    }
    if (tid < G) {
      part[8 * D + tid] = row_m[tid];
      part[8 * D + 8 + tid] = row_l[tid];
    }

    // the last block of this (slot, kv head) merges the runs' partials
    int* is_last = reinterpret_cast<int*>(smem_raw + Tile::kSmem);
    __threadfence();
    split_sync(bar_id);
    if (tid == 0) *is_last = atomicAdd(counters + bh, 1) == n_splits - 1;
    split_sync(bar_id);
    if (!*is_last) return;
    __threadfence();
    // every run's m and l at once, then each run's weight exp2(m_run - m)
    // per head, in split order
    for (int c = tid; c < n_splits * G; c += kSplitThreads) {
      const int sp = c / G, gg = c % G;
      const float* ps = parts + sp * Tile::kPartial + 8 * D;
      run_w[sp * 8 + gg] = __ldcg(ps + gg);
      run_l[sp * 8 + gg] = __ldcg(ps + 8 + gg);
    }
    split_sync(bar_id);
    if (tid < G) {
      float mx = kNegInf;
      for (int sp = 0; sp < n_splits; ++sp) mx = fmaxf(mx, run_w[sp * 8 + tid]);
      float sum = 0.f;
      for (int sp = 0; sp < n_splits; ++sp) {
        const float f = fast_exp2(run_w[sp * 8 + tid] - mx);
        run_w[sp * 8 + tid] = f;
        sum += run_l[sp * 8 + tid] * f;
      }
      row_m[tid] = mx;
      row_l[tid] = sum;
    }
    split_sync(bar_id);
  }

  if constexpr (kAppend) {
    // fold in the new row in float32 after the old rows, from the inputs:
    // s = q . k_new (log2 domain), one warp per query head
    const float nks = kQuant ? __bfloat162float(new_ks[bh]) : 1.f;
    for (int gg = warp; gg < G; gg += kSplitWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        float kd;
        if constexpr (kQuant) {
          kd = static_cast<float>(new_s[d]) * nks;  // dequantized in float32
        } else {
          kd = __bfloat162float(new_s[d]);
        }
        dot += __bfloat162float(q_s[gg * P + d]) * kd;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const float s_x = dot * scale_log2;
        const float m_new = fmaxf(row_m[gg], s_x);
        const float p_x = fast_exp2(s_x - m_new);
        const float a = fast_exp2(row_m[gg] - m_new);  // no old rows: exp2(-1e30 - s) = 0
        new_a[gg] = a;
        new_p[gg] = p_x;
        row_l[gg] = a * row_l[gg] + p_x;
      }
    }
    split_sync(bar_id);
  }
  // this thread's elements e = tid + kSplitThreads k of the G x D output;
  // with several runs, a run's loads are all issued before its products
  constexpr int kPer = (G * D + kSplitThreads - 1) / kSplitThreads;
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  if (n_splits == 1) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + kSplitThreads * k, gg = e / D, d = e % D;
      if (e < G * D) {
        for (int w = 0; w < kSplitWarps; ++w) {
          acc[k] += red_o[(w * 8 + gg) * D + d] * fac[w * 8 + gg];
        }
      }
    }
  } else {
    for (int sp = 0; sp < n_splits; ++sp) {
      const float* ps = parts + sp * Tile::kPartial;
      float v[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + kSplitThreads * k;
        v[k] = e < G * D ? __ldcg(ps + e) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + kSplitThreads * k;
        if (e < G * D) acc[k] += v[k] * run_w[sp * 8 + e / D];
      }
    }
  }
  const float nvs = kQuant ? __bfloat162float(new_vs[bh]) : 1.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + kSplitThreads * k, gg = e / D, d = e % D;
    if (e >= G * D) continue;
    float a = acc[k];
    if constexpr (kAppend) {
      float vd;
      if constexpr (kQuant) {
        vd = static_cast<float>(new_s[D + d]) * nvs;
      } else {
        vd = __bfloat162float(new_s[D + d]);
      }
      a = a * new_a[gg] + new_p[gg] * vd;
    }
    out_bh[e] = __float2bfloat16_rn(a / row_l[gg]);  // >= 1: the max row's exp2(0)
  }
  if (n_splits > 1 && tid == 0) counters[bh] = 0;  // ready for the next call
}

template <int D, int G, bool kAppend, int kBits = 16>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ new_k,
    const void* __restrict__ new_v, const __nv_bfloat16* __restrict__ new_ks,
    const __nv_bfloat16* __restrict__ new_vs, const void* k_cache, const void* v_cache,
    __nv_bfloat16* ks_cache, __nv_bfloat16* vs_cache, const int* __restrict__ cache_len,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partials, int* __restrict__ counters,
    int B, int KVH, int M, int layer, int run_rows, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  split_item<D, G, kAppend, kBits>(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, ks_cache,
                                   vs_cache, cache_len, out, partials, counters, B, KVH, M,
                                   layer, run_rows, scale_log2, blockIdx.x, blockIdx.y,
                                   blockIdx.z, gridDim.x, smem_raw, threadIdx.x, 0);
}

template <int D, int G, bool kAppend, int kBits = 16>
cudaError_t launch_split(const void* q, const void* nk, const void* nv, const void* nks,
                         const void* nvs, const void* kc, const void* vc, void* ksc, void* vsc,
                         const int* lens, void* out, float* partials, int* counters, int B,
                         int KVH, int M, int layer, int run_rows, float scale,
                         cudaStream_t stream) {
  using Tile = SplitTile<D, kBits>;
  // runs of whole 16-row chunks; of whole 64-token windows over int4 rows
  constexpr int kRunUnit = kBits == 4 ? 32 : 16;
  if (run_rows < kRunUnit || run_rows % kRunUnit ||
      (M + run_rows - 1) / run_rows > Tile::kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decode_split_kernel<D, G, kAppend, kBits>;
  cudaError_t err = allow_smem(kernel, Tile::kItemSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + run_rows - 1) / run_rows, KVH, B);
  kernel<<<grid, kSplitThreads, Tile::kItemSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, static_cast<const __nv_bfloat16*>(nks),
      static_cast<const __nv_bfloat16*>(nvs), kc, vc, static_cast<__nv_bfloat16*>(ksc),
      static_cast<__nv_bfloat16*>(vsc), lens, static_cast<__nv_bfloat16*>(out), partials,
      counters, B, KVH, M, layer, run_rows, scale * kLog2e);
  return cudaGetLastError();
}

// registers, local (spilled) bytes, dynamic shared bytes, resident blocks per
// SM and rows per run over the bf16 cache (kSplitRows) of one bf16 instance
template <int D, int G, bool kAppend, int kBits = 16>
cudaError_t split_info(int* info) {
  using Tile = SplitTile<D, kBits>;
  auto kernel = decode_split_kernel<D, G, kAppend, kBits>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_smem(kernel, Tile::kItemSmem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(Tile::kItemSmem);
  info[4] = kSplitRows;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, kSplitThreads,
                                                       Tile::kItemSmem);
}

}  // namespace karanta
