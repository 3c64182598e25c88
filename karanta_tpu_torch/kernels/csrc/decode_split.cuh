// Flash-decoding over a bf16 or int8 cache on the tensor cores, rows split
// over blocks: the one kernel body of the bf16 instances of
//
// - kernel #5, paged_decode_append (decode_append.cu, kAppend = true): slot b
//   attends over the rows [0, cache_len[b]) already in the cache; the block
//   of run 0 writes this step's K/V row at cache_len[b], and the block that
//   finishes the slot folds that row in last, in float32, from the inputs
//   (karanta_tpu/ops/decode_attention.py:496-512);
// - kernel #3, paged_decode_append_quant (decode_append_quant.cu, kAppend =
//   true, kInt8 = true): the same over the int8 cache with a bf16 scale per
//   row: ksc multiplies the scores, vsc multiplies p before p is rounded
//   (decode_attention.py:821-846), and the new row folds in float32 from its
//   int8 values times its scales (:852-873);
// - kernels #8 and #9, paged_decode_attention(_stacked) (decode_attention.cu,
//   kAppend = false): slot b attends over the rows [0, cache_len[b]], this
//   step's row having been written at cache_len[b] before the call.
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
// (int8x8_to_bf16, exact) before ldmatrix. Q.K^T and P.V are
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

template <int D, bool kInt8>
struct SplitTile {
  static constexpr int kPitch = D + 8;  // bf16 rows in shared memory (elements)
  static constexpr int kStageBytes = 2 * 16 * kPitch * 2;  // bf16 K and V of one chunk
  // one ring stage: bf16 K and V rows (pitch kPitch), or int8 K and V rows
  // (pitch D) and the 16 K and 16 V scales
  static constexpr int kRingStage = kInt8 ? 2 * 16 * D + 64 : kStageBytes;
  static constexpr int kWarpBytes = kDecodeStages * kRingStage + (kInt8 ? kStageBytes : 0);
  static constexpr int kNewRowBytes = 2 * D * 2;  // the new K and V rows (append kernels)
  static constexpr size_t kSmem =
      16 * kPitch * 2 + static_cast<size_t>(kSplitWarps) * kWarpBytes + kNewRowBytes;
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

template <int D, int G, bool kAppend, bool kInt8 = false>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, KVH*G, D)
    const void* __restrict__ new_k_,      // (B, KVH, D) rows of the cache's type; kAppend only
    const void* __restrict__ new_v_,
    const __nv_bfloat16* __restrict__ new_ks,  // (B, KVH); kInt8 only
    const __nv_bfloat16* __restrict__ new_vs,
    const void* k_cache_,  // (L, B, KVH, M, D); written if kAppend
    const void* v_cache_,
    __nv_bfloat16* ks_cache,  // (L, B, KVH, M); kInt8 only, written
    __nv_bfloat16* vs_cache,
    const int* __restrict__ cache_len,
    __nv_bfloat16* __restrict__ out,  // (B, KVH*G, D)
    float* __restrict__ partials,     // (B*KVH, gridDim.x, kPartial)
    int* __restrict__ counters,       // (B*KVH,), 0 between calls
    int B, int KVH, int M, int layer, int run_rows, float scale_log2) {
  static_assert(G <= 8, "the query heads fill at most half the 16-row tile");
  static_assert(kAppend || !kInt8, "the int8 cache is read by the append kernel only");
  using Tile = SplitTile<D, kInt8>;
  using Row = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int P = Tile::kPitch, kVecs = D / 8, kKT = D / 16;
  constexpr int kRowVecs = D * sizeof(Row) / 16;  // 16-byte vectors of a stored row
  const Row* new_k = static_cast<const Row*>(new_k_);
  const Row* new_v = static_cast<const Row*>(new_v_);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][P]
  unsigned char* ring = smem_raw + 16 * P * 2;  // [warps][stages][ring stage] (+ bf16 stage)
  // append kernels: this step's K row, then its V row, as the inputs hold them
  Row* new_s = reinterpret_cast<Row*>(ring + kSplitWarps * Tile::kWarpBytes);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the clamp keeps a bad value inside the slab. Read-only: rows [0, len];
  // append: rows [0, len), the new row goes to len.
  const int len = min(max(cache_len[b], 0), M - 1);
  const int n_rows = kAppend ? len : len + 1;
  const int r0 = split * run_rows;
  if (split > 0 && r0 >= n_rows) return;  // past this slot's rows
  const int r_end = min(r0 + run_rows, n_rows);
  const int n_splits = max((n_rows + run_rows - 1) / run_rows, 1);
  const int bh = b * KVH + kvh;
  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  const Row* k_rows = static_cast<const Row*>(k_cache_) + slab * D;
  const Row* v_rows = static_cast<const Row*>(v_cache_) + slab * D;
  __nv_bfloat16* k_sc = kInt8 ? ks_cache + slab : nullptr;
  __nv_bfloat16* v_sc = kInt8 ? vs_cache + slab : nullptr;

  if constexpr (kAppend) {
    // run 0 writes this step's row (and its scales) at len (read by no
    // block of this call)
    if (split == 0) {
      for (int c = tid; c < 2 * kRowVecs; c += kSplitThreads) {
        const bool is_v = c >= kRowVecs;
        const int col = (is_v ? c - kRowVecs : c) * (16 / sizeof(Row));
        const Row* src = (is_v ? new_v : new_k) + static_cast<size_t>(bh) * D;
        Row* dst = const_cast<Row*>(is_v ? v_rows : k_rows) + static_cast<size_t>(len) * D;
        *reinterpret_cast<uint4*>(dst + col) = *reinterpret_cast<const uint4*>(src + col);
      }
      if constexpr (kInt8) {
        if (tid < 2) (tid ? v_sc : k_sc)[len] = (tid ? new_vs : new_ks)[bh];
      }
    }
  }

  // this warp's chunks start at w0 + 64 i
  constexpr int kStride = 16 * kSplitWarps;
  const int w0 = r0 + 16 * warp;
  const int n_mine = w0 < r_end ? (r_end - w0 + kStride - 1) / kStride : 0;
  unsigned char* my_ring = ring + warp * Tile::kWarpBytes;
  // int8: the warp's bf16 stage, after its ring stages
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(my_ring + kDecodeStages * Tile::kRingStage);
  auto load_chunk = [&](int i) {
    const int c0 = w0 + kStride * i;
    unsigned char* st = my_ring + (i % kDecodeStages) * Tile::kRingStage;
#pragma unroll
    for (int c = lane; c < 16 * kRowVecs; c += 32) {
      const int r = c / kRowVecs, col = (c % kRowVecs) * (16 / sizeof(Row));
      const bool ok = c0 + r < r_end;  // rows past the slot are zeros
      const size_t off = static_cast<size_t>(ok ? c0 + r : r0) * D + col;
      if constexpr (kInt8) {
        cp_async16(st + r * D + col, k_rows + off, ok ? 16 : 0);
        cp_async16(st + (16 + r) * D + col, v_rows + off, ok ? 16 : 0);
      } else {
        __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(st);
        cp_async16(ks + r * P + col, k_rows + off, ok ? 16 : 0);
        cp_async16(ks + (16 + r) * P + col, v_rows + off, ok ? 16 : 0);
      }
    }
  };
  // int8: lane l carries scale l of each chunk (K scales 0..15, V 16..31),
  // loaded one iteration ahead and stored beside the rows
  auto load_scale = [&](int i) {
    const int r = w0 + kStride * i + (lane & 15);
    return r < r_end ? (lane < 16 ? k_sc : v_sc)[r] : __float2bfloat16_rn(0.f);
  };
  auto store_scale = [&](int i, __nv_bfloat16 v) {
    reinterpret_cast<__nv_bfloat16*>(my_ring + (i % kDecodeStages) * Tile::kRingStage +
                                     32 * D)[lane] = v;
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
  __nv_bfloat16 sc_first[kDecodeStages - 1];
#pragma unroll
  for (int st = 0; st < kDecodeStages - 1; ++st) {
    if (st < n_mine) load_chunk(st);
    cp_async_commit();
    if constexpr (kInt8) {
      sc_first[st] = st < n_mine ? load_scale(st) : __float2bfloat16_rn(0.f);
    }
  }
  if constexpr (kInt8) {
#pragma unroll
    for (int st = 0; st < kDecodeStages - 1; ++st) {
      if (st < n_mine) store_scale(st, sc_first[st]);
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
  __syncthreads();
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

  __nv_bfloat16 sc_pending = __float2bfloat16_rn(0.f);
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kDecodeStages - 2>();
    __syncwarp();  // chunk i landed for every lane; chunk i - 1's stage is free
    if constexpr (kInt8) {
      if (i >= 1 && i + kDecodeStages - 2 < n_mine) store_scale(i + kDecodeStages - 2, sc_pending);
    }
    const bool more = i + kDecodeStages - 1 < n_mine;
    if (more) load_chunk(i + kDecodeStages - 1);
    cp_async_commit();
    const unsigned char* st = my_ring + (i % kDecodeStages) * Tile::kRingStage;
    const __nv_bfloat16* ks;
    float ksc[2][2], vsc[2][2];
    if constexpr (kInt8) {
      if (more) sc_pending = load_scale(i + kDecodeStages - 1);
      // the landed int8 chunk into the bf16 stage (K rows 0..15, V 16..31)
#pragma unroll
      for (int c = lane; c < 32 * (D / 8); c += 32) {
        const int r = c / (D / 8), col = (c % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(stage + r * P + col) =
            int8x8_to_bf16(*reinterpret_cast<const uint2*>(st + r * D + col));
      }
      __syncwarp();
      ks = stage;
      // the scales of this lane's keys c0 + 8j + 2t + e
      const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(st + 32 * D);
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
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(st);
    }
    const __nv_bfloat16* vs = ks + 16 * P;
    const int c0 = w0 + kStride * i;

    // S = Q K^T over the chunk's 16 rows: fragment j, element e of row g is
    // key c0 + 8j + 2t + e
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      uint32_t bb[4];
      ldmatrix_x4(bb, ks + k_lane + kk * 16);
      mma_bf16_16816(s[0], qa[kk], bb[0], bb[1]);
      mma_bf16_16816(s[1], qa[kk], bb[2], bb[3]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = c0 + 8 * j + 2 * t + e < r_end;
        float x = s[j][e];
        if constexpr (kInt8) x *= ksc[j][e];  // the K scale, then the softmax scale
        s[j][e] = live ? x * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[j][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = fast_exp2(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = fast_exp2(s[j][e] - mx);
        l += s[j][e];  // this lane's share of the row sum, unrounded P
        if constexpr (kInt8) s[j][e] *= vsc[j][e];  // the V scale folds into p
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    // O += P V: P rounded to bf16, the padding rows zero
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), 0u, pack_bf16(s[1][0], s[1][1]), 0u};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, vs + v_lane + np * 16);
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
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // merge the 4 warps in shared memory (the ring is free), warp order fixed
  __syncthreads();
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
  __syncthreads();
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
  __syncthreads();
  __nv_bfloat16* out_bh = out + static_cast<size_t>(bh) * G * D;
  const float* parts = partials + static_cast<size_t>(bh) * gridDim.x * Tile::kPartial;
  if (n_splits > 1) {
    float* part = partials + (static_cast<size_t>(bh) * gridDim.x + split) * Tile::kPartial;
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
    __shared__ int is_last;
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(counters + bh, 1) == n_splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // every run's m and l at once, then each run's weight exp2(m_run - m)
    // per head, in split order
    for (int c = tid; c < n_splits * G; c += kSplitThreads) {
      const int sp = c / G, gg = c % G;
      const float* ps = parts + sp * Tile::kPartial + 8 * D;
      run_w[sp * 8 + gg] = __ldcg(ps + gg);
      run_l[sp * 8 + gg] = __ldcg(ps + 8 + gg);
    }
    __syncthreads();
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
    __syncthreads();
  }

  if constexpr (kAppend) {
    // fold in the new row in float32 after the old rows, from the inputs:
    // s = q . k_new (log2 domain), one warp per query head
    const float nks = kInt8 ? __bfloat162float(new_ks[bh]) : 1.f;
    for (int gg = warp; gg < G; gg += kSplitWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        float kd;
        if constexpr (kInt8) {
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
    __syncthreads();
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
  const float nvs = kInt8 ? __bfloat162float(new_vs[bh]) : 1.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + kSplitThreads * k, gg = e / D, d = e % D;
    if (e >= G * D) continue;
    float a = acc[k];
    if constexpr (kAppend) {
      float vd;
      if constexpr (kInt8) {
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

template <int D, int G, bool kAppend, bool kInt8 = false>
cudaError_t launch_split(const void* q, const void* nk, const void* nv, const void* nks,
                         const void* nvs, const void* kc, const void* vc, void* ksc, void* vsc,
                         const int* lens, void* out, float* partials, int* counters, int B,
                         int KVH, int M, int layer, int run_rows, float scale,
                         cudaStream_t stream) {
  using Tile = SplitTile<D, kInt8>;
  if (run_rows < 16 || run_rows % 16 || (M + run_rows - 1) / run_rows > Tile::kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decode_split_kernel<D, G, kAppend, kInt8>;
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + run_rows - 1) / run_rows, KVH, B);
  kernel<<<grid, kSplitThreads, Tile::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, static_cast<const __nv_bfloat16*>(nks),
      static_cast<const __nv_bfloat16*>(nvs), kc, vc, static_cast<__nv_bfloat16*>(ksc),
      static_cast<__nv_bfloat16*>(vsc), lens, static_cast<__nv_bfloat16*>(out), partials,
      counters, B, KVH, M, layer, run_rows, scale * kLog2e);
  return cudaGetLastError();
}

// registers, local (spilled) bytes, dynamic shared bytes, resident blocks per
// SM and rows per run over the bf16 cache (kSplitRows) of one bf16 instance
template <int D, int G, bool kAppend, bool kInt8 = false>
cudaError_t split_info(int* info) {
  using Tile = SplitTile<D, kInt8>;
  auto kernel = decode_split_kernel<D, G, kAppend, kInt8>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(Tile::kSmem);
  info[4] = kSplitRows;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, kSplitThreads,
                                                       Tile::kSmem);
}

}  // namespace karanta
