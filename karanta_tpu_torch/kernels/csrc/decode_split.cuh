// Flash-decoding over a bf16 cache on the tensor cores, rows split over
// blocks: the one kernel body of the bf16 instances of
//
// - kernel #5, paged_decode_append (decode_append.cu, kAppend = true): slot b
//   attends over the rows [0, cache_len[b]) already in the cache; the block
//   of run 0 writes this step's K/V row at cache_len[b], and the block that
//   finishes the slot folds that row in last, in float32, from the inputs
//   (karanta_tpu/ops/decode_attention.py:496-512);
// - kernels #8 and #9, paged_decode_attention(_stacked) (decode_attention.cu,
//   kAppend = false): slot b attends over the rows [0, cache_len[b]], this
//   step's row having been written at cache_len[b] before the call.
// (An int8 instance of this body ran kernel #3 until it was redesigned
// around bulk copies, decode_append_quant.cu, the megakernel's attention
// (#11) until it moved onto #3's walker, quant_tma.cuh, and, over packed
// int4 rows, kernel #6 until it moved onto the int4 verify kernel's body,
// verify_tma.cuh.)
//
// What bounds it on this card: every live cache byte is used once per call
// for about G flops, so device-memory bytes bound it:
// KVH * sum_b live_rows[b] * 2 * D * 2 at 3.35 TB/s.
//
// The rows of one (slot, kv head) are split into runs of run_rows rows (an
// argument: kSplitRows = 1,024), one block of 4 warps each, so a
// 4,096-row slot spreads over 4 blocks instead of one. The wrapper cannot
// read cache_len without a host sync, so the grid is sized from M and a
// block whose run starts past its slot's rows exits at once; run 0 always
// runs (with kAppend it is the block that writes the new row, and the only
// block of a slot with no old rows). No block reads row cache_len, so the
// write cannot race. Inside a block each warp takes every fourth 16-row
// chunk of the run and streams it through its own cp.async ring
// (kDecodeStages = 3 chunks of K and V; rows past the slot's length are
// zero-filled), so no block barrier sits in the row loop and the next
// chunks load while this one computes. Rows land padded by 16 bytes for
// conflict-free ldmatrix. Q.K^T and P.V are
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
// 4 stages a little slower. A per-phase timer trace showed the finishing block's tail
// (the runs' merge, the new row's fold, the output) as a third of a call
// at B = 4 while it loaded the partials' m and the new row one global load
// at a time; the batched loads above shortened the call by about a fifth.
#pragma once

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

template <int D>
struct SplitTile {
  static constexpr int kPitch = D + 8;  // bf16 rows in shared memory (elements)
  static constexpr int kStageBytes = 2 * 16 * kPitch * 2;  // bf16 K and V tiles
  static constexpr int kStages = kDecodeStages;
  // one ring stage: K and V rows (pitch kPitch)
  static constexpr int kRingStage = kStageBytes;
  static constexpr int kWarpBytes = kStages * kRingStage;
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
// and an int behind them; n_runs is the partials' stride in runs.
template <int D, int G, bool kAppend>
__device__ __forceinline__ void split_item(
    const __nv_bfloat16* __restrict__ q,  // (B, KVH*G, D)
    const void* __restrict__ new_k_,      // (B, KVH, D); kAppend only
    const void* __restrict__ new_v_,
    const void* k_cache_,  // (L, B, KVH, M, D); written if kAppend
    const void* v_cache_,
    const int* __restrict__ cache_len,  // (B,) tokens
    __nv_bfloat16* __restrict__ out,    // (B, KVH*G, D)
    float* __restrict__ partials,       // (B*KVH, n_runs, kPartial)
    int* __restrict__ counters,         // (B*KVH,), 0 between calls
    int B, int KVH, int M, int layer, int run_rows, float scale_log2, int split, int kvh,
    int b, int n_runs, unsigned char* smem_raw, int tid, int bar_id) {
  static_assert(G <= 8, "the query heads fill at most half the 16-row tile");
  using Tile = SplitTile<D>;
  using Row = __nv_bfloat16;
  constexpr int P = Tile::kPitch, kVecs = D / 8, kKT = D / 16;
  constexpr int kS = Tile::kStages;
  constexpr int kRowVecs = D * sizeof(Row) / 16;  // 16-byte vectors of a stored row
  const Row* new_k = static_cast<const Row*>(new_k_);
  const Row* new_v = static_cast<const Row*>(new_v_);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][P]
  unsigned char* ring = smem_raw + 16 * P * 2;  // [warps][stages][ring stage]
  // append kernels: this step's K row, then its V row, as the inputs hold them
  Row* new_s = reinterpret_cast<Row*>(ring + kSplitWarps * Tile::kWarpBytes);

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the clamp keeps a bad value inside the slab. Read-only: rows [0, len];
  // append: rows [0, len), the new one goes to len.
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

  if constexpr (kAppend) {
    // run 0 writes this step's row at len (read by no block of this call)
    if (split == 0) {
      for (int c = tid; c < 2 * kRowVecs; c += kSplitThreads) {
        const bool is_v = c >= kRowVecs;
        const int col = (is_v ? c - kRowVecs : c) * (16 / sizeof(Row));
        const Row* src = (is_v ? new_v : new_k) + static_cast<size_t>(bh) * D;
        Row* dst = const_cast<Row*>(is_v ? v_rows : k_rows) + static_cast<size_t>(len) * D;
        *reinterpret_cast<uint4*>(dst + col) = *reinterpret_cast<const uint4*>(src + col);
      }
    }
  }

  // this warp's chunks start at w0 + 64 i
  constexpr int kStride = 16 * kSplitWarps;
  const int w0 = r0 + 16 * warp;
  const int n_mine = w0 < r_end ? (r_end - w0 + kStride - 1) / kStride : 0;
  unsigned char* my_ring = ring + warp * Tile::kWarpBytes;
  auto load_chunk = [&](int i) {
    const int c0 = w0 + kStride * i;
    unsigned char* st = my_ring + (i % kS) * Tile::kRingStage;
#pragma unroll
    for (int c = lane; c < 16 * kRowVecs; c += 32) {
      const int r = c / kRowVecs, col = (c % kRowVecs) * (16 / sizeof(Row));
      const bool ok = c0 + r < r_end;  // rows past the slot are zeros
      const size_t off = static_cast<size_t>(ok ? c0 + r : r0) * D + col;
      __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(st);
      cp_async16(ks + r * P + col, k_rows + off, ok ? 16 : 0);
      cp_async16(ks + (16 + r) * P + col, v_rows + off, ok ? 16 : 0);
    }
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
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_mine) load_chunk(st);
    cp_async_commit();
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

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kS - 2>();
    __syncwarp();  // chunk i landed for every lane; chunk i - 1's stage is free
    if (i + kS - 1 < n_mine) load_chunk(i + kS - 1);
    cp_async_commit();
    const __nv_bfloat16* ks =
        reinterpret_cast<const __nv_bfloat16*>(my_ring + (i % kS) * Tile::kRingStage);
    const __nv_bfloat16* vs = ks + 16 * P;
    const int c0 = w0 + kStride * i;

    // S = Q K^T over the chunk's keys: fragment j, element e of row g is key
    // 8j + 2t + e
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
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
        const bool live = c0 + 8 * j + 2 * t + e < n_rows;
        s[j][e] = live ? s[j][e] * scale_log2 : -CUDART_INF_F;
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
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    // O += P V, one k-step: P rounded to bf16, the padding rows zero
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
    for (int gg = warp; gg < G; gg += kSplitWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        dot += __bfloat162float(q_s[gg * P + d]) * __bfloat162float(new_s[d]);
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
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + kSplitThreads * k, gg = e / D, d = e % D;
    if (e >= G * D) continue;
    float a = acc[k];
    if constexpr (kAppend) a = a * new_a[gg] + new_p[gg] * __bfloat162float(new_s[D + d]);
    out_bh[e] = __float2bfloat16_rn(a / row_l[gg]);  // >= 1: the max row's exp2(0)
  }
  if (n_splits > 1 && tid == 0) counters[bh] = 0;  // ready for the next call
}

template <int D, int G, bool kAppend>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ new_k,
    const void* __restrict__ new_v, const void* k_cache, const void* v_cache,
    const int* __restrict__ cache_len, __nv_bfloat16* __restrict__ out,
    float* __restrict__ partials, int* __restrict__ counters, int B, int KVH, int M, int layer,
    int run_rows, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  split_item<D, G, kAppend>(q, new_k, new_v, k_cache, v_cache, cache_len, out, partials,
                            counters, B, KVH, M, layer, run_rows, scale_log2, blockIdx.x,
                            blockIdx.y, blockIdx.z, gridDim.x, smem_raw, threadIdx.x, 0);
}

template <int D, int G, bool kAppend>
cudaError_t launch_split(const void* q, const void* nk, const void* nv, const void* kc,
                         const void* vc, const int* lens, void* out, float* partials,
                         int* counters, int B, int KVH, int M, int layer, int run_rows,
                         float scale, cudaStream_t stream) {
  using Tile = SplitTile<D>;
  // runs of whole 16-row chunks
  if (run_rows < 16 || run_rows % 16 ||
      (M + run_rows - 1) / run_rows > Tile::kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decode_split_kernel<D, G, kAppend>;
  cudaError_t err = allow_smem(kernel, Tile::kItemSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + run_rows - 1) / run_rows, KVH, B);
  kernel<<<grid, kSplitThreads, Tile::kItemSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, kc, vc, lens,
      static_cast<__nv_bfloat16*>(out), partials, counters, B, KVH, M, layer, run_rows,
      scale * kLog2e);
  return cudaGetLastError();
}

// registers, local (spilled) bytes, dynamic shared bytes, resident blocks per
// SM and rows per run over the bf16 cache (kSplitRows) of one bf16 instance
template <int D, int G, bool kAppend>
cudaError_t split_info(int* info) {
  using Tile = SplitTile<D>;
  auto kernel = decode_split_kernel<D, G, kAppend>;
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
