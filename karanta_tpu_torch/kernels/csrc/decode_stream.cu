// Decode-step weight streams for Hopper (sm_90a): every decoder layer of one
// decode step in ONE persistent cooperative launch. One kernel template, two
// C entry points:
//
// - karanta_dense_stream replaces karanta_tpu/ops/decode_stream.py:173
//   dense_stream (body _kernel :52): all layers' int8 dense products, the
//   per-layer attention outputs an input, the per-layer qkv an output;
// - karanta_decode_megakernel replaces :589 decode_megakernel (body
//   _mega_kernel :281): a whole decode step over the int8 KV cache: qkv,
//   rope, int8 K/V quantization and append at cache_len IN PLACE, attention,
//   o, the fused MLP.
//
// What bounds them on this card: the int8 weights are read once per call
// (6.5 GB for the 7B decoder), plus the live K/V rows for the megakernel, so
// they are bound by device-memory bytes; the products, 2 * B * (weights)
// flops on the tensor cores, come near that bound only at the largest
// batches.
//
// Design. The TPU kernel walks a sequential grid (layers, tiles) and carries
// the hidden state in VMEM. Here the grid is as many blocks as are
// co-resident (occupancy x SMs), launched with cudaLaunchCooperativeKernel;
// phases that need the whole previous phase's output are separated by a
// grid-wide barrier (a sense-reversing counter in global memory). Per layer:
//
//   A  rows: residual of the previous layer's down product, rms(ln1)
//   B  qkv products                   [dense: and the o products]
//      [mega: the last block of each 128-column unit adds the bias, ropes q
//      and k, writes q and quantizes this step's K/V rows to int8]
//   C  per (slot, kv head, run of cache rows): append at cache_len, the
//      attention over [0, cache_len), new row folded in last
//   D  o products
//   E  rows: o residual in float32, rms(ln2) of that sum, x rounded
//      [dense: the qkv output rows]
//   F  gate/up products; the last block of each unit writes
//      h = bf16(silu(g) * u) for its 64 columns
//   G  down products
//
// so seven barriers a layer (five for dense_stream).
//
// Products (out[r, n] = sum_k A[r, k] * W[n, k], W int8 out-major). A unit
// is 128 weight rows (gate/up: 64 gate rows and the same 64 up rows), a
// k tile 128 rows of K; the (unit, k tile) pairs of a phase are dealt out
// to the blocks in equal contiguous ranges, so no block takes more than one
// tile above the mean (a range may end in one unit and go on in the next).
// Each block streams its range's int8 weight tiles (16 KB) with the
// activations' k tile (bf16, the batch rows) through a ring of 4-8 stages
// of cp.async in shared memory (up to 128 KB of weights in flight an SM),
// both 16-byte chunks XOR-swizzled so the fragment loads meet no bank
// conflict. Warp w takes weight rows 16w..16w+15 as the 16-row A operand of
// mma.sync.m16n8k16 (bf16, float32 accumulators), the batch rows as the
// 8-column B operand (ceil(B / 8) n-tiles): a lane loads 16 weight bytes of
// one row and converts them exactly (int8x8_to_bf16); k is permuted within
// each 64-row group the same way in both operands (lane t's fragment
// columns 2t, 2t + 1, 2t + 8, 2t + 9 of k-step s are the group's rows
// 16t + 4s + 0..3), which leaves the sum unchanged. At the end of each unit
// in its range the block writes the unit's float32 partial record (B x 128)
// to a workspace slot (block + unit); the consumer sums a unit's records in
// block order, so the same inputs give the same bits on every call (for a
// given grid size). The gate/up and qkv units' finishing block is the last
// to count in on the unit's counter. Scratch written during the kernel is
// read with __ldcg or cp.async.cg (L2), never through the non-coherent L1.
//
// Attention (megakernel): decode_split.cuh's int8 body (kernel #3's bf16
// instance), each half of a block one (slot, kv head, run) item at a time
// with its own named barrier; the last item of a slot merges the runs'
// partials in run order and folds in the new row.
//
// Measured on the card (PERF.md, per-phase timer traces of
// bench/stream_trace.py): at the 7B's full depth the products were the
// whole story before this design (float32 on the CUDA cores, 8 KB in
// flight an SM, units dealt out unevenly: 104 ms at B = 80). With the
// tensor cores and the ring, the loop's own instructions set the pace at
// B = 80 (cp.async address arithmetic cost as much as the products until
// each thread's offsets were fixed outside the loop), device-memory
// efficiency at B = 4; the row phases and the units' finishing blocks issue
// their loads in batches, since a row handled one column at a time waited
// one load latency a column.
#include <algorithm>

#include "common.cuh"
#include "decode_split.cuh"
#include "mma.cuh"

namespace karanta {

constexpr int kSThreads = 256;
constexpr int kSWarps = kSThreads / 32;
constexpr int kSK = 128;              // K rows per weight tile
constexpr int kSN = 128;              // weight rows per unit: 16 a warp
constexpr int kXRow = 2 * kSK;        // bytes of a batch row's bf16 k tile
constexpr int kWTile = kSN * kSK;     // bytes of a weight tile
constexpr int kRingBytes = 196 * 1024;  // the products' ring
constexpr int kMaxStages = 8;

// the products' ring for NT n-tiles (8 batch rows each)
template <int NT>
struct ProductTile {
  static constexpr int kStage = kWTile + NT * 8 * kXRow;
  static constexpr int kStages =
      kRingBytes / kStage < kMaxStages ? kRingBytes / kStage : kMaxStages;
  static constexpr int kSmem = kStages * kStage;
  static_assert(kStages >= 2, "the ring needs two stages");
};

struct StreamArgs {
  const __nv_bfloat16* x0;       // (B, H)
  const __nv_bfloat16* attn_in;  // dense: (L, B, QD)
  const float* cos;              // mega: (B, D)
  const float* sin;
  const __nv_bfloat16* ln1;      // (L, H)
  const __nv_bfloat16* ln2;
  const int8_t* wqkv;            // (L, QKV, H) out-major
  const float* qs;               // (L, QKV)
  const __nv_bfloat16* bias;     // (L, QKV)
  const int8_t* wo;              // (L, H, QD)
  const float* os;               // (L, H)
  const int8_t* wg;              // (L, FF, H)
  const float* gs;               // (L, FF)
  const int8_t* wu;
  const float* us;
  const int8_t* wd;              // (L, H, FF)
  const float* ds;               // (L, H)
  int8_t* kc;                    // mega: (L, B, KVH, M, D), in place
  int8_t* vc;
  __nv_bfloat16* ksc;            // (L, B, KVH, M), in place
  __nv_bfloat16* vsc;
  const int* lens;               // (B,)
  __nv_bfloat16* xout;           // (B, H)
  __nv_bfloat16* qkvout;         // dense: (L, B, QKV)
  // workspace
  __nv_bfloat16* x;              // (B, H) the carried hidden state
  __nv_bfloat16* xn;             // (B, H) normed rows, the products' input
  __nv_bfloat16* h;              // (B, FF) silu(g) * u
  __nv_bfloat16* attn;           // mega: (B, QD) attention output
  __nv_bfloat16* qr;             // mega: (B, QD) rope'd q
  int8_t* nk;                    // mega: (B, KVH, D) this step's int8 K row
  int8_t* nv;
  __nv_bfloat16* nks;            // mega: (B, KVH) its scales
  __nv_bfloat16* nvs;
  float* part_qkv;               // (grid + units, B, kSN) partial records
  float* part_h;                 // the same for o, then down
  float* part_glu;               // the same for gate/up
  float* part_attn;              // mega: (B * KVH, attn_runs, kPartial)
  int* cnt;                      // qkv units', gate/up units', (slot, kv head)s' counters
  unsigned* bar;                 // [count, generation], count 0 at launch
  int B, H, QKV, FF, L, QD, KVH, M;
  int n_cnt, attn_run, attn_runs;
  float scale, eps;
};

// How a product's (unit, k tile) pairs are dealt out: the first `parts`
// blocks (all of them, unless there are fewer pairs than blocks) take equal
// contiguous ranges, block i the pairs [lo(i), lo(i + 1)) in unit-major
// order; so every block between a unit's first and last holds some of it.
struct Plan {
  int units, tiles, total, parts;
  __host__ __device__ Plan(int N, int K, int unit_cols, int grid)
      : units((N + unit_cols - 1) / unit_cols), tiles(K / kSK), total(units * tiles),
        parts(grid < total ? grid : total) {}
  __host__ __device__ int lo(int i) const {
    return static_cast<int>(static_cast<long long>(total) * (i < parts ? i : parts) / parts);
  }
  // the block whose range holds pair x
  __device__ int block_of(int x) const {
    return static_cast<int>((static_cast<long long>(x + 1) * parts - 1) / total);
  }
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Columns n0 + kSThreads k (k < kRowBatch) of batch row r, each summed over
// its unit's partial records (kSN columns a unit) in block order; columns
// at or past N read as 0. The loads of a record step are issued together
// (unconditionally, from a clamped address), so a row waits for one load
// latency a record rather than one a record and column.
constexpr int kRowBatch = 8;
__device__ __forceinline__ void plan_sums(const float* part, const Plan& p, int B, int r,
                                          int n0, int N, float (&s)[kRowBatch]) {
  const float* at[kRowBatch];
  int count[kRowBatch], most = 0;
#pragma unroll
  for (int k = 0; k < kRowBatch; ++k) {
    const int n = min(n0 + kSThreads * k, N - 1), u = n / kSN;
    const int first = p.block_of(u * p.tiles);
    count[k] = n0 + kSThreads * k < N ? p.block_of((u + 1) * p.tiles - 1) - first + 1 : 0;
    at[k] = part + (static_cast<size_t>(first + u) * B + r) * kSN + n % kSN;
    most = max(most, count[k]);
    s[k] = 0.f;
  }
  const size_t step = static_cast<size_t>(B) * kSN;  // one record to the next
  for (int j = 0; j < most; ++j) {
    float v[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) v[k] = __ldcg(at[k] + min(j, max(count[k] - 1, 0)) * step);
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) s[k] += j < count[k] ? v[k] : 0.f;
  }
}

// Grid-wide barrier; every block of the cooperative launch calls it.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Sum over the block of one float per thread, in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kSWarps; ++w) s += red[w];
  return s;
}

// ---------------------------------------------------------------------------
// product phases: out[r, n] = sum_k A[r, k] * W[n, k]
// ---------------------------------------------------------------------------

// what the last block of a unit does once every block's record is written
constexpr int kEpiNone = 0;  // nothing: a row phase sums the records
constexpr int kEpiGlu = 1;   // h = bf16(silu(g * gs) * (u * us)) of its 64 columns
constexpr int kEpiQkv = 2;   // megakernel: bias, rope, q out, int8 K/V rows out

__device__ __forceinline__ uint4 lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The megakernel's qkv unit u (128 columns, whole heads of D): each warp
// takes (batch row, head) pairs pr = warp + 8 m; lane l holds dims l + 32 j.
// Every record's loads of a warp's pairs are issued together, the records
// summed in block order.
template <int D, int NT>
__device__ __noinline__ void qkv_finish(const StreamArgs& a, int l, const float* part,
                                        const Plan& p, int u) {
  constexpr int kPer = D / 32, kHeads = kSN / D;
  constexpr int kPairs = NT * kHeads;  // B * kHeads <= 8 NT * kHeads pairs, 8 warps
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i0 = p.block_of(u * p.tiles), i1 = p.block_of((u + 1) * p.tiles - 1);
  const int nq = a.QD / D;  // q heads; then KVH k heads, then KVH v heads
  const float* qs = a.qs + static_cast<size_t>(l) * a.QKV;
  const __nv_bfloat16* bias = a.bias + static_cast<size_t>(l) * a.QKV;
  float v[kPairs][kPer];
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[m][j] = 0.f;
  }
  for (int i = i0; i <= i1; ++i) {
    const float* rec = part + static_cast<size_t>(i + u) * a.B * kSN;
    // every load of the step issued at once (rows past B read row 0; the
    // pairs they feed are skipped below)
    float w[kPairs][kPer];
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
      const int pr = warp + kSWarps * m, r = min(pr / kHeads, a.B - 1), c0 = (pr % kHeads) * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j) w[m][j] = __ldcg(rec + r * kSN + c0 + lane + 32 * j);
    }
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[m][j] += w[m][j];
    }
  }
  // bias, rope of every pair (the loads issued together from clamped
  // addresses; a v head's rope and the pairs past B or QKV are not used)
  float x[kPairs][kPer], o[kPairs][kPer];
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
    const int pr = warp + kSWarps * m, col0 = u * kSN + (pr % kHeads) * D;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = min(col0 + lane + 32 * j, a.QKV - 1);
      x[m][j] = round_bf(v[m][j] * qs[c] + bf(bias[c]));
    }
  }
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
    const int r = min((warp + kSWarps * m) / kHeads, a.B - 1);
    const float* cs = a.cos + static_cast<size_t>(r) * D;
    const float* sn = a.sin + static_cast<size_t>(r) * D;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // rope in float32 (rotate-half), rounded to bf16
      const int d = lane + 32 * j;
      const float rot = j < kPer / 2 ? -x[m][j + kPer / 2] : x[m][j - kPer / 2];
      o[m][j] = round_bf(x[m][j] * cs[d] + rot * sn[d]);
    }
  }
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
    const int pr = warp + kSWarps * m, r = pr / kHeads, col0 = u * kSN + (pr % kHeads) * D;
    if (r >= a.B || col0 >= a.QKV) continue;
    const int hd = col0 / D;
    if (hd < nq) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        a.qr[static_cast<size_t>(r) * a.QD + col0 + lane + 32 * j] =
            __float2bfloat16_rn(o[m][j]);
      }
      continue;
    }
    // this step's K (rope'd) or V row to int8 with a float32 scale, stored
    // in bf16
    const bool is_k = hd < nq + a.KVH;
    const int kvh = hd - nq - (is_k ? 0 : a.KVH);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) amax = fmaxf(amax, fabsf(is_k ? o[m][j] : x[m][j]));
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, sh));
    }
    const float sc = fmaxf(amax * (1.f / 127.f), 1e-8f);
    int8_t* dst = (is_k ? a.nk : a.nv) + (static_cast<size_t>(r) * a.KVH + kvh) * D;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float y = is_k ? o[m][j] : x[m][j];
      dst[lane + 32 * j] = static_cast<int8_t>(fminf(fmaxf(rintf(y / sc), -127.f), 127.f));
    }
    if (lane == 0) (is_k ? a.nks : a.nvs)[r * a.KVH + kvh] = __float2bfloat16_rn(sc);
  }
}

// gate/up unit u: h of its 64 columns from the records (gate in record
// columns 0..63, up in 64..127); thread t takes elements t + 256 k, all of
// a record's loads issued together, the records summed in block order
template <int NT>
__device__ __noinline__ void glu_finish(const StreamArgs& a, int l, const float* part,
                                        const Plan& p, int u) {
  constexpr int kHalf = kSN / 2, kPer = 8 * NT * kHalf / kSThreads;
  const int i0 = p.block_of(u * p.tiles), i1 = p.block_of((u + 1) * p.tiles - 1);
  float gsum[kPer], usum[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) gsum[k] = usum[k] = 0.f;
  for (int i = i0; i <= i1; ++i) {
    const float* rec = part + static_cast<size_t>(i + u) * a.B * kSN;
    // every load of the step issued at once (rows past B read row 0)
    float g[kPer], uu[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + kSThreads * k, r = min(e / kHalf, a.B - 1), c = e % kHalf;
      g[k] = __ldcg(rec + r * kSN + c);
      uu[k] = __ldcg(rec + r * kSN + kHalf + c);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      gsum[k] += g[k];
      usum[k] += uu[k];
    }
  }
  const float* gs = a.gs + static_cast<size_t>(l) * a.FF;
  const float* us = a.us + static_cast<size_t>(l) * a.FF;
  float gv[kPer], uv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = min(u * kHalf + (threadIdx.x + kSThreads * k) % kHalf, a.FF - 1);
    gv[k] = gs[n];
    uv[k] = us[n];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + kSThreads * k, r = e / kHalf, n = u * kHalf + e % kHalf;
    if (r >= a.B || n >= a.FF) continue;
    const float g = gsum[k] * gv[k], uu = usum[k] * uv[k];
    a.h[static_cast<size_t>(r) * a.FF + n] = __float2bfloat16_rn(g / (1.f + expf(-g)) * uu);
  }
}

// One product phase over the block's range of (unit, k tile) pairs. kEpi:
// kEpiGlu takes W (gate) and W2 (up) with N = FF h columns, 64 a unit; the
// others W alone, 128 columns a unit.
template <int NT, int kEpi, int D>
__device__ __noinline__ void products(unsigned char* smem, const StreamArgs& a, int l,
                                      const __nv_bfloat16* A, int lda, const int8_t* W,
                                      const int8_t* W2, int N, int K, float* part, int* cnt) {
  using Ring = ProductTile<NT>;
  constexpr int S = Ring::kStages;
  constexpr bool kGlu = kEpi == kEpiGlu;
  constexpr int kUnitCols = kGlu ? kSN / 2 : kSN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int B = a.B;
  const Plan p(N, K, kUnitCols, gridDim.x);
  const int lo = p.lo(blockIdx.x), hi = p.lo(blockIdx.x + 1);
  __shared__ int is_last;

  // The loads of a pair (unit lu, k tile lkt, kept as the next pair to
  // load) into a ring stage: the weight tile's 128 rows of 8 16-byte chunks
  // (chunk ch of row r at ch ^ 4 (r & 1)) and the NT * 8 batch rows' k tile
  // of 16 chunks (ch ^ (r & 1)); rows past N or B read as zeros. A thread
  // copies the same chunk column of kWRows weight rows 32 apart and of
  // kXRows batch rows 16 apart, so its offsets are fixed before the loop.
  constexpr int kWRows = kSN * 8 / kSThreads;                          // 4
  constexpr int kXRows = (NT * 8 * 16 + kSThreads - 1) / kSThreads;  // NT / 2, or 1
  const int wr0 = tid >> 3, wch = tid & 7, xr0 = tid >> 4, xch = tid & 15;
  const int w_dst = wr0 * kSK + ((wch ^ ((wr0 & 1) << 2)) << 4);
  const int x_dst = kWTile + xr0 * kXRow + ((xch ^ (xr0 & 1)) << 4);
  int lu = lo / p.tiles, lkt = lo % p.tiles;
  auto load = [&](int stage) {
    unsigned char* st = smem + stage * Ring::kStage;
    const int lim = N - lu * kUnitCols;  // weight rows of this unit below N
#pragma unroll
    for (int k = 0; k < kWRows; ++k) {
      const int r = wr0 + 32 * k;  // GLU: rows 0..63 gate (k < 2), 64..127 up
      const int nr = kGlu ? r & (kSN / 2 - 1) : r;
      const bool ok = nr < lim;
      const int8_t* src = (kGlu && k >= kWRows / 2 ? W2 : W) +
                          static_cast<size_t>(lu * kUnitCols + (ok ? nr : 0)) * K + lkt * kSK +
                          wch * 16;
      cp_async16(st + w_dst + k * 32 * kSK, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int k = 0; k < kXRows; ++k) {
      const int r = xr0 + 16 * k;
      if (r < NT * 8) {
        const bool ok = r < B;
        cp_async16(st + x_dst + k * 16 * kXRow,
                   A + static_cast<size_t>(ok ? r : 0) * lda + lkt * kSK + xch * 8, ok ? 16 : 0);
      }
    }
    if (++lkt == p.tiles) {
      lkt = 0;
      ++lu;
    }
  };

  // independent accumulator chains: NT n-tiles, times kChains k-step
  // chains (summed in order at the unit's end) when the n-tiles are few
  constexpr int kChains = NT == 1 ? 4 : 1;
  float acc[kChains][NT][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[c][nt][0] = acc[c][nt][1] = acc[c][nt][2] = acc[c][nt][3] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (lo + j < hi) load(j);
    cp_async_commit();
  }
  const int rw = 16 * warp + g;  // this warp's weight rows rw and rw + 8
  const int wsw = (g & 1) << 2, xsw = g & 1;  // their swizzles (rows of g's parity)
  int cu = lo / p.tiles, ckt = lo % p.tiles;  // the unit and k tile of pair x
  for (int x = lo; x < hi; ++x) {
    cp_async_wait<S - 2>();
    __syncthreads();  // pair x landed for every thread; pair x - 1's stage is free
    if (x + S - 1 < hi) load((x + S - 1 - lo) % S);
    cp_async_commit();
    const unsigned char* st = smem + ((x - lo) % S) * Ring::kStage;
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      // 16 weight bytes of rows rw and rw + 8: this 64-row group's k rows
      // 16t .. 16t + 15, as four k-steps of four
      const uint4 wa = lds16(st + rw * kSK + (((grp * 4 + t) ^ wsw) << 4));
      const uint4 wb = lds16(st + (rw + 8) * kSK + (((grp * 4 + t) ^ wsw) << 4));
      const uint4 a0 = int8x8_to_bf16(make_uint2(wa.x, wa.y));
      const uint4 a1 = int8x8_to_bf16(make_uint2(wa.z, wa.w));
      const uint4 b0 = int8x8_to_bf16(make_uint2(wb.x, wb.y));
      const uint4 b1 = int8x8_to_bf16(make_uint2(wb.z, wb.w));
      const uint32_t al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t ah[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* xr = st + kWTile + (nt * 8 + g) * kXRow;
        const uint4 x0 = lds16(xr + (((grp * 8 + 2 * t) ^ xsw) << 4));
        const uint4 x1 = lds16(xr + (((grp * 8 + 2 * t + 1) ^ xsw) << 4));
        const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t af[4] = {al[2 * s], ah[2 * s], al[2 * s + 1], ah[2 * s + 1]};
          mma_bf16_16816(acc[s % kChains][nt], af, xw[2 * s], xw[2 * s + 1]);
        }
      }
    }
    // the end of unit u in this block's range: its record, slot block + u
    const int u = cu;
    const bool unit_end = x + 1 == hi || ckt + 1 == p.tiles;
    if (++ckt == p.tiles) {
      ckt = 0;
      ++cu;
    }
    if (!unit_end) continue;
    float* rec = part + static_cast<size_t>(blockIdx.x + u) * B * kSN;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 1; c < kChains; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nt][e] += acc[c][nt][e];
      }
      const int r = nt * 8 + 2 * t;
      if (r < B) {
        rec[r * kSN + rw] = acc[0][nt][0];
        rec[r * kSN + rw + 8] = acc[0][nt][2];
      }
      if (r + 1 < B) {
        rec[(r + 1) * kSN + rw] = acc[0][nt][1];
        rec[(r + 1) * kSN + rw + 8] = acc[0][nt][3];
      }
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        acc[c][nt][0] = acc[c][nt][1] = acc[c][nt][2] = acc[c][nt][3] = 0.f;
      }
    }
    if constexpr (kEpi != kEpiNone) {
      // the unit's last block to finish finishes it, then resets its counter
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const int n_blocks = p.block_of((u + 1) * p.tiles - 1) - p.block_of(u * p.tiles) + 1;
        is_last = atomicAdd(cnt + u, 1) == n_blocks - 1;
      }
      __syncthreads();
      if (is_last) {
        __threadfence();
        if constexpr (kEpi == kEpiGlu) {
          glu_finish<NT>(a, l, part, p, u);
        } else {
          qkv_finish<D, NT>(a, l, part, p, u);
        }
        if (tid == 0) cnt[u] = 0;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the next phase reuses the ring
}

// ---------------------------------------------------------------------------
// row phases (one block per batch row)
// ---------------------------------------------------------------------------

// xn = bf16(xr * inv * w) of one row, the w loads of a batch issued first
__device__ __forceinline__ void norm_out(__nv_bfloat16* xn, const float* xr,
                                         const __nv_bfloat16* w, float inv, int H) {
  for (int i0 = threadIdx.x; i0 < H; i0 += kSThreads * kRowBatch) {
    float wv[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) wv[k] = bf(w[min(i0 + kSThreads * k, H - 1)]);
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int i = i0 + kSThreads * k;
      if (i >= H) break;
      xn[i] = __float2bfloat16_rn(xr[i] * inv * wv[k]);
    }
  }
}

// The row phases issue every global load of a batch of kRowBatch columns
// a thread before they use any (clamped addresses; columns past the row's
// end are skipped after), so a row waits for a few load latencies, not one
// a column.

// x = bf16(x + down * ds) of layer l - 1 (x0 for l == 0); then xn =
// bf16(rms(x) * ln1[l]), or, after the last layer, xout = x.
__device__ __noinline__ void row_in(const StreamArgs& a, int l, float* smem) {
  const int H = a.H;
  float* xr = smem;
  float* red = smem + H;
  const Plan down(H, a.FF, kSN, gridDim.x);
  for (int r = blockIdx.x; r < a.B; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * H;
    float ss = 0.f;
    for (int i0 = threadIdx.x; i0 < H; i0 += kSThreads * kRowBatch) {
      float s[kRowBatch], xv[kRowBatch], dv[kRowBatch];
      if (l > 0) plan_sums(a.part_h, down, a.B, r, i0, H, s);
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int i = min(i0 + kSThreads * k, H - 1);
        xv[k] = l == 0 ? bf(a.x0[row + i]) : bf(__ldcg(a.x + row + i));
        dv[k] = l == 0 ? 0.f : a.ds[(l - 1) * H + i];
      }
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int i = i0 + kSThreads * k;
        if (i >= H) break;
        const float v = l == 0 ? xv[k] : round_bf(xv[k] + s[k] * dv[k]);
        if (l == a.L) {
          a.xout[row + i] = __float2bfloat16_rn(v);
        } else {
          a.x[row + i] = __float2bfloat16_rn(v);
          xr[i] = v;
          ss += v * v;
        }
      }
    }
    if (l == a.L) continue;
    const float inv = 1.f / sqrtf(block_sum(ss, red) / H + a.eps);
    norm_out(a.xn + row, xr, a.ln1 + l * H, inv, H);
    __syncthreads();
  }
}

// x32 = x + o * os (float32), x = bf16(x32), xn = bf16(rms(x32) * ln2);
// dense_stream also writes the layer's qkv rows from their partial sums.
__device__ __noinline__ void row_mid(const StreamArgs& a, int l, float* smem) {
  const int H = a.H;
  float* xr = smem;
  float* red = smem + H;
  const Plan o(H, a.QD, kSN, gridDim.x), qkv(a.QKV, H, kSN, gridDim.x);
  for (int r = blockIdx.x; r < a.B; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * H;
    float ss = 0.f;
    for (int i0 = threadIdx.x; i0 < H; i0 += kSThreads * kRowBatch) {
      float s[kRowBatch], xv[kRowBatch], ov[kRowBatch];
      plan_sums(a.part_h, o, a.B, r, i0, H, s);
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int i = min(i0 + kSThreads * k, H - 1);
        xv[k] = bf(__ldcg(a.x + row + i));
        ov[k] = a.os[l * H + i];
      }
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int i = i0 + kSThreads * k;
        if (i >= H) break;
        const float v = xv[k] + s[k] * ov[k];
        a.x[row + i] = __float2bfloat16_rn(v);
        xr[i] = v;
        ss += v * v;
      }
    }
    const float inv = 1.f / sqrtf(block_sum(ss, red) / H + a.eps);
    norm_out(a.xn + row, xr, a.ln2 + l * H, inv, H);
    if (a.qkvout != nullptr) {
      const float* qs = a.qs + static_cast<size_t>(l) * a.QKV;
      const __nv_bfloat16* bias = a.bias + static_cast<size_t>(l) * a.QKV;
      __nv_bfloat16* out = a.qkvout + (static_cast<size_t>(l) * a.B + r) * a.QKV;
      for (int c0 = threadIdx.x; c0 < a.QKV; c0 += kSThreads * kRowBatch) {
        float s[kRowBatch], qv[kRowBatch], bv[kRowBatch];
        plan_sums(a.part_qkv, qkv, a.B, r, c0, a.QKV, s);
#pragma unroll
        for (int k = 0; k < kRowBatch; ++k) {
          const int c = min(c0 + kSThreads * k, a.QKV - 1);
          qv[k] = qs[c];
          bv[k] = bf(bias[c]);
        }
#pragma unroll
        for (int k = 0; k < kRowBatch; ++k) {
          const int c = c0 + kSThreads * k;
          if (c >= a.QKV) break;
          out[c] = __float2bfloat16_rn(s[k] * qv[k] + bv[k]);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// attention phase (megakernel): decode_split.cuh's int8 body, one (slot,
// kv head, run) item at a time in each half of the block
// ---------------------------------------------------------------------------

template <int D, int G>
__device__ __noinline__ void attend(const StreamArgs& a, int l, unsigned char* smem) {
  using Tile = SplitTile<D, 8>;
  const int half = threadIdx.x / kSplitThreads, tid = threadIdx.x % kSplitThreads;
  unsigned char* mine = smem + half * Tile::kItemSmem;
  const int pairs = a.B * a.KVH, items = pairs * a.attn_runs;
  int* counters = a.cnt + a.n_cnt - pairs;
  // run-major, so the halves that take every 2 * grid-th item see all runs
  for (int item = 2 * blockIdx.x + half; item < items; item += 2 * gridDim.x) {
    const int run = item / pairs, pair = item % pairs;
    split_item<D, G, true, 8>(a.qr, a.nk, a.nv, a.nks, a.nvs, a.kc, a.vc, a.ksc, a.vsc, a.lens,
                              a.attn, a.part_attn, counters, a.B, a.KVH, a.M, l, a.attn_run,
                              a.scale * kLog2e, run, pair % a.KVH, pair / a.KVH, a.attn_runs,
                              mine, tid, 1 + half);
  }
}

// ---------------------------------------------------------------------------
// the kernel: D == 0 is dense_stream, otherwise the megakernel
// ---------------------------------------------------------------------------

template <int NT, int D, int G>
__global__ void __launch_bounds__(kSThreads, 1) stream_kernel(StreamArgs a) {
  extern __shared__ float4 stream_smem[];
  float* smem = reinterpret_cast<float*>(stream_smem);
  unsigned char* ring = reinterpret_cast<unsigned char*>(stream_smem);
  const int H = a.H, QKV = a.QKV, FF = a.FF, QD = a.QD, B = a.B;
  constexpr int kQkvEpi = D == 0 ? kEpiNone : kEpiQkv;
  // the counters start at 0 (the first barrier orders this before any use);
  // each unit's last block resets its own
  for (int i = blockIdx.x * kSThreads + threadIdx.x; i < a.n_cnt; i += gridDim.x * kSThreads) {
    a.cnt[i] = 0;
  }
  const Plan qkv(QKV, H, kSN, gridDim.x);
  for (int l = 0; l < a.L; ++l) {
    row_in(a, l, smem);
    grid_sync(a.bar);
    products<NT, kQkvEpi, D>(ring, a, l, a.xn, H, a.wqkv + static_cast<size_t>(l) * QKV * H,
                             nullptr, QKV, H, a.part_qkv, a.cnt);
    const int8_t* wo = a.wo + static_cast<size_t>(l) * H * QD;
    if constexpr (D == 0) {
      products<NT, kEpiNone, D>(ring, a, l, a.attn_in + static_cast<size_t>(l) * B * QD, QD,
                                wo, nullptr, H, QD, a.part_h, nullptr);
      grid_sync(a.bar);
    } else {
      grid_sync(a.bar);
      attend<D, G>(a, l, ring);
      grid_sync(a.bar);
      products<NT, kEpiNone, D>(ring, a, l, a.attn, QD, wo, nullptr, H, QD, a.part_h, nullptr);
      grid_sync(a.bar);
    }
    row_mid(a, l, smem);
    grid_sync(a.bar);
    const size_t wff = static_cast<size_t>(l) * FF * H;
    products<NT, kEpiGlu, D>(ring, a, l, a.xn, H, a.wg + wff, a.wu + wff, FF, H, a.part_glu,
                             a.cnt + qkv.units);
    grid_sync(a.bar);
    products<NT, kEpiNone, D>(ring, a, l, a.h, FF, a.wd + wff, nullptr, H, FF, a.part_h,
                              nullptr);
    grid_sync(a.bar);
  }
  row_in(a, a.L, smem);
}

// ---------------------------------------------------------------------------
// host side: shared memory, grid, workspace layout, launch
// ---------------------------------------------------------------------------

template <int NT, int D, int G>
size_t smem_bytes(int H) {
  const size_t prod = ProductTile<NT>::kSmem;
  const size_t rows = (H + kSWarps) * sizeof(float);
  const size_t att = D == 0 ? 0 : 2 * SplitTile<D == 0 ? 16 : D, 8>::kItemSmem;
  return std::max(prod, std::max(rows, att));
}

// co-resident blocks of the instance: occupancy x SMs (0 on failure)
template <int NT, int D, int G>
cudaError_t grid_of(int H, int device, int* grid) {
  const size_t smem = smem_bytes<NT, D, G>(H);
  auto kernel = stream_kernel<NT, D, G>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *grid = per_sm * sms;
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// cache rows per attention item: kernel #3's rule for its bf16 instance
// (decode_attention.quant_run_rows, measured on the card): the shortest of
// 256 to 1,024 rows that leaves at most two live items an SM (one a half
// block) at half-full slots, longer if a slot would have more runs than the
// last item can merge
inline int attn_run_rows(int B, int KVH, int M, int grid, int max_runs) {
  int run = 256;
  while (run < 1024 && B * KVH * ((M + 2 * run - 1) / (2 * run)) > 2 * grid) {
    run *= 2;
  }
  while ((M + run - 1) / run > max_runs) run *= 2;
  return run;
}

struct Layout {
  size_t x, xn, h, attn, qr, nk, nv, nks, nvs, pq, ph, pg, pa, cnt, total;
  int n_cnt, attn_run, attn_runs;
};

template <int D>
Layout layout(int B, int H, int QKV, int FF, int QD, int KVH, int M, int grid) {
  constexpr bool kMega = D != 0;
  using Tile = SplitTile<kMega ? D : 16, 8>;
  Layout o;
  size_t off = 0;
  auto take = [&](size_t n) {
    const size_t at = off;
    off += (n + 255) & ~static_cast<size_t>(255);
    return at;
  };
  const size_t rec = static_cast<size_t>(B) * kSN * 4;
  const Plan pq(QKV, H, kSN, grid), ph(H, std::max(QD, FF), kSN, grid),
      pg(FF, H, kSN / 2, grid);
  o.attn_run = kMega ? attn_run_rows(B, KVH, M, grid, Tile::kMaxSplits) : 0;
  o.attn_runs = kMega ? (M + o.attn_run - 1) / o.attn_run : 0;
  o.x = take(static_cast<size_t>(B) * H * 2);
  o.xn = take(static_cast<size_t>(B) * H * 2);
  o.h = take(static_cast<size_t>(B) * FF * 2);
  o.attn = take(kMega ? static_cast<size_t>(B) * QD * 2 : 0);
  o.qr = take(kMega ? static_cast<size_t>(B) * QD * 2 : 0);
  o.nk = take(kMega ? static_cast<size_t>(B) * KVH * D : 0);
  o.nv = take(kMega ? static_cast<size_t>(B) * KVH * D : 0);
  o.nks = take(kMega ? static_cast<size_t>(B) * KVH * 2 : 0);
  o.nvs = take(kMega ? static_cast<size_t>(B) * KVH * 2 : 0);
  o.pq = take((grid + pq.units) * rec);
  o.ph = take((grid + ph.units) * rec);
  o.pg = take((grid + pg.units) * rec);
  o.pa = take(kMega ? static_cast<size_t>(B) * KVH * o.attn_runs * Tile::kPartial * 4 : 0);
  o.n_cnt = pq.units + pg.units + (kMega ? B * KVH : 0);
  o.cnt = take(static_cast<size_t>(o.n_cnt) * 4);
  o.total = off;
  return o;
}

template <int NT, int D, int G>
cudaError_t launch(StreamArgs a, void* work, int device, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = grid_of<NT, D, G>(a.H, device, &grid);
  if (err != cudaSuccess) return err;
  const Layout o = layout<D>(a.B, a.H, a.QKV, a.FF, a.QD, a.KVH, a.M, grid);
  char* w = static_cast<char*>(work);
  a.x = reinterpret_cast<__nv_bfloat16*>(w + o.x);
  a.xn = reinterpret_cast<__nv_bfloat16*>(w + o.xn);
  a.h = reinterpret_cast<__nv_bfloat16*>(w + o.h);
  a.attn = reinterpret_cast<__nv_bfloat16*>(w + o.attn);
  a.qr = reinterpret_cast<__nv_bfloat16*>(w + o.qr);
  a.nk = reinterpret_cast<int8_t*>(w + o.nk);
  a.nv = reinterpret_cast<int8_t*>(w + o.nv);
  a.nks = reinterpret_cast<__nv_bfloat16*>(w + o.nks);
  a.nvs = reinterpret_cast<__nv_bfloat16*>(w + o.nvs);
  a.part_qkv = reinterpret_cast<float*>(w + o.pq);
  a.part_h = reinterpret_cast<float*>(w + o.ph);
  a.part_glu = reinterpret_cast<float*>(w + o.pg);
  a.part_attn = reinterpret_cast<float*>(w + o.pa);
  a.cnt = reinterpret_cast<int*>(w + o.cnt);
  a.n_cnt = o.n_cnt;
  a.attn_run = o.attn_run;
  a.attn_runs = o.attn_runs;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(stream_kernel<NT, D, G>),
                                    dim3(grid), dim3(kSThreads), args,
                                    smem_bytes<NT, D, G>(a.H), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// n-tiles (8 batch rows each) of the product tiles: the smallest instance
// that holds B
inline int tiles_for(int B) {
  constexpr int kNt[] = {1, 4, 10, 16};
  for (int n : kNt) {
    if (8 * n >= B) return n;
  }
  return 0;
}

// the two things done per instance, as functors for dispatch()
struct WorkspaceOf {
  int B, H, QKV, FF, QD, KVH, M, device;
  long long* bytes;
  template <int NT, int DD, int GG>
  cudaError_t operator()() const {
    int grid = 0;
    const cudaError_t err = grid_of<NT, DD, GG>(H, device, &grid);
    if (err == cudaSuccess) {
      *bytes = static_cast<long long>(layout<DD>(B, H, QKV, FF, QD, KVH, M, grid).total);
    }
    return err;
  }
};

struct Launch {
  StreamArgs a;
  void* work;
  int device;
  cudaStream_t stream;
  template <int NT, int DD, int GG>
  cudaError_t operator()() const { return launch<NT, DD, GG>(a, work, device, stream); }
};

// Calls f.template operator()<NT, D, G>() for the instance of (B, D, G);
// D == 0 selects dense_stream. Returns cudaErrorInvalidValue without one.
template <typename F>
cudaError_t dispatch(int B, int D, int G, const F& f) {
#define KARANTA_STREAM_NT(DD, GG)                                               \
  switch (tiles_for(B)) {                                                       \
    case 1: return f.template operator()<1, DD, GG>();                          \
    case 4: return f.template operator()<4, DD, GG>();                          \
    case 10: return f.template operator()<10, DD, GG>();                        \
    case 16: return f.template operator()<16, DD, GG>();                        \
    default: return cudaErrorInvalidValue;                                      \
  }
  if (D == 0) { KARANTA_STREAM_NT(0, 0) }
  if (D == 128 && G == 7) { KARANTA_STREAM_NT(128, 7) }  // Qwen2.5-VL-7B
  if (D == 64 && G == 2) { KARANTA_STREAM_NT(64, 2) }    // the tiny test config
#undef KARANTA_STREAM_NT
  return cudaErrorInvalidValue;
}

inline bool shapes_ok(int B, int H, int QKV, int FF, int QD) {
  return B >= 1 && B <= 128 && H % kSK == 0 && FF % kSK == 0 && QD % kSK == 0 &&
         QKV > 0 && H > 0 && FF > 0 && QD > 0;
}

}  // namespace karanta

// C interface (loaded with ctypes). Bytes of workspace a call needs (the
// grid is the device's co-resident block count; KVH and M are the
// megakernel's cache shape), or a negative CUDA error.
extern "C" long long karanta_decode_stream_workspace(int mega, int B, int H, int QKV,
                                                     int FF, int QD, int KVH, int M, int D,
                                                     int G, int device) {
  using namespace karanta;
  if (!shapes_ok(B, H, QKV, FF, QD)) return -static_cast<long long>(cudaErrorInvalidValue);
  long long bytes = 0;
  const cudaError_t err = dispatch(B, mega ? D : 0, mega ? G : 0,
                                   WorkspaceOf{B, H, QKV, FF, QD, KVH, M, device, &bytes});
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return bytes;
}

// all layers' dense products; returns the CUDA error code of the launch
extern "C" int karanta_dense_stream(
    const void* x0, const void* attn_out, const void* ln1, const void* ln2,
    const int8_t* wqkv, const float* qs, const void* bias, const int8_t* wo,
    const float* os, const int8_t* wg, const float* gs, const int8_t* wu, const float* us,
    const int8_t* wd, const float* ds, void* xout, void* qkvout, void* work,
    unsigned* barrier, int B, int H, int QKV, int FF, int L, float eps, void* stream) {
  using namespace karanta;
  StreamArgs a{};
  a.x0 = static_cast<const __nv_bfloat16*>(x0);
  a.attn_in = static_cast<const __nv_bfloat16*>(attn_out);
  a.ln1 = static_cast<const __nv_bfloat16*>(ln1);
  a.ln2 = static_cast<const __nv_bfloat16*>(ln2);
  a.wqkv = wqkv, a.qs = qs, a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.wo = wo, a.os = os, a.wg = wg, a.gs = gs, a.wu = wu, a.us = us, a.wd = wd, a.ds = ds;
  a.xout = static_cast<__nv_bfloat16*>(xout);
  a.qkvout = static_cast<__nv_bfloat16*>(qkvout);
  a.bar = barrier;
  a.B = B, a.H = H, a.QKV = QKV, a.FF = FF, a.L = L, a.QD = H, a.KVH = 0, a.M = 0;
  a.scale = 0.f, a.eps = eps;
  if (!shapes_ok(B, H, QKV, FF, H)) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaGetDevice(&device);
  return static_cast<int>(
      dispatch(B, 0, 0, Launch{a, work, device, static_cast<cudaStream_t>(stream)}));
}

// one whole decode step; the caches are appended in place
extern "C" int karanta_decode_megakernel(
    const void* x0, const float* cos, const float* sin, const void* ln1, const void* ln2,
    const int8_t* wqkv, const float* qs, const void* bias, const int8_t* wo,
    const float* os, const int8_t* wg, const float* gs, const int8_t* wu, const float* us,
    const int8_t* wd, const float* ds, int8_t* k_cache, int8_t* v_cache, void* ks_cache,
    void* vs_cache, const int* cache_len, void* xout, void* work, unsigned* barrier,
    int B, int H, int QKV, int FF, int L, int QD, int KVH, int G, int M, int D,
    float scale, float eps, void* stream) {
  using namespace karanta;
  StreamArgs a{};
  a.x0 = static_cast<const __nv_bfloat16*>(x0);
  a.cos = cos, a.sin = sin;
  a.ln1 = static_cast<const __nv_bfloat16*>(ln1);
  a.ln2 = static_cast<const __nv_bfloat16*>(ln2);
  a.wqkv = wqkv, a.qs = qs, a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.wo = wo, a.os = os, a.wg = wg, a.gs = gs, a.wu = wu, a.us = us, a.wd = wd, a.ds = ds;
  a.kc = k_cache, a.vc = v_cache;
  a.ksc = static_cast<__nv_bfloat16*>(ks_cache);
  a.vsc = static_cast<__nv_bfloat16*>(vs_cache);
  a.lens = cache_len;
  a.xout = static_cast<__nv_bfloat16*>(xout);
  a.qkvout = nullptr;
  a.bar = barrier;
  a.B = B, a.H = H, a.QKV = QKV, a.FF = FF, a.L = L, a.QD = QD, a.KVH = KVH, a.M = M;
  a.scale = scale, a.eps = eps;
  if (!shapes_ok(B, H, QKV, FF, QD) || QD != KVH * G * D || QKV != QD + 2 * KVH * D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaGetDevice(&device);
  return static_cast<int>(
      dispatch(B, D, G, Launch{a, work, device, static_cast<cudaStream_t>(stream)}));
}
