// Vision window attention with fused rotary embedding, for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/attention.py:403
// _window_attention_kernel_call (bodies _window_rope_kernel :362 and
// _window_kernel :316). Each query attends only to the keys of its own
// `window`-token segment that are live under the kv mask; with cos/sin the
// queries and keys are rotated first (q*cos + rotate_half(q)*sin, in float32,
// rounded back to the activation type as the TPU kernel does).
//
// What bounds it on this card: bytes. Each element of q, k, v and out
// crosses device memory once and meets only W = 64 keys, about W / 2 = 32
// flops per byte in bf16, far under the card's ~295; at the Qwen2.5-VL-7B
// shape (S = 5120, 16 heads, D = 80) the 56 MB of q, k, v, out, cos/sin and
// mask take 0.0166 ms at 3.35 TB/s, the 1.7 GFLOP 0.0017 ms on the tensor
// cores. So the design keeps bytes in flight all the time: a block must load
// the next items while it computes and stores this one.
//
// The bf16 instance (window_tma_kernel) is a persistent, warp-specialised
// kernel. Its work is a list of items, each the 64 query rows of one head
// (one wgmma M tile): a tile of 64 / W windows where W <= 64 (windows of 16
// or 32 rows share a tile under a block-diagonal mask; a window of 48 leaves
// 16 rows that are neither rotated nor stored), or one of the ceil(W / 64)
// query tiles of a window above 64. Items run (batch, tile, query tile,
// head), heads fastest; the grid is every resident block (one an SM) and
// block i takes the contiguous items [i n / G, (i + 1) n / G), so the items
// of one tile come one after another and its cos/sin rows are staged once
// for all its heads. Each output row is written by exactly one item from
// that item's inputs alone, so a page's bits do not depend on B, on the
// other pages of a concatenation or on the grid. The producer and the
// consumers walk their items without dividing (WinWalk).
//
// Warpgroup 0 is the producer: after setmaxnreg.dec one thread loads each
// item's Q (64 rows) and its tile's K and V (64 rows, or the window rounded
// up to 64) with TMA (cp.async.bulk.tensor, tensor maps encoded on the host
// for every call over the BSHD strides, zero fill past S) and the tile's
// mask slice with a bulk copy, into a ring of up to kWinMaxStages item
// stages with full and empty mbarriers; and, when the tile changes, the
// tile's float32 cos/sin rows (bulk copies) into one of two slots with full
// and empty mbarriers of their own (a consumer frees a slot as soon as its
// rope no longer needs it: per rank, with four heads a tile, the producer
// waited for slots 41-46% of its time). Operand tiles are column planes as in
// flash_attention.cu: Q and K in planes of 64 columns (128-byte swizzle)
// and, at D = 80, one of 16 (32-byte swizzle); V in planes of 16 columns at
// D = 80. Warpgroups 1 and 2 are consumers, after setmaxnreg.inc, taking the
// block's items in turn, so one's rope and softmax run under the other's
// products and stores. A consumer waits for its item and rotates its Q and
// K rows in place in shared memory: each thread owns fixed 4-column quads of
// the 64 rows (offsets worked out once, WinRopeUnits), so neighbouring lanes
// read neighbouring 16 bytes of cos/sin; a quad's cos/sin serve its Q and K
// rows; float32 with the plain version's separate roundings (__fmul_rn /
// __fadd_rn), then bf16. It fences them to the async proxy and runs S =
// Q.K^T as wgmma m64n64k16 with both operands in shared memory, one 64-key
// chunk of scores a product. The softmax is exact, as the TPU kernel's
// (attention.py:390-397): keys outside a row's window score -inf, masked keys
// -1e30 (an fma of the score with the -1e30 bias), the row max and sum over
// the quad of lanes that share a row, ex2 with scale * log2(e) folded in, P
// normalised and rounded to bf16 in registers (the TPU kernel's
// p.astype(v.dtype)) as the register A operand of O = P.V, V N-major through
// the descriptor's transpose bit. A window above 64 keys recomputes its
// score chunks for the sum and for P.V instead of rescaling, so it rounds
// where the TPU kernel does too. A row whose window has no live key averages
// its window's values uniformly (its output is unspecified: the encoder
// drops it). The item's stage is freed once its products are done; O goes in
// bf16 through a buffer of the consumer's own (the store map's swizzled
// layout) to a TMA store over a rank-5 view of out, (D, W, windows, H, B),
// whose box is the item's tile, so rows past the tile's windows are never
// written; the store drains while the consumer takes its next item.
//
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit (bench/flash_ab.py
// --kernel 1, device time from CUDA graphs, variants built from copies of
// this file and timed in turns; PERF.md, PR 23): at the 7B page shape with
// rope 0.0275-0.0279 ms, 60% of the bound (the mma.sync body before it:
// 0.0358-0.0361); without rope 0.0228-0.0231, 68%; four pages 0.087, 76%.
// What the consumers spend an item on at the page shape (flash_trace
// --kernel 1): waiting for it 22%, rope 23%, softmax 18%, the last store's
// drain 14%. Slower, and not kept: rope by the producer warpgroup's three
// idle warps (the rope warps became the chain), a tile's cos/sin kept in
// registers (ptxas holds a 384-thread block to 168 registers a thread, and
// 288 threads round to the same; it spilled), 8-column rope chunks (3-way
// bank conflicts on cos/sin: 0.0299-0.0301 ms), O stored from registers
// (0.0260 against 0.0230 without rope); no faster: V in 64 + 16 column
// planes, the stage freed after the store, rope quads three at a time (each
// within 1% of this body) and the store drained later (within 1% of an
// earlier one).
//
// The float32 instance (window_attention_kernel) stays on the CUDA cores:
// the tensor cores would multiply in TF32. One block per (window, head,
// batch), one thread per query row keeps its rotated query and float32
// accumulator in registers and runs an online softmax over the window's
// keys, sixteen keys per rescale.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace karanta {

// ---------------------------------------------------------------------------
// bf16: TMA, wgmma, warp specialisation over a persistent grid
// ---------------------------------------------------------------------------

constexpr int kWinThreads = 384;  // a producer warpgroup and two consumers
constexpr int kWinConsumers = 2;
constexpr int kWinMaxStages = 4;  // item stages of the ring, fewer where they do not fit
constexpr int kWinProducerRegs = 40, kWinConsumerRegs = 232;
constexpr int kWinRows = 64;  // query rows of an item (one wgmma M tile)
constexpr int kWinKeys = 64;  // keys of one score chunk
constexpr size_t kWinSmemCap = 227 * 1024;

// column planes of a D-wide bf16 tile (flash_attention.cu's WgTile): Q, K
// and out in planes of kWide columns and one of kRest; V in planes of kVWide
template <int D>
struct WinPlanes {
  static constexpr int kWide = D >= 64 ? 64 : D;
  static constexpr int kFull = D / kWide;
  static constexpr int kRest = D % kWide;
  static constexpr int kVWide = kRest > 0 ? kRest : kWide;
  static constexpr uint32_t kQBytes = kWinRows * D * 2;

  // the byte offset of column `col`'s plane in a tile of `rows` rows, and
  // its width
  __host__ __device__ static constexpr uint32_t base(int col, int rows) {
    return (col / kWide) * rows * kWide * 2;
  }
  __host__ __device__ static constexpr int width(int col) {
    return col < kFull * kWide ? kWide : kRest;
  }
  // the byte offset of element (r, col) in a tile of `rows` rows: its 16-byte
  // chunk XOR-ed with the row as the plane's swizzle does (plane bases are
  // 1024-byte aligned)
  __device__ static uint32_t at(int r, int col, int rows) {
    const int w = width(col), cb = (col % kWide) * 2;
    const int x = w == 64 ? (r & 7) : w == 32 ? ((r >> 1) & 3) : ((r >> 2) & 1);
    return base(col, rows) + r * 2 * w + ((((cb >> 4) ^ x) << 4) | (cb & 15));
  }
};

// The launch's geometry, computed on the host (win_geometry) and passed by
// value. A tile is the key range an item attends over: 64 / W windows (wpt)
// where W <= 64, else one window of nq query tiles and kr = W rounded up to
// 64 key rows.
struct WinGeom {
  int B, S, H, W;
  int wpt, nq, kr, n_tiles, n_items;
  int stages, staged, has_mask, rope;
  int cs_rows;  // cos (then sin) rows of a cos/sin slot
  uint32_t stage_bytes, off_out, off_cs, off_mask, off_bar;
  size_t smem;
  float scale_log2;
};

template <int D>
WinGeom win_geometry(int B, int S, int H, int W, bool has_mask, bool rope, float scale) {
  WinGeom g;
  g.B = B;
  g.S = S;
  g.H = H;
  g.W = W;
  g.wpt = W <= kWinRows ? kWinRows / W : 1;
  g.nq = W <= kWinRows ? 1 : (W + kWinRows - 1) / kWinRows;
  g.kr = W <= kWinRows ? kWinKeys : (W + kWinKeys - 1) / kWinKeys * kWinKeys;
  g.n_tiles = (S / W + g.wpt - 1) / g.wpt;
  g.n_items = B * g.n_tiles * g.nq * H;
  g.has_mask = has_mask ? 1 : 0;
  g.rope = rope ? 1 : 0;
  g.cs_rows = W <= kWinRows ? g.wpt * W : W;
  g.stage_bytes = WinPlanes<D>::kQBytes + 2u * g.kr * D * 2;
  const uint32_t out_bytes = kWinConsumers * WinPlanes<D>::kQBytes;
  const uint32_t cs_slot = static_cast<uint32_t>(g.cs_rows) * D * 4 * 2;
  // 1024: the base is rounded up to the swizzle atoms' alignment
  auto total = [&](int stages, bool staged) {
    return 1024 + static_cast<size_t>(stages) * g.stage_bytes + out_bytes +
           (staged ? 2 * cs_slot : 0) + static_cast<size_t>(stages) * g.kr * 4 +
           (2 * stages + 4) * 8;
  };
  // stage the cos/sin rows where two slots fit beside a ring of two stages
  // (every window up to 64 rows), else rope reads them in place
  g.staged = rope && total(2, true) <= kWinSmemCap ? 1 : 0;
  g.stages = 2;
  while (g.stages < kWinMaxStages && total(g.stages + 1, g.staged) <= kWinSmemCap) ++g.stages;
  g.off_out = g.stages * g.stage_bytes;
  g.off_cs = g.off_out + out_bytes;
  g.off_mask = g.off_cs + (g.staged ? 2 * cs_slot : 0);
  g.off_bar = g.off_mask + g.stages * g.kr * 4;
  g.smem = total(g.stages, g.staged);
  g.scale_log2 = scale * kLog2e;
  return g;
}

// an item's coordinates: batch, tile, query tile of the window, head
struct WinItem {
  int b, t, qs, h;
};

__device__ __forceinline__ WinItem win_item(const WinGeom& g, int it) {
  WinItem x;
  x.h = it % g.H;
  int r = it / g.H;
  x.qs = r % g.nq;
  r /= g.nq;
  x.t = r % g.n_tiles;
  x.b = r / g.n_tiles;
  return x;
}

// the rows of tile t whose windows exist: W <= 64 tiles end at the last
// window, a wider tile is one window
__device__ __forceinline__ int win_tile_rows(const WinGeom& g, int t) {
  return g.W <= kWinRows ? min(g.wpt, g.S / g.W - t * g.wpt) * g.W : g.W;
}

// A walk over a block's items in steps of `step` (the producer's 1, a
// consumer's kWinConsumers) that carries the coordinates, the ring stage and
// its phase parity forward instead of dividing anew for every item; ord is
// the ordinal of the item's tile among the block's tiles.
struct WinWalk {
  WinItem x;
  int st, phase, ord, tile0;

  __device__ __forceinline__ WinWalk(const WinGeom& g, int begin, int first) {
    x = win_item(g, begin + first);
    st = first % g.stages;
    phase = (first / g.stages) & 1;
    tile0 = begin / (g.H * g.nq);
    ord = x.b * g.n_tiles + x.t - tile0;
  }

  __device__ __forceinline__ void next(const WinGeom& g, int step) {
    x.h += step;
    while (x.h >= g.H) {
      x.h -= g.H;
      if (++x.qs == g.nq) {
        x.qs = 0;
        if (++x.t == g.n_tiles) {
          x.t = 0;
          ++x.b;
        }
      }
    }
    st += step;
    if (st >= g.stages) {
      st -= g.stages;
      phase ^= 1;
    }
    ord = x.b * g.n_tiles + x.t - tile0;
  }
};

// one tile (`rows` rows from `row`) of a tensor into its planes: the full
// planes through `wide`, the last 16 columns at D = 80 through `rest`
template <int D>
__device__ __forceinline__ void win_load_planes(unsigned char* dst, const CUtensorMap* wide,
                                                const CUtensorMap* rest, uint64_t* bar,
                                                int rows, int row, int head, int b) {
  using P = WinPlanes<D>;
#pragma unroll
  for (int p = 0; p < P::kFull; ++p) {
    tma_load_4d(dst + p * rows * P::kWide * 2, wide, bar, p * P::kWide, row, head, b);
  }
  if constexpr (P::kRest > 0) {
    tma_load_4d(dst + P::kFull * rows * P::kWide * 2, rest, bar, P::kFull * P::kWide, row,
                head, b);
  }
}

// a bf16 pair's elements as floats (exact: a bf16 is a float's upper half)
__device__ __forceinline__ float win_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float win_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Rope of a 4-column quad (lo, two bf16 pairs) and its partner D/2 columns on
// (hi): x*cos + rotate_half(x)*sin with rotate_half(x)[d] = -x[d + D/2] below
// D/2 and x[d - D/2] above, each product and the sum rounded to float32 as
// the plain version's separate elementwise passes are, then to bf16. cl/ch:
// the cos of the quad's columns and of its partner's; sl/sh: their sin.
__device__ __forceinline__ void win_rotate4(uint2& lo, uint2& hi, const float4& cl,
                                            const float4& ch, const float4& sl,
                                            const float4& sh) {
  const float a[4] = {win_lo(lo.x), win_hi(lo.x), win_lo(lo.y), win_hi(lo.y)};
  const float z[4] = {win_lo(hi.x), win_hi(hi.x), win_lo(hi.y), win_hi(hi.y)};
  const float c0[4] = {cl.x, cl.y, cl.z, cl.w}, c1[4] = {ch.x, ch.y, ch.z, ch.w};
  const float s0[4] = {sl.x, sl.y, sl.z, sl.w}, s1[4] = {sh.x, sh.y, sh.z, sh.w};
  float ra[4], rz[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ra[e] = __fadd_rn(__fmul_rn(a[e], c0[e]), __fmul_rn(-z[e], s0[e]));
    rz[e] = __fadd_rn(__fmul_rn(z[e], c1[e]), __fmul_rn(a[e], s1[e]));
  }
  lo = make_uint2(pack_bf16(ra[0], ra[1]), pack_bf16(ra[2], ra[3]));
  hi = make_uint2(pack_bf16(rz[0], rz[1]), pack_bf16(rz[2], rz[3]));
}

// win_rotate4 in place at lo and hi, with the quad's cos at c[0..3] and its
// partner's at c[half..], sin likewise at s
__device__ __forceinline__ void win_rotate_quad(uint2* lo, uint2* hi, const float* c,
                                                const float* s, int half) {
  uint2 a = *lo, z = *hi;
  win_rotate4(a, z, *reinterpret_cast<const float4*>(c),
              *reinterpret_cast<const float4*>(c + half), *reinterpret_cast<const float4*>(s),
              *reinterpret_cast<const float4*>(s + half));
  *lo = a;
  *hi = z;
}

// rope over an item of a window above 64 rows: Q rows [0, q_rows) at the
// window's positions q_pos0 + r, then K rows [0, k_rows) at positions r, a
// quad a thread at a time (cos/sin in shared or device memory, row pitch
// D). ct: the thread in its warpgroup.
template <int D>
__device__ __forceinline__ void win_rope(unsigned char* q_s, unsigned char* k_s, int kr,
                                         const float* cos, const float* sin, int q_rows,
                                         int q_pos0, int k_rows, int ct) {
  using P = WinPlanes<D>;
  constexpr int kQ = D / 8;  // quads in a row's lower half
  for (int u = ct; u < (q_rows + k_rows) * kQ; u += 128) {
    const bool is_q = u < q_rows * kQ;
    const int v = is_q ? u : u - q_rows * kQ;
    const int r = v / kQ, c0 = 4 * (v % kQ), rows = is_q ? kWinRows : kr;
    unsigned char* tile = is_q ? q_s : k_s;
    const int at = (is_q ? q_pos0 + r : r) * D + c0;
    win_rotate_quad(reinterpret_cast<uint2*>(tile + P::at(r, c0, rows)),
                    reinterpret_cast<uint2*>(tile + P::at(r, c0 + D / 2, rows)), cos + at,
                    sin + at, D / 2);
  }
}

// The rope of a tile of 64 rows or less (Q and K at the same positions) by a
// consumer warpgroup: thread ct's quads are u = ct + 128 n (n < D / 16) of
// the 64 x D / 8 quads of the rows' lower halves, row u / (D / 8), columns
// 4 (u % (D / 8)) on, so neighbouring lanes read neighbouring 16 bytes of
// cos/sin; the thread works out their offsets in the 64-row Q and K tiles
// and in the cos/sin rows once, not once an item.
template <int D>
struct WinRopeUnits {
  static constexpr int kQ = D / 8, kN = D / 16;
  uint32_t lo[kN], hi[kN];
  int cs[kN], row[kN];

  __device__ __forceinline__ explicit WinRopeUnits(int ct) {
    using P = WinPlanes<D>;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int u = ct + 128 * n, r = u / kQ, c0 = 4 * (u % kQ);
      row[n] = r;
      lo[n] = P::at(r, c0, kWinRows);
      hi[n] = P::at(r, c0 + D / 2, kWinRows);
      cs[n] = r * D + c0;
    }
  }
};

// rotate the item's Q and K rows [0, rows) by the thread's quads, two at a
// time: both quads' cos/sin and rows are loaded before either is rotated and
// stored, so their loads are in flight together
template <int D>
__device__ __forceinline__ void win_rope_units(unsigned char* q_s, unsigned char* k_s,
                                               const float* cos, const float* sin, int rows,
                                               const WinRopeUnits<D>& un) {
  constexpr int kN = WinRopeUnits<D>::kN;
#pragma unroll
  for (int n0 = 0; n0 < kN; n0 += 2) {
    float4 c[2][4];
    uint2 x[2][4];  // Q lower, Q upper, K lower, K upper
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int n = n0 + m;
      if (n >= kN || un.row[n] >= rows) continue;
      c[m][0] = *reinterpret_cast<const float4*>(cos + un.cs[n]);
      c[m][1] = *reinterpret_cast<const float4*>(cos + un.cs[n] + D / 2);
      c[m][2] = *reinterpret_cast<const float4*>(sin + un.cs[n]);
      c[m][3] = *reinterpret_cast<const float4*>(sin + un.cs[n] + D / 2);
      x[m][0] = *reinterpret_cast<const uint2*>(q_s + un.lo[n]);
      x[m][1] = *reinterpret_cast<const uint2*>(q_s + un.hi[n]);
      x[m][2] = *reinterpret_cast<const uint2*>(k_s + un.lo[n]);
      x[m][3] = *reinterpret_cast<const uint2*>(k_s + un.hi[n]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int n = n0 + m;
      if (n >= kN || un.row[n] >= rows) continue;
      win_rotate4(x[m][0], x[m][1], c[m][0], c[m][1], c[m][2], c[m][3]);
      win_rotate4(x[m][2], x[m][3], c[m][0], c[m][1], c[m][2], c[m][3]);
      *reinterpret_cast<uint2*>(q_s + un.lo[n]) = x[m][0];
      *reinterpret_cast<uint2*>(q_s + un.hi[n]) = x[m][1];
      *reinterpret_cast<uint2*>(k_s + un.lo[n]) = x[m][2];
      *reinterpret_cast<uint2*>(k_s + un.hi[n]) = x[m][3];
    }
  }
}

// S = Q K^T of the item's 64 rows against key chunk ck (64 keys), Q and K
// K-major in their planes; a k-step is 32 bytes along its plane's rows
template <int D>
__device__ __forceinline__ void win_issue_qk(float (&s)[kWinKeys / 2], uint32_t q_addr,
                                             uint32_t k_addr, int kr, int ck) {
  using P = WinPlanes<D>;
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = 16 * kk, w = P::width(col);
    const uint32_t in_row = (col % P::kWide) * 2;
    const uint64_t da = kmajor_desc(q_addr + P::base(col, kWinRows) + in_row, w);
    const uint64_t db =
        kmajor_desc(k_addr + P::base(col, kr) + ck * kWinKeys * 2 * w + in_row, w);
    wgmma_ss<kWinKeys>(s, da, db, kk > 0);
  }
  wgmma_commit();
  reg_fence(s);
}

// O += P V over key chunk ck's 16-key steps: P from registers, V N-major (a
// step starts 16 rows further into the planes, whose N atoms lie a plane
// apart, the leading byte offset)
template <int D>
__device__ __forceinline__ void win_issue_pv(float (&o)[D / 2], const uint32_t (&p)[4][4],
                                             uint32_t v_addr, int kr, int ck) {
  using P = WinPlanes<D>;
  constexpr uint32_t kRow = 2 * P::kVWide;
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWinKeys / 16; ++kk) {
    wgmma_rs_tb<D>(o, p[kk],
                   gmma_desc(v_addr + (ck * kWinKeys + kk * 16) * kRow, kr * kRow, 8 * kRow,
                             plane_layout(P::kVWide)),
                   1);
  }
  wgmma_commit();
  reg_fence(o);
}

// One chunk's scores into the log2 domain and masked. The lane holds rows
// r_i (i = 0, 1), keys k0 + 8j + 2t + e; a key outside row i's window
// [lo_i, hi_i) scores -inf, a masked one fma(s, scale, -1e30) = -1e30 (the
// scores are far below an ulp of 1e30), the rest s * scale * log2(e).
__device__ __forceinline__ void win_mask(float (&s)[kWinKeys / 2], const float* live, int k0,
                                         const int (&lo)[2], const int (&hi)[2], int t,
                                         float scale_log2) {
#pragma unroll
  for (int j = 0; j < kWinKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * t + e;
      const float bias = live == nullptr || live[key] > 0.f ? 0.f : kNegInf;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float& x = s[4 * j + 2 * i + e];
        x = key >= lo[i] && key < hi[i] ? fmaf(x, scale_log2, bias) : -CUDART_INF_F;
      }
    }
  }
}

// Maps: q and k through boxes of kWide columns (q: 64 rows, k: kr), q2 and
// k2 their last 16 columns at D = 80 (unused otherwise), v through boxes of
// kVWide columns and kr rows; o and o2 the rank-5 store maps of out's planes.
template <int D>
__global__ void __launch_bounds__(kWinThreads, 1)
    window_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_q2,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_k2,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      const __grid_constant__ CUtensorMap tm_o2, const float* __restrict__ mask,
                      const float* __restrict__ cos, const float* __restrict__ sin,
                      const WinGeom g) {
  using P = WinPlanes<D>;
  extern __shared__ __align__(128) unsigned char win_smem[];
  unsigned char* smem = win_smem + ((1024 - (smem_u32(win_smem) & 1023)) & 1023);
  float* cs_s = reinterpret_cast<float*>(smem + g.off_cs);  // [2][cos, sin][cs_rows][D]
  float* mask_s = reinterpret_cast<float*>(smem + g.off_mask);  // [stages][kr]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.off_bar);
  uint64_t* empty = full + g.stages;
  uint64_t* cs_full = empty + g.stages;
  uint64_t* cs_empty = cs_full + 2;
  const int cs_slot = 2 * g.cs_rows * D;  // floats of a cos/sin slot
  const uint32_t kv_bytes = static_cast<uint32_t>(g.kr) * D * 2;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int begin = static_cast<int>(static_cast<long long>(g.n_items) * blockIdx.x / gridDim.x);
  const int end =
      static_cast<int>(static_cast<long long>(g.n_items) * (blockIdx.x + 1) / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the item's consumer
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&cs_full[s], 1);
      mbar_init(&cs_empty[s], kWinConsumers);  // one thread of each consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<kWinProducerRegs>();
    if (tid == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      tma_prefetch(&tm_o);
      int loaded = -1;  // the ordinal of the last tile whose cos/sin were loaded
      WinWalk w(g, begin, 0);
      for (int i = 0; i < end - begin; ++i, w.next(g, 1)) {
        const WinItem x = w.x;
        const int row0 = x.t * g.wpt * g.W, st = w.st, ord = w.ord;
        if (ord != loaded) {
          loaded = ord;
          if (g.staged) {
            const int slot = ord & 1;
            mbar_wait(&cs_empty[slot], ((ord >> 1) & 1) ^ 1);
            const uint32_t bytes = static_cast<uint32_t>(win_tile_rows(g, x.t)) * D * 4;
            const size_t off = (static_cast<size_t>(x.b) * g.S + row0) * D;
            float* dst = cs_s + slot * cs_slot;
            mbar_expect_tx(&cs_full[slot], 2 * bytes);
            bulk_load(dst, cos + off, bytes, &cs_full[slot]);
            bulk_load(dst + g.cs_rows * D, sin + off, bytes, &cs_full[slot]);
          }
        }
        mbar_wait(&empty[st], w.phase ^ 1);  // first pass: free
        const long long key0 = static_cast<long long>(x.b) * g.S + row0;
        // the mask slice, cut at the end of the mask (keys past S are outside
        // every row's window)
        const uint32_t mask_bytes =
            g.has_mask ? static_cast<uint32_t>(
                             min(static_cast<long long>(g.kr),
                                 static_cast<long long>(g.B) * g.S - key0)) * 4
                       : 0;
        mbar_expect_tx(&full[st], g.stage_bytes + mask_bytes);
        unsigned char* sp = smem + st * g.stage_bytes;
        win_load_planes<D>(sp, &tm_q, &tm_q2, &full[st], kWinRows, row0 + kWinRows * x.qs, x.h,
                           x.b);
        win_load_planes<D>(sp + P::kQBytes, &tm_k, &tm_k2, &full[st], g.kr, row0, x.h, x.b);
#pragma unroll
        for (int p = 0; p < D / P::kVWide; ++p) {
          tma_load_4d(sp + P::kQBytes + kv_bytes + p * g.kr * P::kVWide * 2, &tm_v, &full[st],
                      p * P::kVWide, row0, x.h, x.b);
        }
        if (g.has_mask) bulk_load(mask_s + st * g.kr, mask + key0, mask_bytes, &full[st]);
      }
    }
    return;
  }

  // the consumers: items begin + cw, begin + cw + 2, ...
  regs_inc<kWinConsumerRegs>();
  const int cw = wg - 1, ct = tid & 127;
  const int warp = ct >> 5, lane = tid & 31, g8 = lane >> 2, t = lane & 3;
  unsigned char* out_s = smem + g.off_out + cw * P::kQBytes;
  // thread 0 frees the cos/sin slots of the block's tiles in order, each
  // once its rows have landed, so an arrival counts in its own phase
  int released = 0;
  auto free_slots = [&](int upto) {  // the tiles before ordinal `upto`
    for (; g.staged && released < upto; ++released) {
      mbar_wait(&cs_full[released & 1], (released >> 1) & 1);
      mbar_arrive(&cs_empty[released & 1]);
    }
  };
  const WinRopeUnits<D> units(ct);
  WinWalk w(g, begin, cw);
  for (int i = cw; i < end - begin; i += kWinConsumers, w.next(g, kWinConsumers)) {
    const WinItem x = w.x;
    const int st = w.st, ord = w.ord;
    const int row0 = x.t * g.wpt * g.W;
    const int tile_rows = win_tile_rows(g, x.t);
    if (ct == 0) {
      bulk_wait_read<0>();  // this consumer's last store has read its buffer
      free_slots(ord);
    }
    mbar_wait(&full[st], w.phase);
    unsigned char* q_s = smem + st * g.stage_bytes;
    unsigned char* k_s = q_s + P::kQBytes;
    if (g.rope) {
      const float* c;
      const float* sn;
      if (g.staged) {
        mbar_wait(&cs_full[ord & 1], (ord >> 1) & 1);
        c = cs_s + (ord & 1) * cs_slot;
        sn = c + g.cs_rows * D;
      } else {
        const size_t off = (static_cast<size_t>(x.b) * g.S + row0) * D;
        c = cos + off;
        sn = sin + off;
      }
      if (g.W <= kWinRows) {
        win_rope_units<D>(q_s, k_s, c, sn, tile_rows, units);
      } else {
        const int q_pos0 = kWinRows * x.qs;
        win_rope<D>(q_s, k_s, g.kr, c, sn, min(kWinRows, tile_rows - q_pos0), q_pos0,
                    tile_rows, ct);
      }
      fence_proxy_async();
    }
    named_sync(1 + cw, 128);  // Q and K rotated and fenced; the out buffer is free
    // this consumer's next item is of a later tile (or there is none): the
    // rope is done with this tile's cos/sin, so its slot is freed now
    if (ct == 0 && g.staged) {
      WinWalk nx = w;
      nx.next(g, kWinConsumers);
      if (i + kWinConsumers >= end - begin || nx.ord > ord) free_slots(ord + 1);
    }

    const uint32_t q_addr = smem_u32(q_s), k_addr = q_addr + P::kQBytes;
    const uint32_t v_addr = k_addr + static_cast<uint32_t>(g.kr) * D * 2;
    const float* live = g.has_mask ? mask_s + st * g.kr : nullptr;
    // the lane's rows r_i = 16 warp + g8 + 8 i of the query tile; its window's
    // keys [lo_i, hi_i) in the tile's key rows
    int lo[2], hi[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int rr = kWinRows * x.qs + 16 * warp + g8 + 8 * i2;
      lo[i2] = rr / g.W * g.W;
      hi[i2] = lo[i2] + g.W;
    }
    const int n_chunks = g.kr / kWinKeys;
    float s[kWinKeys / 2], o[D / 2];
    uint32_t p[4][4];
    auto scores = [&](int ck) {
#pragma unroll
      for (int x2 = 0; x2 < kWinKeys / 2; ++x2) s[x2] = 0.f;  // no value carried in
      win_issue_qk<D>(s, q_addr, k_addr, g.kr, ck);
      wgmma_wait<0>();
      reg_fence(s);
      win_mask(s, live, ck * kWinKeys, lo, hi, t, g.scale_log2);
    };
    auto exp_sum = [&](const float (&mx)[2], float (&l)[2]) {
#pragma unroll
      for (int x2 = 0; x2 < kWinKeys / 2; ++x2) {
        s[x2] = fast_exp2(s[x2] - mx[(x2 >> 1) & 1]);
        l[(x2 >> 1) & 1] += s[x2];
      }
    };

    // exact softmax: the row max, then the row sum, then normalised P. A
    // single chunk keeps its scores in registers across the three steps.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int ck = 0; ck < n_chunks; ++ck) {
      scores(ck);
#pragma unroll
      for (int j = 0; j < kWinKeys / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    }
    float l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      if (mx[i2] == -CUDART_INF_F) mx[i2] = 0.f;  // a row past the tile: no key
    }
    for (int ck = 0; ck < n_chunks; ++ck) {
      if (n_chunks > 1) scores(ck);
      exp_sum(mx, l);
    }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
      inv[i2] = 1.f / fmaxf(l[i2], 1e-30f);  // >= 1 in a tile row: its max gives exp2(0)
    }
#pragma unroll
    for (int x2 = 0; x2 < D / 2; ++x2) o[x2] = 0.f;
    for (int ck = 0; ck < n_chunks; ++ck) {
      if (n_chunks > 1) {
        float unused[2] = {0.f, 0.f};
        scores(ck);
        exp_sum(mx, unused);
      }
      // P normalised and rounded to bf16: columns 16kk..16kk+15 are the A
      // operand of k-step kk
#pragma unroll
      for (int kk = 0; kk < kWinKeys / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r] * inv[r & 1], s[8 * kk + 2 * r + 1] * inv[r & 1]);
        }
      }
      win_issue_pv<D>(o, p, v_addr, g.kr, ck);
      wgmma_wait<0>();
      reg_fence(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp's products have read the stage

    // O to this consumer's buffer in the store map's layout, then one TMA
    // store of the item's tile rows
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int r = 16 * warp + g8 + 8 * i2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out_s + P::at(r, 8 * j + 2 * t, kWinRows)) =
            pack_bf16(o[4 * j + 2 * i2], o[4 * j + 2 * i2 + 1]);
      }
    }
    fence_proxy_async();
    named_sync(1 + cw, 128);
    if (ct == 0) {
      const int win0 = x.t * g.wpt, r0 = kWinRows * x.qs;
#pragma unroll
      for (int pl = 0; pl < P::kFull; ++pl) {
        tma_store_5d(&tm_o, out_s + pl * kWinRows * P::kWide * 2, pl * P::kWide, r0, win0, x.h,
                     x.b);
      }
      if constexpr (P::kRest > 0) {
        tma_store_5d(&tm_o2, out_s + P::kFull * kWinRows * P::kWide * 2, P::kFull * P::kWide,
                     r0, win0, x.h, x.b);
      }
      bulk_commit();
    }
  }
  if (ct == 0) {
    // to the block's last tile, also those whose items all went to the
    // other consumer
    free_slots((end - 1) / (g.H * g.nq) - w.tile0 + 1);
    bulk_wait<0>();  // the stores are done before the block's shared memory goes
  }
}

// the rank-5 store map of out's `w`-column plane: out (B, S, H, D) viewed as
// (D, W, S / W, H, B); a box is the item's tile, min(W, 64) rows of each of
// max(1, 64 / W) windows, so TMA cuts it at the window's (or the last
// window's) end
inline CUresult encode_window_out(CUtensorMap* map, void* out, int B, int S, int H, int D, int W,
                                  int w) {
  const cuuint64_t row = static_cast<cuuint64_t>(H) * D * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S / W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {row, row * W, static_cast<cuuint64_t>(D) * 2, row * S};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(W < kWinRows ? W : kWinRows),
                             static_cast<cuuint32_t>(W < kWinRows ? kWinRows / W : 1), 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, out, dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, plane_swizzle(w),
                        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the grid cache of each head dim's kernel, in this library's own storage
namespace {
ResidentGrid win_grids[3];
}

template <int D>
ResidentGrid& win_grid_cache() {
  return win_grids[D == 16 ? 0 : D == 64 ? 1 : 2];
}

// 0, the launch's CUDA error code, or the driver's code of a failed encode
template <int D>
int launch_window_tma(const void* q, const void* k, const void* v, const float* mask,
                      const float* cos, const float* sin, void* out, int B, int S, int H, int W,
                      float scale, cudaStream_t stream) {
  using P = WinPlanes<D>;
  const WinGeom g = win_geometry<D>(B, S, H, W, mask != nullptr, cos != nullptr, scale);
  if (g.n_items == 0) return 0;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tq2, tk, tk2, tv, to, to2;
  memset(&tq2, 0, sizeof(tq2));
  memset(&tk2, 0, sizeof(tk2));
  memset(&to2, 0, sizeof(to2));
  CUresult r = encode_bshd(&tq, q, B, S, H, D, P::kWide, kWinRows);
  if (r == CUDA_SUCCESS) r = encode_bshd(&tk, k, B, S, H, D, P::kWide, g.kr);
  if (r == CUDA_SUCCESS) r = encode_bshd(&tv, v, B, S, H, D, P::kVWide, g.kr);
  if (r == CUDA_SUCCESS) r = encode_window_out(&to, out, B, S, H, D, W, P::kWide);
  if (P::kRest > 0) {
    if (r == CUDA_SUCCESS) r = encode_bshd(&tq2, q, B, S, H, D, P::kRest, kWinRows);
    if (r == CUDA_SUCCESS) r = encode_bshd(&tk2, k, B, S, H, D, P::kRest, g.kr);
    if (r == CUDA_SUCCESS) r = encode_window_out(&to2, out, B, S, H, D, W, P::kRest);
  }
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  auto kernel = window_tma_kernel<D>;
  int grid = 0;
  const cudaError_t err = resident_grid(kernel, kWinThreads, g.smem, win_grid_cache<D>(), &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<min(grid, g.n_items), kWinThreads, g.smem, stream>>>(tq, tq2, tk, tk2, tv, to, to2,
                                                                 mask, cos, sin, g);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 instance's resources for window W with rope and a mask: registers
// and spilled bytes a thread, dynamic shared bytes, resident blocks an SM,
// heads an item, ring stages, consumer warpgroups, the producer's and the
// consumers' registers after setmaxnreg, and whether cos/sin are staged
template <int D>
cudaError_t window_tma_info(int W, int* info) {
  const WinGeom g = win_geometry<D>(1, W, 1, W, true, true, 1.f);
  const void* fn = reinterpret_cast<const void*>(window_tma_kernel<D>);
  cudaError_t err = allow_all_smem(window_tma_kernel<D>);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(g.smem);
  info[4] = 1;
  info[5] = g.stages;
  info[6] = kWinConsumers;
  info[7] = kWinProducerRegs;
  info[8] = kWinConsumerRegs;
  info[9] = g.staged;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, kWinThreads, g.smem);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWinChunk = 16;  // keys per online-softmax rescale

template <typename T, int D>
__global__ void __launch_bounds__(256) window_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask,  // (B, S) or null: 1 = live key
    const float* __restrict__ cos,   // (B, S, D) or null: no rope
    const float* __restrict__ sin, T* __restrict__ out, int S, int H, int W,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [W][D]
  T* v_s = k_s + W * D;                     // [W][D]
  float* live = reinterpret_cast<float*>(v_s + W * D);  // [W]

  const int r = threadIdx.x;
  const int s = blockIdx.x * W + r;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row = (static_cast<size_t>(b) * S + s) * H + h;  // (b, s, h)
  constexpr int kHalf = D / 2;

  float qf[D], kf[D];
  load_row<T, D>(q + row * D, qf);
  load_row<T, D>(k + row * D, kf);
  if (cos != nullptr) {
    // rotate each (d, d + D/2) pair in place: rotate_half(x)[d] = -x[d + D/2]
    // for d < D/2 and x[d - D/2] above
    const float* c = cos + (static_cast<size_t>(b) * S + s) * D;
    const float* sn = sin + (static_cast<size_t>(b) * S + s) * D;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      const float q_lo = qf[d], q_hi = qf[d + kHalf];
      const float k_lo = kf[d], k_hi = kf[d + kHalf];
      qf[d] = round_to<T>(q_lo * c[d] - q_hi * sn[d]);
      qf[d + kHalf] = round_to<T>(q_hi * c[d + kHalf] + q_lo * sn[d + kHalf]);
      kf[d] = round_to<T>(k_lo * c[d] - k_hi * sn[d]);
      kf[d + kHalf] = round_to<T>(k_hi * c[d + kHalf] + k_lo * sn[d + kHalf]);
    }
  }
  store_row<T, D>(k_s + r * D, kf);
  {
    float vf[D];
    load_row<T, D>(v + row * D, vf);
    store_row<T, D>(v_s + r * D, vf);
  }
  live[r] = mask != nullptr ? mask[static_cast<size_t>(b) * S + s] : 1.f;
  __syncthreads();

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int j0 = 0; j0 < W; j0 += kWinChunk) {
    float sc[kWinChunk];
    float cmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kWinChunk; ++jj) {
      const T* kr = k_s + (j0 + jj) * D;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qf[d] * to_f<T>(kr[d]);
      sc[jj] = live[j0 + jj] > 0.f ? dot * scale : kNegInf;
      cmax = fmaxf(cmax, sc[jj]);
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = __expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kWinChunk; ++jj) {
      const float p = __expf(sc[jj] - m_new);
      l += p;
      const T* vr = v_s + (j0 + jj) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += p * to_f<T>(vr[d]);
    }
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= inv;
  store_row<T, D>(out + row * D, acc);
}

template <int D>
cudaError_t launch_window_f32(const void* q, const void* k, const void* v, const float* mask,
                              const float* cos, const float* sin, void* out, int B, int S,
                              int H, int W, float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(W) * D * sizeof(float) + W * sizeof(float);
  auto kernel = window_attention_kernel<float, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / W, H, B);
  kernel<<<grid, W, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, cos, sin, static_cast<float*>(out), S, H, W,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <int D>
int launch_window(int dtype, const void* q, const void* k, const void* v, const float* mask,
                  const float* cos, const float* sin, void* out, int B, int S, int H, int W,
                  float scale, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_window_tma<D>(q, k, v, mask, cos, sin, out, B, S, H, W, scale, st);
  }
  if (dtype == kFloat32) {
    return static_cast<int>(
        launch_window_f32<D>(q, k, v, mask, cos, sin, out, B, S, H, W, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Qwen2.5-VL vision heads are 80 wide (16 in the tiny test config)
#define KARANTA_WINDOW_HEAD_DIMS(X) X(16) X(64) X(80)

}  // namespace karanta

// C interface (loaded with ctypes). q/k/v/out are contiguous (B, S, H, D) of
// the type `dtype` names; returns the CUDA error code of the launch (or the
// driver's code of a failed tensor-map encode).
extern "C" int karanta_window_attention(const void* q, const void* k, const void* v,
                                        const float* mask, const float* cos,
                                        const float* sin, void* out, int B, int S,
                                        int H, int D, int W, float scale, int dtype,
                                        void* stream) {
  if (W <= 0 || W > 256 || W % karanta::kWinChunk != 0 || S % W != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define KARANTA_CASE(d) \
  case d:               \
    return karanta::launch_window<d>(dtype, q, k, v, mask, cos, sin, out, B, S, H, W, scale, st);
    KARANTA_WINDOW_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// info[10] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, resident blocks per SM, heads an item, ring stages,
// consumer warpgroups, the producer's and the consumers' registers after
// setmaxnreg, and 1 where cos/sin are staged, of the bf16 instance for head
// dim D and window W with rope. Returns the CUDA error code.
extern "C" int karanta_window_attention_info(int D, int W, int* info) {
  if (W <= 0 || W > 256 || W % karanta::kWinChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
#define KARANTA_CASE(d) \
  case d:               \
    return static_cast<int>(karanta::window_tma_info<d>(W, info));
    KARANTA_WINDOW_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
