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
// the hidden state in VMEM. Here the grid is one block an SM (a producer
// warpgroup and two consumer warpgroups), launched with
// cudaLaunchCooperativeKernel; phases that need the whole previous phase's
// output are separated by a grid-wide barrier (a sense-reversing counter in
// global memory). A call zeroes its counters, copies x0 and normalises layer
// 0's rows, then per layer:
//
//   qkv      products (records only) [dense: and the o products]
//   [mega] qkv finish, every block a share: bias, rope, q out, this step's
//            K/V rows quantized to int8
//   [mega] attention per (slot, kv head, run of cache rows): append at
//            cache_len, the attention over [0, cache_len), new row folded in
//            last: kernel #3's body (quant_tma.cuh), one walker a block
//   [mega] o products
//   o rows   every block a share of (row, 128 columns): the o records added
//            to x in float32 (kept: the norm's input), x rounded, the group's
//            sum of squares; the warp that completes a row writes its xn =
//            bf16(x * inv * ln2) [dense: and the qkv output rows]
//   gate/up  products; a unit's last block writes h = bf16(silu(g) * u)
//   down     products
//   down rows  as the o rows: x = bf16(x + down), and the next layer's
//            ln1 norm [dense: its attention output copied alongside]; after
//            the last layer, xout
//
// so eight barriers a layer (five for dense_stream), one after the counters
// are zeroed, none after the last layer's rows.
//
// Products (out[r, n] = sum_k A[r, k] * W[n, k], W int8 out-major). A unit
// is kUnit = 128 weight rows (gate/up: 64 gate rows and the same up rows),
// an m64 tile for each consumer warpgroup (256-row units at 80 batch rows,
// half the activation bytes a weight byte, were slower: PERF.md); the
// (unit, k tile) pairs of a phase are dealt out to the blocks
// in equal contiguous ranges, unit-major. The producer warp's lane 0 streams
// each pair through a ring of stages in shared memory by TMA: the weight
// tile as 128-byte k planes of the unit's rows (a 3-D tensor map over (L, N,
// K), 128-byte swizzle, an L2 evict-first policy: the weights are read
// once), the activations' k tile as 64-column planes of the NB = 8 NT batch
// rows (rows past B read as zeros), under a full and an empty mbarrier per
// stage; at up to 32 batch rows the first stages of the next product phase
// get their weights before the barrier that its activations wait for. The
// consumers read 16
// bytes of a weight row a lane (conflict-free under the swizzle), convert
// them exactly to bf16 in registers (quant_tma.cuh's biased_byte and
// upper_halves) as the register A operand of wgmma.m64nNk16 with the batch
// as N and float32 accumulators; the activations are the K-major shared B
// operand. A lane's 16 bytes of a 128-row k group feed four k-steps, so the
// activations the products read are stored with their columns in that
// order (perm128, quant_tma.cuh): the kernel writes xn, h and attn so, and
// copies dense_stream's attention output into it. At the end of each unit
// in its range a block writes the unit's float32 partial record (B x kUnit)
// to a workspace slot (block + unit); the records are summed in block
// order, so the same inputs give the same bits on every call (for a given
// grid size). The kernel calls nothing (every function inlined, division
// without its called slow path, 32-bit plan arithmetic): a call anywhere
// makes ptxas serialize every wgmma. Scratch written during the kernel is
// read with __ldcg (L2), never through the non-coherent L1, and by TMA only
// after a grid barrier; every thread fences its own writes (also to the
// asynchronous proxy) before a barrier or a counter hands them on.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "quant_tma.cuh"

namespace karanta {

constexpr int kSWarps = 12;                // two consumer warpgroups, a producer one
constexpr int kSThreads = 32 * kSWarps;
constexpr int kCThreads = 256;             // the consumers: threads 0..255
constexpr int kProducerWarp = 8;           // its lane 0 issues the products' loads
constexpr int kRingBytes = 216 * 1024;     // the products' ring
constexpr int kMaxStages = 8;
constexpr int kMaxBatch = 128;

// The products' tiles for NT n-tiles (8 batch rows each, the wgmma N / 8)
template <int NT>
struct StreamTile {
  static constexpr int NB = 8 * NT;               // batch rows a stage holds
  static constexpr int kUnit = 128;               // weight rows (record columns) a unit
  static constexpr int kPlanes = NT <= 4 ? 2 : 1; // 128-byte k planes a stage
  static constexpr int kKT = 128 * kPlanes;       // k a stage
  static constexpr int kWPlane = kUnit * 128;     // bytes of a weight plane
  static constexpr int kAPlane = NB * 128;        // bytes of a 64-column activation plane
  static constexpr int kStage = kPlanes * (kWPlane + 2 * kAPlane);
  static constexpr int kStages =
      kRingBytes / kStage < kMaxStages ? kRingBytes / kStage : kMaxStages;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kStage % 1024 == 0 && kAPlane % 1024 == 0, "swizzle atoms stay aligned");
};

// the tensor maps of the products' operands
struct StreamMaps {
  CUtensorMap wqkv, wo, wg, wu, wd;  // (L, N, K) int8: 128 k by the unit's rows (gate, up: half)
  CUtensorMap xn, h, attn;           // (B, K) bf16 workspace rows: 64 columns by NB rows
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
  float* xf;                     // (B, H) the o residual in float32, norm2's input
  float* ssq;                    // (H / 128, B) sums of squares of x (or xf), 128 columns each
  __nv_bfloat16* xn;             // (B, H) normed rows (perm128), the products' input
  __nv_bfloat16* h;              // (B, FF) silu(g) * u (perm128)
  __nv_bfloat16* attn;           // (B, QD) attention output (perm128)
  __nv_bfloat16* qr;             // mega: (B, QD) rope'd q
  int8_t* nk;                    // mega: (B, KVH, D) this step's int8 K row
  int8_t* nv;
  __nv_bfloat16* nks;            // mega: (B, KVH) its scales
  __nv_bfloat16* nvs;
  float* part_qkv;               // (grid + units, B, kUnit) partial records
  float* part_h;                 // the same for o (dense: beside qkv), then down
  float* part_glu;               // the same for gate/up
  float* part_attn;              // mega: (B * KVH, attn_runs, kPartial)
  int* cnt;                      // counters, all n_cnt zeroed at the start: gate/up
  int* cnt_glu;                  // units', (slot, kv head)s', rows'
  int* cnt_attn;
  int* rowcnt;
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
  __host__ __device__ Plan(int N, int K, int unit_cols, int kt, int grid)
      : units((N + unit_cols - 1) / unit_cols), tiles((K + kt - 1) / kt), total(units * tiles),
        parts(grid < total ? grid : total) {}
  // (32-bit: a 64-bit division is a call, see products(); the launch checks
  // that total * grid fits)
  __host__ __device__ int lo(int i) const {
    return static_cast<int>(static_cast<unsigned>(total) * (i < parts ? i : parts) / parts);
  }
  // the block whose range holds pair x
  __device__ int block_of(int x) const {
    return static_cast<int>((static_cast<unsigned>(x + 1) * parts - 1) / total);
  }
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four bf16 values of global scratch (8-byte aligned) through L2
__device__ __forceinline__ void ld_bf4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __forceinline__ void st_bf4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// 1 / sqrt(v) to about an ulp, with no call (as div_rn)
__device__ __forceinline__ float rsqrt_nr(float v) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y * fmaf(-0.5f * v * y, y, 1.5f);
}

// the sum over a warp, a fixed butterfly
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A lane's part of a row's sum of squares over its columns of one unit:
// kQ groups of four, in order (the prologue and the residual epilogues share
// it, so a chained one-layer call sums as the full-depth one does)
template <int kQ>
__device__ __forceinline__ float lane_ssq(const float (&v)[kQ][4]) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s = fmaf(v[q][e], v[q][e], s);
  }
  return s;
}

// Grid-wide barrier; every block of the cooperative launch calls it.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  // each thread's own writes, not only thread 0's (see rows()), and to the
  // asynchronous proxy too: the next phases read them by TMA
  __threadfence();
  fence_proxy_async_global();
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

// ---------------------------------------------------------------------------
// finishing the split-K records: gate/up by each unit's last block, the
// others in phases of their own, every block a share
// ---------------------------------------------------------------------------

// The four record columns n .. n + 3 of batch row b summed over their
// unit's records (kUnit columns a unit, Plan p) in block order, eight
// records' loads in flight at a time
template <int kUnit>
__device__ __forceinline__ void col_sums(const float* part, const Plan& p, int B, int b, int n,
                                         float (&s)[4]) {
  constexpr int kR = 8;
  const int u = n / kUnit;
  const int i0 = p.block_of(u * p.tiles), count = p.block_of((u + 1) * p.tiles - 1) - i0 + 1;
  const float* r = part + (static_cast<size_t>(i0 + u) * B + b) * kUnit + n % kUnit;
  const size_t step = static_cast<size_t>(B) * kUnit;
  s[0] = s[1] = s[2] = s[3] = 0.f;
  for (int j = 0; j < count; j += kR) {
    float4 v[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      v[k] = __ldcg(reinterpret_cast<const float4*>(r + min(j + k, count - 1) * step));
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (j + k < count) s[0] += v[k].x, s[1] += v[k].y, s[2] += v[k].z, s[3] += v[k].w;
    }
  }
}

// s[v] = sum over a unit's records (block order) of the four floats at
// off[v] of each; `first` the first record's slot, `count` the records; all
// kV loads of two records in flight at a time
template <int kV>
__device__ __forceinline__ void rec_sums(const float* part, size_t stride, int first, int count,
                                         const int (&off)[kV], float (&s)[kV][4]) {
#pragma unroll
  for (int v = 0; v < kV; ++v) s[v][0] = s[v][1] = s[v][2] = s[v][3] = 0.f;
  for (int j = 0; j < count; j += 2) {
    const float* r0 = part + static_cast<size_t>(first + j) * stride;
    const float* r1 = part + static_cast<size_t>(first + min(j + 1, count - 1)) * stride;
    float4 x[kV], y[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      x[v] = __ldcg(reinterpret_cast<const float4*>(r0 + off[v]));
      y[v] = __ldcg(reinterpret_cast<const float4*>(r1 + off[v]));
    }
    const bool two = j + 1 < count;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      s[v][0] += x[v].x, s[v][1] += x[v].y, s[v][2] += x[v].z, s[v][3] += x[v].w;
      if (two) s[v][0] += y[v].x, s[v][1] += y[v].y, s[v][2] += y[v].z, s[v][3] += y[v].w;
    }
  }
}

// gate/up unit u, by its last block's consumers (threads 0..255): h of its
// kUnit / 2 columns (gate in record columns 0.., up in kUnit / 2..), four
// columns a thread, written in perm128 order
template <int NT>
__device__ __forceinline__ void epi_glu(const StreamArgs& a, int l, const Plan& p, int u) {
  using T = StreamTile<NT>;
  constexpr int kHalf = T::kUnit / 2, kQuads = kHalf / 4, kV = 4;
  const int B = a.B, FF = a.FF;
  const int i0 = p.block_of(u * p.tiles), count = p.block_of((u + 1) * p.tiles - 1) - i0 + 1;
  const size_t stride = static_cast<size_t>(B) * T::kUnit;
  const float* gs = a.gs + static_cast<size_t>(l) * FF;
  const float* us = a.us + static_cast<size_t>(l) * FF;
  for (int e0 = threadIdx.x; e0 < B * kQuads; e0 += kCThreads * kV) {
    int off[2 * kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int e = min(e0 + kCThreads * v, B * kQuads - 1);
      off[v] = (e / kQuads) * T::kUnit + 4 * (e % kQuads);
      off[kV + v] = off[v] + kHalf;
    }
    float s[2 * kV][4];
    rec_sums<2 * kV>(a.part_glu, stride, i0 + u, count, off, s);
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int e = e0 + kCThreads * v, b = e / kQuads, n = u * kHalf + 4 * (e % kQuads);
      if (e >= B * kQuads || n >= FF) continue;
      const float4 g4 = *reinterpret_cast<const float4*>(gs + n);
      const float4 u4 = *reinterpret_cast<const float4*>(us + n);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float g = s[v][k] * gv[k], uu = s[kV + v][k] * uv[k];
        a.h[static_cast<size_t>(b) * FF + perm128(n + k)] =
            __float2bfloat16_rn(div_rn(g, 1.f + expf(-g)) * uu);
      }
    }
  }
}

// the megakernel's qkv phase finished, every block a share: a group of D / 8
// lanes a (batch row, head), a lane the head's columns 4 q .. 4 q + 3 and
// the same D / 2 on (its rope partners). Bias, rope of q and k in float32
// (rotate-half), q out; this step's K (rope'd) or V row to int8 with a
// float32 scale, stored in bf16.
template <int D, int NT>
__device__ __forceinline__ void qkv_finish(const StreamArgs& a, int l, const Plan& p) {
  using T = StreamTile<NT>;
  constexpr int kL = D / 8;
  const int B = a.B, QKV = a.QKV, nq = a.QD / D;  // q heads, then KVH k heads, KVH v heads
  const int heads = QKV / D, total = B * heads * kL;
  const float* qs = a.qs + static_cast<size_t>(l) * QKV;
  const __nv_bfloat16* bias = a.bias + static_cast<size_t>(l) * QKV;
  // whole warps to the end, so the groups' shuffles see every lane
  const int bound = (total + 31) & ~31;
  for (int e = blockIdx.x * kSThreads + threadIdx.x; e < bound; e += gridDim.x * kSThreads) {
    const int pr = min(e, total - 1) / kL, q = e % kL;
    const int b = pr / heads, hd = pr % heads, col0 = hd * D;
    const bool ok = e < total;
    // x[0][k] is column 4 q + k of the head, x[1][k] the one D / 2 on
    float s[2][4], x[2][4], o[2][4];
    col_sums<T::kUnit>(a.part_qkv, p, B, b, col0 + 4 * q, s[0]);
    col_sums<T::kUnit>(a.part_qkv, p, B, b, col0 + 4 * q + D / 2, s[1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = col0 + 4 * q + hh * (D / 2) + k;
        x[hh][k] = round_bf(s[hh][k] * qs[c] + bf(bias[c]));
      }
    }
    const float* cs = a.cos + static_cast<size_t>(b) * D + 4 * q;
    const float* sn = a.sin + static_cast<size_t>(b) * D + 4 * q;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[0][k] = round_bf(x[0][k] * cs[k] + (-x[1][k]) * sn[k]);
      o[1][k] = round_bf(x[1][k] * cs[D / 2 + k] + x[0][k] * sn[D / 2 + k]);
    }
    const bool is_k = hd >= nq && hd < nq + a.KVH;
    float amax = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int k = 0; k < 4; ++k) amax = fmaxf(amax, fabsf(is_k ? o[hh][k] : x[hh][k]));
    }
#pragma unroll
    for (int sh = kL / 2; sh > 0; sh >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, sh));
    }
    if (!ok) continue;
    if (hd < nq) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        st_bf4(a.qr + static_cast<size_t>(b) * a.QD + col0 + 4 * q + hh * (D / 2), o[hh]);
      }
      continue;
    }
    const int kvh = hd - nq - (is_k ? 0 : a.KVH);
    const float scl = fmaxf(amax * (1.f / 127.f), 1e-8f);
    int8_t* dst = (is_k ? a.nk : a.nv) + (static_cast<size_t>(b) * a.KVH + kvh) * D + 4 * q;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      char4 c;
      int8_t* cb = reinterpret_cast<int8_t*>(&c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float y = is_k ? o[hh][k] : x[hh][k];
        cb[k] = static_cast<int8_t>(fminf(fmaxf(rintf(div_rn(y, scl)), -127.f), 127.f));
      }
      *reinterpret_cast<char4*>(dst + hh * (D / 2)) = c;
    }
    if (q == 0) (is_k ? a.nks : a.nvs)[b * a.KVH + kvh] = __float2bfloat16_rn(scl);
  }
}

// dense_stream's qkv output rows of layer l, every block a share: a warp
// 128 columns of a row, four a lane
template <int NT>
__device__ __forceinline__ void qkv_out_rows(const StreamArgs& a, int l, const Plan& p) {
  using T = StreamTile<NT>;
  const int lane = threadIdx.x & 31, B = a.B, QKV = a.QKV, groups = (QKV + 127) / 128;
  const float* qs = a.qs + static_cast<size_t>(l) * QKV;
  const __nv_bfloat16* bias = a.bias + static_cast<size_t>(l) * QKV;
  __nv_bfloat16* out = a.qkvout + static_cast<size_t>(l) * B * QKV;
  for (int item = blockIdx.x * kSWarps + (threadIdx.x >> 5); item < B * groups;
       item += gridDim.x * kSWarps) {
    const int b = item / groups, n = (item % groups) * 128 + 4 * lane;
    if (n >= QKV) continue;
    float s[4];
    col_sums<T::kUnit>(a.part_qkv, p, B, b, n, s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (n + k < QKV) {
        out[static_cast<size_t>(b) * QKV + n + k] =
            __float2bfloat16_rn(s[k] * qs[n + k] + bf(bias[n + k]));
      }
    }
  }
}

// xn row b = bf16(x * inv * w) in perm128 order, by one warp; inv =
// 1 / sqrt(mean(x^2) + eps) from the row's 128-column groups' sums of
// squares (lane j the groups j, j + 32, ..., then the warp's butterfly);
// x the bf16 x, or the float32 xf
__device__ __forceinline__ void norm_row(const StreamArgs& a, int b, const __nv_bfloat16* w,
                                         bool from_f32) {
  constexpr int kB = 7;  // four-column chunks a lane has in flight
  const int lane = threadIdx.x & 31, H = a.H, B = a.B, groups = H / 128;
  float ss = 0.f;
  for (int j = lane; j < groups; j += 32) ss += __ldcg(a.ssq + static_cast<size_t>(j) * B + b);
  const float inv = rsqrt_nr(div_rn(warp_sum(ss), static_cast<float>(H)) + a.eps);
  const size_t row = static_cast<size_t>(b) * H;
  for (int i0 = 4 * lane; i0 < H; i0 += 128 * kB) {
    float xv[kB][4], wv[kB][4];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int i = min(i0 + 128 * k, H - 4);
      if (from_f32) {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(a.xf + row + i));
        xv[k][0] = f.x, xv[k][1] = f.y, xv[k][2] = f.z, xv[k][3] = f.w;
      } else {
        ld_bf4(a.x + row + i, xv[k]);
      }
      ld_bf4(w + i, wv[k]);
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int i = i0 + 128 * k;
      if (i >= H) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a.xn[row + perm128(i + e)] = __float2bfloat16_rn(xv[k][e] * inv * wv[k][e]);
      }
    }
  }
}

// the row phases' kinds
constexpr int kRowsPrologue = 0;  // before layer 0: x = x0
constexpr int kRowsO = 1;         // x32 = x + o * os, x = bf16(x32), xf = x32
constexpr int kRowsDown = 2;      // x = bf16(x + down * ds) (after the last layer: xout)

// A row phase, every block a share: a warp an item (row b, 128-column group
// cg), a lane the columns cg 128 + 4 lane .. + 3: the residual of the
// product's records (Plan p; none before layer 0), the group's sum of
// squares, then the row's counter; the warp that completes a row normalises
// it with w (w null: after the last layer, xout written in place of x).
// attn_in (dense_stream: the next layer's attention output) is copied into
// attn in perm128 order alongside.
template <int NT>
__device__ __forceinline__ void rows(const StreamArgs& a, int kind, int l, const Plan& p,
                                     const __nv_bfloat16* w, const __nv_bfloat16* attn_in) {
  using T = StreamTile<NT>;
  const int lane = threadIdx.x & 31, H = a.H, B = a.B, groups = H / 128;
  for (int item = blockIdx.x * kSWarps + (threadIdx.x >> 5); item < B * groups;
       item += gridDim.x * kSWarps) {
    const int b = item / groups, cg = item % groups, n = cg * 128 + 4 * lane;
    const size_t at = static_cast<size_t>(b) * H + n;
    float v[1][4];
    if (kind == kRowsPrologue) {
      ld_bf4(a.x0 + at, v[0]);
    } else {
      float s[4], xv[4];
      col_sums<T::kUnit>(a.part_h, p, B, b, n, s);
      ld_bf4(a.x + at, xv);
      const float4 f = *reinterpret_cast<const float4*>((kind == kRowsO ? a.os : a.ds) +
                                                        static_cast<size_t>(l) * H + n);
      const float sc[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = xv[e] + s[e] * sc[e];
        v[0][e] = kind == kRowsO ? y : round_bf(y);
      }
    }
    if (attn_in != nullptr) {
      float av[4];
      ld_bf4(attn_in + at, av);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a.attn[static_cast<size_t>(b) * H + perm128(n + e)] = __float2bfloat16_rn(av[e]);
      }
    }
    if (w == nullptr) {
      st_bf4(a.xout + at, v[0]);
      continue;
    }
    st_bf4(a.x + at, v[0]);
    if (kind == kRowsO) {
      *reinterpret_cast<float4*>(a.xf + at) = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    }
    const float ss = warp_sum(lane_ssq<1>(v));
    // every lane fences its own writes before lane 0 counts the group in,
    // and after (as the last warp) before it reads the row: on the card a
    // fence by one thread after a barrier did not publish the other
    // threads' writes (the megakernel's bits moved between calls)
    if (lane == 0) a.ssq[static_cast<size_t>(cg) * B + b] = ss;
    __threadfence();
    __syncwarp();
    int done = 0;
    if (lane == 0) done = atomicAdd(a.rowcnt + b, 1) == groups - 1;
    done = __shfl_sync(0xffffffffu, done, 0);
    __threadfence();
    if (done) {
      norm_row(a, b, w, kind == kRowsO);
      if (lane == 0) a.rowcnt[b] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// product phases: out[r, n] = sum_k A[r, k] * W[n, k]
// ---------------------------------------------------------------------------

// the producer's wait for a free stage and the consumers' wait for a landed
// one (bench/stream_trace.py times both)
__device__ __forceinline__ void wait_free(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
}
__device__ __forceinline__ void wait_landed(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
}

// What a product phase reads: its weight maps (W2: gate/up's up rows), its
// activation map, the layer and the product's N and K; glu: gate/up
struct Phase {
  const CUtensorMap* W;
  const CUtensorMap* W2;
  const CUtensorMap* A;
  int l, N, K;
  bool glu;
};

// product phase ph of layer l: 0 qkv, 1 o, 2 gate/up, 3 down
__device__ __forceinline__ Phase phase_of(const StreamMaps& maps, const StreamArgs& a, int l,
                                          int ph) {
  switch (ph) {
    case 0: return Phase{&maps.wqkv, nullptr, &maps.xn, l, a.QKV, a.H, false};
    case 1: return Phase{&maps.wo, nullptr, &maps.attn, l, a.H, a.QD, false};
    case 2: return Phase{&maps.wg, &maps.wu, &maps.xn, l, a.FF, a.H, true};
    default: return Phase{&maps.wd, nullptr, &maps.h, l, a.H, a.FF, false};
  }
}

template <int NT>
__device__ __forceinline__ Plan plan_of(const Phase& ph) {
  using T = StreamTile<NT>;
  return Plan(ph.N, ph.K, ph.glu ? T::kUnit / 2 : T::kUnit, T::kKT, gridDim.x);
}

// The producer lane's TMA loads of pair x of a phase into stage st: the
// weight planes and/or the activation planes
template <int NT>
__device__ __forceinline__ void load_pair(unsigned char* st, uint64_t* bar, const Phase& ph,
                                          const Plan& p, int x, bool weights, bool acts,
                                          uint64_t policy) {
  using T = StreamTile<NT>;
  const int kRows = ph.glu ? T::kUnit / 2 : T::kUnit;
  const int u = x / p.tiles, kt = x % p.tiles;
#pragma unroll
  for (int pl = 0; pl < T::kPlanes; ++pl) {
    const int k0 = (kt * T::kPlanes + pl) * 128;
    unsigned char* w = st + pl * T::kWPlane;
    if (weights) {
      tma_load_3d_hint(w, ph.W, bar, k0, u * kRows, ph.l, policy);
      if (ph.glu) tma_load_3d_hint(w + kRows * 128, ph.W2, bar, k0, u * kRows, ph.l, policy);
    }
    if (acts) {
      unsigned char* act = st + T::kPlanes * T::kWPlane + 2 * pl * T::kAPlane;
      tma_load_2d(act, ph.A, bar, k0, 0);
      tma_load_2d(act + T::kAPlane, ph.A, bar, k0 + 64, 0);
    }
  }
}

// By the producer lane, before the barrier that the next product phase
// waits for: the weight planes of that phase's first pairs in this block's
// range (as many as the ring holds), each stage's whole transaction expected
// (its activations follow once the barrier has passed). Returns how many.
template <int NT>
__device__ __forceinline__ int prefetch(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                     const Phase& ph, int it) {
  using T = StreamTile<NT>;
  constexpr int S = T::kStages;
  const Plan p = plan_of<NT>(ph);
  const int lo = p.lo(blockIdx.x), n = min(p.lo(blockIdx.x + 1) - lo, S);
  const uint64_t stream = l2_evict_first();  // the weights are read once a call
  for (int j = 0; j < n; ++j, ++it) {
    const int s = it % S;
    wait_free(&empty[s], ((it / S) & 1) ^ 1);
    mbar_expect_tx(&full[s], T::kStage);
    load_pair<NT>(ring + s * T::kStage, &full[s], ph, p, lo + j, true, false, stream);
  }
  return n;
}

// The consumers' pairs [x, x_end) of one unit from the ring (`it` the
// ring's stages used before them; the return value after) into the unit's
// float32 record `rec` (B x kUnit). No call in here: a call where wgmma may
// be in flight makes ptxas serialize every wgmma of the kernel, so the
// whole kernel is inlined and calls nothing.
template <int NT>
__device__ __forceinline__ int consume_unit(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                         int x, int x_end, int it, float* rec, int B) {
  using T = StreamTile<NT>;
  constexpr int S = T::kStages, NB = T::NB;
  // warpgroup wg takes the unit's rows wg 64 .. + 64 (gate/up: wg 0 the gate
  // rows, wg 1 the up rows), warp w of it the rows 16 w + g and + 8
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (; x < x_end; ++x, ++it) {
    const int s = it % S;
    wait_landed(&full[s], (it / S) & 1);
    const unsigned char* st = ring + s * T::kStage;
#pragma unroll
    for (int pl = 0; pl < T::kPlanes; ++pl) {
      // this warp's rows of the plane: 16 bytes of a 128-byte swizzled row a
      // lane, chunk (2t + grp) ^ g of rows with g = row % 8
      const unsigned char* wrow = st + pl * T::kWPlane + (wg * 64 + 16 * w + g) * 128;
      const uint32_t act = smem_u32(st + T::kPlanes * T::kWPlane + 2 * pl * T::kAPlane);
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        uint32_t af[4][4];
        const int chunk = ((2 * t + grp) ^ g) << 4;
        const uint4 r0 = *reinterpret_cast<const uint4*>(wrow + chunk);
        const uint4 r1 = *reinterpret_cast<const uint4*>(wrow + 8 * 128 + chunk);
        const uint32_t lo4[4] = {r0.x, r0.y, r0.z, r0.w}, hi4[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          // bytes 4 s4 .. 4 s4 + 3 of rows g and g + 8: columns 2t, 2t + 1,
          // 2t + 8, 2t + 9 of k-step 4 grp + s4
          const uint32_t u0 = lo4[s4] ^ 0x80808080u, u1 = hi4[s4] ^ 0x80808080u;
          af[s4][0] = upper_halves(biased_byte(u0, 0), biased_byte(u0, 1));
          af[s4][1] = upper_halves(biased_byte(u1, 0), biased_byte(u1, 1));
          af[s4][2] = upper_halves(biased_byte(u0, 2), biased_byte(u0, 3));
          af[s4][3] = upper_halves(biased_byte(u1, 2), biased_byte(u1, 3));
        }
        wgmma_fence();
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          // k-step 4 grp + s4: 32 bytes into activation plane grp's rows
          const uint64_t desc = gmma_desc(act + grp * T::kAPlane + 32 * s4, 16, 1024, 1);
          wgmma_rs<NB>(acc, af[s4], desc, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();  // the registers of af are rewritten next
        reg_fence(acc);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const int n = wg * 64 + 16 * w + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = 8 * j + 2 * t + e;
      if (b < B) {
        rec[b * T::kUnit + n] = acc[4 * j + e];
        rec[b * T::kUnit + n + 8] = acc[4 * j + 2 + e];
      }
    }
  }
  return it;
}

// One product phase over the block's range of (unit, k tile) pairs; `it`
// counts the ring's stages used before it (the producer's and the
// consumers' counts agree), the return value after; the producer lane had
// issued the weights of the first `pre` pairs (prefetch). Gate/up takes W
// (gate) and W2 (up) with N = FF h columns, kUnit / 2 a unit, and each
// unit's last block to finish writes its h; the others W alone, kUnit
// columns a unit, their records finished in the next phase.
template <int NT>
__device__ __forceinline__ int products(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        const StreamArgs& a, const Phase& ph, float* part,
                                        int it, int pre) {
  using T = StreamTile<NT>;
  constexpr int S = T::kStages;
  const Plan p = plan_of<NT>(ph);
  const int lo = p.lo(blockIdx.x), hi = p.lo(blockIdx.x + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ int is_last;

  if (warp == kProducerWarp) {
    if (lane == 0) {
      const uint64_t stream = l2_evict_first();  // the weights are read once a call
      fence_proxy_async_global();  // the activations were written in this call
      for (int x = lo; x < hi; ++x, ++it) {
        const int s = it % S;
        const bool fresh = x - lo >= pre;
        if (fresh) {
          wait_free(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kStage);
        }
        load_pair<NT>(ring + s * T::kStage, &full[s], ph, p, x, fresh, true, stream);
      }
      return it;
    }
    return it + (hi - lo);
  }
  if (warp > kProducerWarp) return it + (hi - lo);

  for (int x = lo; x < hi;) {
    const int u = x / p.tiles, x_end = min(hi, (u + 1) * p.tiles);
    // the unit's pairs in this block's range, into its record: slot block + u
    it = consume_unit<NT>(ring, full, empty, x, x_end, it,
                          part + static_cast<size_t>(blockIdx.x + u) * a.B * T::kUnit, a.B);
    x = x_end;
    if (!ph.glu) continue;
    // the unit's last block to finish writes its h, then resets its counter;
    // every thread fences its record's writes before the count, and its
    // reads after it (as in rows())
    __threadfence();
    named_sync(1, kCThreads);
    if (threadIdx.x == 0) {
      const int n_blocks = p.block_of((u + 1) * p.tiles - 1) - p.block_of(u * p.tiles) + 1;
      is_last = atomicAdd(a.cnt_glu + u, 1) == n_blocks - 1;
    }
    named_sync(1, kCThreads);
    __threadfence();
    if (is_last) {
      epi_glu<NT>(a, ph.l, p, u);
      if (threadIdx.x == 0) a.cnt_glu[u] = 0;
    }
  }
  return it;
}

// ---------------------------------------------------------------------------
// attention phase (megakernel): kernel #3's body, one walker a block
// ---------------------------------------------------------------------------

template <int D, int G>
__host__ __device__ constexpr int walker_bytes() {
  return (QuantTma<D, G>::kOffLens + 1023) / 1024 * 1024;
}

// The block's walker over the layer's (slot, kv head, run) items: consumer
// warpgroup 0 and producer warp 8, the other warps idle (two walkers a
// block, in turns or side by side, were slower or gave bits that moved
// between calls: PERF.md)
template <int D, int G>
__device__ __forceinline__ void attend(const StreamArgs& a, int l, unsigned char* region,
                                    int* ints) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, B = a.B;
  int* lvl = ints;                      // [n_runs + 1]
  int* lens = lvl + kQMaxPieces + 1;    // [B]
  int* nruns = lens + kMaxBatch;        // [B]
  const int run = a.attn_run / kQRows, n_runs = a.attn_runs;
  if (threadIdx.x == 0) {
    quant_init<D, G>(region);
    fence_barrier_init();
  }
  for (int b = threadIdx.x; b < B; b += kSThreads) {
    const int len = min(max(a.lens[b], 0), a.M - 1);
    lens[b] = len;
    nruns[b] = (max(1, (len + kQRows - 1) / kQRows) + run - 1) / run;
  }
  __syncthreads();
  if (warp == 0) item_offsets(nruns, B, a.KVH, n_runs, lvl, lane);
  __syncthreads();
  const int n_items = lvl[n_runs];
  const QuantArgs q{a.qr, a.nk, a.nv, a.nks, a.nvs, a.kc, a.vc, a.ksc, a.vsc, a.attn,
                    a.part_attn, a.cnt_attn, B, a.KVH, a.M, l, run, n_runs,
                    a.scale * kLog2e};
  if (warp < 4) {
    quant_consume<D, G, true>(region, q, lens, nruns, lvl, n_items, blockIdx.x, gridDim.x,
                              threadIdx.x & 127, 2);
  } else if (warp == kProducerWarp) {
    fence_proxy_async_global();  // q and the new rows were written in this call
    quant_produce<D, G>(region, q, lens, nruns, lvl, n_items, blockIdx.x, gridDim.x, lane);
  }
  // the products' TMA writes next reuse what these threads wrote, and the
  // walker's barriers' bytes
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) quant_inval<D, G>(region);
}

// ---------------------------------------------------------------------------
// the kernel: D == 0 is dense_stream, otherwise the megakernel
// ---------------------------------------------------------------------------

// the bytes the products' ring and the attention's walker share
template <int NT, int D, int G>
__host__ __device__ constexpr int union_bytes() {
  constexpr int ring = StreamTile<NT>::kStages * StreamTile<NT>::kStage;
  constexpr int att = D == 0 ? 0 : walker_bytes<D == 0 ? 16 : D, G == 0 ? 2 : G>();
  return ring > att ? ring : att;
}

template <int NT, int D, int G>
__global__ void __launch_bounds__(kSThreads, 1)
    stream_kernel(const __grid_constant__ StreamMaps maps, const __grid_constant__ StreamArgs a) {
  extern __shared__ __align__(128) unsigned char stream_smem[];
  unsigned char* smem = stream_smem + ((1024 - (smem_u32(stream_smem) & 1023)) & 1023);
  using T = StreamTile<NT>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + union_bytes<NT, D, G>());
  uint64_t* empty = full + kMaxStages;
  int* ints = reinterpret_cast<int*>(empty + kMaxStages);
  const int H = a.H, QD = a.QD, B = a.B;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  // the counters start at 0 (the barrier below orders this before any use:
  // the prologue's rows count on theirs); each user resets its own
  for (int i = blockIdx.x * kSThreads + threadIdx.x; i < a.n_cnt; i += gridDim.x * kSThreads) {
    a.cnt[i] = 0;
  }
  // the ring's stages used so far; the pairs whose weights the producer
  // lane issued ahead of the next product phase: at 8 and 32 batch rows
  // (measured in turns on the card: faster at B = 4, slower at B = 80,
  // where the weights loaded during the rows phases slow them)
  int it = 0, pre = 0;
  const bool producer = T::NB <= 32 && threadIdx.x == kProducerWarp * 32;
  // the plans whose records the row phases finish (the same every layer)
  const Plan pq = plan_of<NT>(phase_of(maps, a, 0, 0)), po = plan_of<NT>(phase_of(maps, a, 0, 1)),
             pd = plan_of<NT>(phase_of(maps, a, 0, 3));
  if (producer) pre = prefetch<NT>(smem, full, empty, phase_of(maps, a, 0, 0), it);
  grid_sync(a.bar);
  rows<NT>(a, kRowsPrologue, 0, pd, a.ln1, D == 0 ? a.attn_in : nullptr);
  grid_sync(a.bar);
  // each layer's four product phases at one call site (the kernel is all
  // inlined: one copy of the products' loop), the other phases before them
  for (int l = 0; l < a.L; ++l) {
    for (int ph = 0; ph < 4; ++ph) {
      if (ph == 1) {
        if constexpr (D != 0) {  // dense_stream: o in qkv's phase
          grid_sync(a.bar);
          qkv_finish<D, NT>(a, l, pq);
          grid_sync(a.bar);
          attend<D, G>(a, l, smem, ints);
          __syncthreads();  // the walker is done with the ring's bytes
          if (producer) pre = prefetch<NT>(smem, full, empty, phase_of(maps, a, l, 1), it);
          grid_sync(a.bar);
        }
      } else if (ph == 2) {
        if (producer) pre = prefetch<NT>(smem, full, empty, phase_of(maps, a, l, 2), it);
        grid_sync(a.bar);
        if constexpr (D == 0) qkv_out_rows<NT>(a, l, pq);
        rows<NT>(a, kRowsO, l, po, a.ln2 + static_cast<size_t>(l) * H, nullptr);
        grid_sync(a.bar);
      } else if (ph == 3) {
        if (producer) pre = prefetch<NT>(smem, full, empty, phase_of(maps, a, l, 3), it);
        grid_sync(a.bar);
      }
      it = products<NT>(smem, full, empty, a, phase_of(maps, a, l, ph),
                        ph == 0 ? a.part_qkv : ph == 2 ? a.part_glu : a.part_h, it, pre);
      pre = 0;
    }
    const bool next = l + 1 < a.L;
    if (producer && next) pre = prefetch<NT>(smem, full, empty, phase_of(maps, a, l + 1, 0), it);
    grid_sync(a.bar);
    rows<NT>(a, kRowsDown, l, pd, next ? a.ln1 + static_cast<size_t>(l + 1) * H : nullptr,
             D == 0 && next ? a.attn_in + static_cast<size_t>(l + 1) * B * QD : nullptr);
    if (next) grid_sync(a.bar);
  }
}  // stream_kernel

// ---------------------------------------------------------------------------
// host side: shared memory, grid, workspace layout, tensor maps, launch
// ---------------------------------------------------------------------------

template <int NT, int D, int G>
size_t smem_bytes() {
  // + 1024: the base is rounded up to the swizzle atoms' alignment
  return 1024 + union_bytes<NT, D, G>() + 2 * kMaxStages * 8 +
         (kQMaxPieces + 1 + 2 * kMaxBatch) * 4;
}

// co-resident blocks of the instance: occupancy x SMs
template <int NT, int D, int G>
cudaError_t grid_of(int device, int* grid) {
  const size_t smem = smem_bytes<NT, D, G>();
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

// Cache rows per attention item: kernel #3's resident-run rule
// (ops/decode_attention.py resident_run), over the grid's walkers (one a
// block): the shortest power-of-two run from 256 to 1,024 rows whose B *
// KVH * ceil(M / run) items fit the walkers (one a walker), else 1,024;
// longer if a slot would have more runs than the last item can merge.
inline int attn_run_rows(int B, int KVH, int M, int walkers) {
  int run = 256;
  while (run < 1024 && static_cast<long long>(B) * KVH * ((M + run - 1) / run) > walkers) {
    run *= 2;
  }
  while ((M + run - 1) / run > kQMaxPieces) run *= 2;
  return run;
}

struct Layout {
  size_t x, xf, ssq, xn, h, attn, qr, nk, nv, nks, nvs, pq, ph, pg, pa, cnt, total;
  int n_glu, n_attn, attn_run, attn_runs;
  bool fits;  // every plan's pairs times the grid in 32 bits (Plan)
};

template <int NT, int D, int G>
Layout layout(int B, int H, int QKV, int FF, int QD, int KVH, int M, int grid) {
  using T = StreamTile<NT>;
  constexpr bool kMega = D != 0;
  using Q = QuantTma<kMega ? D : 16, kMega ? G : 2>;
  Layout o;
  size_t off = 0;
  auto take = [&](size_t n) {
    const size_t at = off;
    off += (n + 255) & ~static_cast<size_t>(255);
    return at;
  };
  const size_t rec = static_cast<size_t>(B) * T::kUnit * 4;
  const Plan pq(QKV, H, T::kUnit, T::kKT, grid), ph(H, std::max(QD, FF), T::kUnit, T::kKT, grid),
      pg(FF, H, T::kUnit / 2, T::kKT, grid);
  const Plan po(H, QD, T::kUnit, T::kKT, grid), pd(H, FF, T::kUnit, T::kKT, grid);
  o.fits = static_cast<long long>(std::max({pq.total, po.total, pg.total, pd.total})) * grid <
           (1LL << 31);
  o.n_glu = pg.units;
  o.n_attn = kMega ? B * KVH : 0;
  o.attn_run = kMega ? attn_run_rows(B, KVH, M, grid) : 0;
  o.attn_runs = kMega ? (M + o.attn_run - 1) / o.attn_run : 0;
  o.x = take(static_cast<size_t>(B) * H * 2);
  o.xf = take(static_cast<size_t>(B) * H * 4);
  o.ssq = take(static_cast<size_t>(H / 128) * B * 4);
  o.xn = take(static_cast<size_t>(B) * H * 2);
  o.h = take(static_cast<size_t>(B) * FF * 2);
  o.attn = take(static_cast<size_t>(B) * QD * 2);
  o.qr = take(kMega ? static_cast<size_t>(B) * QD * 2 : 0);
  o.nk = take(kMega ? static_cast<size_t>(B) * KVH * D : 0);
  o.nv = take(kMega ? static_cast<size_t>(B) * KVH * D : 0);
  o.nks = take(kMega ? static_cast<size_t>(B) * KVH * 2 : 0);
  o.nvs = take(kMega ? static_cast<size_t>(B) * KVH * 2 : 0);
  o.pq = take((grid + pq.units) * rec);
  o.ph = take((grid + ph.units) * rec);
  o.pg = take((grid + pg.units) * rec);
  o.pa = take(kMega ? static_cast<size_t>(B) * KVH * o.attn_runs * Q::kPartial * 4 : 0);
  o.cnt = take(static_cast<size_t>(o.n_glu + o.n_attn + B) * 4);
  o.total = off;
  return o;
}

// (L, N, K) int8 weights: boxes of 128 k by `rows` rows of one layer
inline CUresult encode_weights(CUtensorMap* map, const int8_t* base, int L, int N, int K,
                               int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K),
                                 static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(K)};
  const cuuint32_t box[3] = {128, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// (B, K) bf16 rows: boxes of 64 columns by NB rows (rows past B read zeros)
inline CUresult encode_rows(CUtensorMap* map, const void* base, int B, int K, int NB) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(NB)};
  const cuuint32_t step[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int NT, int D, int G>
cudaError_t launch(StreamArgs a, void* work, int device, cudaStream_t stream) {
  using T = StreamTile<NT>;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  int grid = 0;
  cudaError_t err = grid_of<NT, D, G>(device, &grid);
  if (err != cudaSuccess) return err;
  const Layout o = layout<NT, D, G>(a.B, a.H, a.QKV, a.FF, a.QD, a.KVH, a.M, grid);
  if (!o.fits) return cudaErrorInvalidValue;
  char* w = static_cast<char*>(work);
  a.x = reinterpret_cast<__nv_bfloat16*>(w + o.x);
  a.xf = reinterpret_cast<float*>(w + o.xf);
  a.ssq = reinterpret_cast<float*>(w + o.ssq);
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
  a.cnt_glu = a.cnt;
  a.cnt_attn = a.cnt_glu + o.n_glu;
  a.rowcnt = a.cnt_attn + o.n_attn;
  a.n_cnt = o.n_glu + o.n_attn + a.B;
  a.attn_run = o.attn_run;
  a.attn_runs = o.attn_runs;
  StreamMaps maps;
  CUresult r = encode_weights(&maps.wqkv, a.wqkv, a.L, a.QKV, a.H, T::kUnit);
  if (r == CUDA_SUCCESS) r = encode_weights(&maps.wo, a.wo, a.L, a.H, a.QD, T::kUnit);
  if (r == CUDA_SUCCESS) r = encode_weights(&maps.wg, a.wg, a.L, a.FF, a.H, T::kUnit / 2);
  if (r == CUDA_SUCCESS) r = encode_weights(&maps.wu, a.wu, a.L, a.FF, a.H, T::kUnit / 2);
  if (r == CUDA_SUCCESS) r = encode_weights(&maps.wd, a.wd, a.L, a.H, a.FF, T::kUnit);
  if (r == CUDA_SUCCESS) r = encode_rows(&maps.xn, a.xn, a.B, a.H, T::NB);
  if (r == CUDA_SUCCESS) r = encode_rows(&maps.h, a.h, a.B, a.FF, T::NB);
  if (r == CUDA_SUCCESS) r = encode_rows(&maps.attn, a.attn, a.B, a.QD, T::NB);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  void* args[] = {&maps, &a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(stream_kernel<NT, D, G>),
                                    dim3(grid), dim3(kSThreads), args, smem_bytes<NT, D, G>(),
                                    stream);
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
    const cudaError_t err = grid_of<NT, DD, GG>(device, &grid);
    if (err != cudaSuccess) return err;
    const Layout o = layout<NT, DD, GG>(B, H, QKV, FF, QD, KVH, M, grid);
    *bytes = static_cast<long long>(o.total);
    return o.fits ? cudaSuccess : cudaErrorInvalidValue;
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
  return B >= 1 && B <= kMaxBatch && H % 128 == 0 && FF % 128 == 0 && QD % 128 == 0 &&
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
