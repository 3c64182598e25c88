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
// at a small batch they are bound by device-memory bytes. The products run
// in float32 on the CUDA cores: 2 * B * (weights) flops, so from a batch of
// a few tens on the arithmetic bounds them.
//
// Design. The TPU kernel walks a sequential grid (layers, tiles) and carries
// the hidden state in VMEM. Here the grid is as many blocks as are
// co-resident (occupancy x SMs), launched with cudaLaunchCooperativeKernel;
// phases that need the whole previous phase's output are separated by a
// grid-wide barrier (a sense-reversing counter in global memory). Per layer:
//
//   A  rows: residual of the previous layer's down product, rms(ln1)
//   B  qkv products (split over K)            [dense: and the o products]
//   C  per (slot, kv head): bias, rope, int8 K/V quantization, append at
//      cache_len, attention over [0, cache_len), new row folded in last
//   D  o products (split over K)
//   E  rows: o residual in float32, rms(ln2) of that sum, x rounded
//      [dense: the qkv output rows]
//   F  gate/up products, h = bf16(silu(g) * u) for the whole FF
//   G  down products (split over K)
//
// so seven barriers a layer (five for dense_stream). A product phase deals
// out units of 64 output columns x a range of 128-row K tiles to the blocks;
// each block stages the int8 weight tile (one thread per 32 bytes of a
// column's row, prefetched into registers during the previous tile's
// products) and the activations' K tile in shared memory as float32, and
// each thread accumulates 2 columns x RPT rows. Split-K partial sums go to a
// float32 workspace and are summed in a fixed order by the phase that
// consumes them: no float atomics, so the same inputs give the same bits on
// every call (for a given grid size). Scratch written during the kernel is
// read with __ldcg (L2), never through the non-coherent L1.
#include <algorithm>

#include "common.cuh"

namespace karanta {

constexpr int kSThreads = 256;
constexpr int kSWarps = kSThreads / 32;
constexpr int kSK = 128;             // K rows per weight tile
constexpr int kSN = 64;              // output columns per unit
constexpr int kXsPitch = kSK + 4;    // floats per staged activation row
constexpr int kSChunk = 128;         // cache rows staged per attention chunk
constexpr int kSLanesPerRow = 8;     // lanes sharing one int8 cache row

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
  float* part_qkv;               // (splits, B, QKV)
  float* part_h;                 // (splits, B, H): o, then down
  unsigned* bar;                 // [count, generation], count 0 at launch
  int B, H, QKV, FF, L, QD, KVH, M;
  float scale, eps;
};

// How a product of N columns over K rows is split: units of kSN columns,
// each K range a whole number of tiles, about one item per block.
__host__ __device__ inline void split_plan(int N, int K, int grid, int* count,
                                           int* per) {
  const int units = (N + kSN - 1) / kSN, tiles = K / kSK;
  int s = (grid + units - 1) / units;
  s = s < 1 ? 1 : (s > tiles ? tiles : s);
  *per = (tiles + s - 1) / s;
  *count = (tiles + *per - 1) / *per;
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
// product phases: out[r, n] = sum_k A[r, k] * W[n, k] over the item's K range
// ---------------------------------------------------------------------------

template <int RPT, bool kGlu>
__device__ __noinline__ void products(float* smem, const __nv_bfloat16* A, int lda,
                                      const int8_t* W, const int8_t* W2, int N, int K,
                                      int B, float* part, const float* s1,
                                      const float* s2, __nv_bfloat16* hout) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int units = (N + kSN - 1) / kSN;
  int count = 1, per = K / kSK;
  if constexpr (!kGlu) split_plan(N, K, gridDim.x, &count, &per);
  const int tiles = K / kSK;
  float* xs = smem;                            // (8 * RPT) x kXsPitch
  float* ws = xs + 8 * RPT * kXsPitch;         // kSK x kSN
  float* ws2 = ws + kSK * kSN;
  const int scol = tid % kSN, skq = tid / kSN; // staging: 32 bytes of a row

  for (int item = blockIdx.x; item < units * count; item += gridDim.x) {
    const int unit = item / count, split = item % count;
    const int n0 = unit * kSN;
    const int kt0 = split * per, kt1 = min(kt0 + per, tiles);
    const bool col_ok = n0 + scol < N;
    const size_t wrow = static_cast<size_t>(n0 + scol) * K + skq * 32;
    uint4 pre[2], pre2[2];
    auto fetch = [&](int kt) {
      const uint4* p = reinterpret_cast<const uint4*>(W + wrow + kt * kSK);
      pre[0] = col_ok ? __ldg(p) : make_uint4(0, 0, 0, 0);
      pre[1] = col_ok ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
      if constexpr (kGlu) {
        const uint4* p2 = reinterpret_cast<const uint4*>(W2 + wrow + kt * kSK);
        pre2[0] = col_ok ? __ldg(p2) : make_uint4(0, 0, 0, 0);
        pre2[1] = col_ok ? __ldg(p2 + 1) : make_uint4(0, 0, 0, 0);
      }
    };
    float acc[RPT][2], acc2[kGlu ? RPT : 1][2];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      acc[i][0] = acc[i][1] = 0.f;
      if constexpr (kGlu) acc2[i][0] = acc2[i][1] = 0.f;
    }
    fetch(kt0);
    for (int kt = kt0; kt < kt1; ++kt) {
      __syncthreads();  // the previous tile's products are done with smem
      {
        const int8_t* b = reinterpret_cast<const int8_t*>(pre);
#pragma unroll
        for (int j = 0; j < 32; ++j) ws[(skq * 32 + j) * kSN + scol] = static_cast<float>(b[j]);
        if constexpr (kGlu) {
          const int8_t* b2 = reinterpret_cast<const int8_t*>(pre2);
#pragma unroll
          for (int j = 0; j < 32; ++j) ws2[(skq * 32 + j) * kSN + scol] = static_cast<float>(b2[j]);
        }
      }
      for (int c = tid; c < 8 * RPT * (kSK / 8); c += kSThreads) {
        const int r = c / (kSK / 8), kk = (c % (kSK / 8)) * 8;
        float v[8];
        if (r < B) {
          const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
              A + static_cast<size_t>(r) * lda + kt * kSK + kk));
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = bf(e[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(xs + r * kXsPitch + kk);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
      if (kt + 1 < kt1) fetch(kt + 1);  // in flight during this tile's products
#pragma unroll 2
      for (int k = 0; k < kSK; k += 4) {
        float w0[4], w1[4], u0[4], u1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w0[j] = ws[(k + j) * kSN + lane];
          w1[j] = ws[(k + j) * kSN + lane + 32];
          if constexpr (kGlu) {
            u0[j] = ws2[(k + j) * kSN + lane];
            u1[j] = ws2[(k + j) * kSN + lane + 32];
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (warp + 8 * i >= B) continue;
          const float4 a = *reinterpret_cast<const float4*>(xs + (warp + 8 * i) * kXsPitch + k);
          acc[i][0] = fmaf(a.w, w0[3], fmaf(a.z, w0[2], fmaf(a.y, w0[1], fmaf(a.x, w0[0], acc[i][0]))));
          acc[i][1] = fmaf(a.w, w1[3], fmaf(a.z, w1[2], fmaf(a.y, w1[1], fmaf(a.x, w1[0], acc[i][1]))));
          if constexpr (kGlu) {
            acc2[i][0] = fmaf(a.w, u0[3], fmaf(a.z, u0[2], fmaf(a.y, u0[1], fmaf(a.x, u0[0], acc2[i][0]))));
            acc2[i][1] = fmaf(a.w, u1[3], fmaf(a.z, u1[2], fmaf(a.y, u1[1], fmaf(a.x, u1[0], acc2[i][1]))));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + 8 * i;
      if (r >= B) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + lane + 32 * c;
        if (n >= N) continue;
        if constexpr (kGlu) {
          const float g = acc[i][c] * s1[n], u = acc2[i][c] * s2[n];
          hout[static_cast<size_t>(r) * N + n] =
              __float2bfloat16_rn(g / (1.f + expf(-g)) * u);
        } else {
          part[(static_cast<size_t>(split) * B + r) * N + n] = acc[i][c];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// row phases (one block per batch row)
// ---------------------------------------------------------------------------

// x = bf16(x + down * ds) of layer l - 1 (x0 for l == 0); then xn =
// bf16(rms(x) * ln1[l]), or, after the last layer, xout = x.
__device__ __noinline__ void row_in(const StreamArgs& a, int l, float* smem) {
  const int H = a.H;
  float* xr = smem;
  float* red = smem + H;
  int count = 1, per = 1;
  split_plan(H, a.FF, gridDim.x, &count, &per);
  for (int r = blockIdx.x; r < a.B; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * H;
    float ss = 0.f;
    for (int i = threadIdx.x; i < H; i += kSThreads) {
      float v;
      if (l == 0) {
        v = bf(a.x0[row + i]);
      } else {
        float s = 0.f;
        for (int p = 0; p < count; ++p) s += __ldcg(a.part_h + p * a.B * H + row + i);
        v = round_bf(bf(__ldcg(a.x + row + i)) + s * a.ds[(l - 1) * H + i]);
      }
      if (l == a.L) {
        a.xout[row + i] = __float2bfloat16_rn(v);
      } else {
        a.x[row + i] = __float2bfloat16_rn(v);
        xr[i] = v;
        ss += v * v;
      }
    }
    if (l == a.L) continue;
    const float inv = 1.f / sqrtf(block_sum(ss, red) / H + a.eps);
    for (int i = threadIdx.x; i < H; i += kSThreads) {
      a.xn[row + i] = __float2bfloat16_rn(xr[i] * inv * bf(a.ln1[l * H + i]));
    }
    __syncthreads();
  }
}

// x32 = x + o * os (float32), x = bf16(x32), xn = bf16(rms(x32) * ln2);
// dense_stream also writes the layer's qkv rows from their partial sums.
__device__ __noinline__ void row_mid(const StreamArgs& a, int l, float* smem) {
  const int H = a.H;
  float* xr = smem;
  float* red = smem + H;
  int count = 1, per = 1, qcount = 1;
  split_plan(H, a.QD, gridDim.x, &count, &per);
  split_plan(a.QKV, H, gridDim.x, &qcount, &per);
  for (int r = blockIdx.x; r < a.B; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * H;
    float ss = 0.f;
    for (int i = threadIdx.x; i < H; i += kSThreads) {
      float s = 0.f;
      for (int p = 0; p < count; ++p) s += __ldcg(a.part_h + p * a.B * H + row + i);
      const float v = bf(__ldcg(a.x + row + i)) + s * a.os[l * H + i];
      a.x[row + i] = __float2bfloat16_rn(v);
      xr[i] = v;
      ss += v * v;
    }
    const float inv = 1.f / sqrtf(block_sum(ss, red) / H + a.eps);
    for (int i = threadIdx.x; i < H; i += kSThreads) {
      a.xn[row + i] = __float2bfloat16_rn(xr[i] * inv * bf(a.ln2[l * H + i]));
    }
    if (a.qkvout != nullptr) {
      const size_t qrow = static_cast<size_t>(r) * a.QKV;
      for (int c = threadIdx.x; c < a.QKV; c += kSThreads) {
        float s = 0.f;
        for (int p = 0; p < qcount; ++p) s += __ldcg(a.part_qkv + p * a.B * a.QKV + qrow + c);
        a.qkvout[(static_cast<size_t>(l) * a.B + r) * a.QKV + c] = __float2bfloat16_rn(
            s * a.qs[l * a.QKV + c] + bf(a.bias[l * a.QKV + c]));
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// attention phase (megakernel): one unit of work per (slot, kv head)
// ---------------------------------------------------------------------------

template <int D, int G>
struct AttnSmem {
  float hv[(G + 2) * D];   // the unit's q heads, k, v from qkv (bf16 values)
  float q[G][D];           // rope'd q, bf16 values
  float kr[D];             // rope'd k, bf16 values
  float nk[D], nv[D];      // this step's int8 K/V row
  float p[G][kSChunk];
  float m[G], l[G], alpha[G], px[G], nsc[2];
  float ksc[kSChunk], vsc[kSChunk];
  __align__(16) int8_t k[kSChunk * D];
  __align__(16) int8_t v[kSChunk * D];
};

template <int D, int G>
__device__ __noinline__ void attend(const StreamArgs& a, int l, float* smem) {
  AttnSmem<D, G>& sm = *reinterpret_cast<AttnSmem<D, G>*>(smem);
  constexpr int DL = D / kSLanesPerRow;
  using Vec = typename Bytes<DL>::type;
  constexpr int kRowsPerPass = kSWarps * (32 / kSLanesPerRow);
  constexpr int kVecPerRow = D / 16;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int KVD = a.KVH * D;
  int qcount = 1, per = 1;
  split_plan(a.QKV, a.H, gridDim.x, &qcount, &per);
  const float* qs = a.qs + static_cast<size_t>(l) * a.QKV;
  const __nv_bfloat16* bias = a.bias + static_cast<size_t>(l) * a.QKV;

  for (int u = blockIdx.x; u < a.B * a.KVH; u += gridDim.x) {
    const int b = u / a.KVH, kvh = u % a.KVH;
    // cache_len clamped into [0, M), as the plain version does
    const int len = min(max(a.lens[b], 0), a.M - 1);
    const size_t slab = ((static_cast<size_t>(l) * a.B + b) * a.KVH + kvh) * a.M;

    // 1. bf16(acc * qs + bias) of the unit's columns
    for (int i = tid; i < (G + 2) * D; i += kSThreads) {
      const int g = i / D, d = i % D;
      const int col = g < G ? (kvh * G + g) * D + d
                            : a.QD + (g - G) * KVD + kvh * D + d;
      float s = 0.f;
      for (int p = 0; p < qcount; ++p) {
        s += __ldcg(a.part_qkv + (static_cast<size_t>(p) * a.B + b) * a.QKV + col);
      }
      sm.hv[i] = round_bf(s * qs[col] + bf(bias[col]));
    }
    __syncthreads();
    // 2. rope in float32 (rotate-half), q and k rounded to bf16
    const float* cs = a.cos + static_cast<size_t>(b) * D;
    const float* sn = a.sin + static_cast<size_t>(b) * D;
    for (int i = tid; i < (G + 1) * D; i += kSThreads) {
      const int g = i / D, d = i % D;
      const float* v = sm.hv + g * D;
      const float rot = d < D / 2 ? -v[d + D / 2] : v[d - D / 2];
      const float o = round_bf(v[d] * cs[d] + rot * sn[d]);
      if (g < G) sm.q[g][d] = o; else sm.kr[d] = o;
    }
    if (tid < G) {
      sm.m[tid] = kNegInf;
      sm.l[tid] = 0.f;
    }
    __syncthreads();
    // 3. quantize this step's K (warp 0) and V (warp 1) rows, append them
    if (warp < 2) {
      const float* src = warp == 0 ? sm.kr : sm.hv + (G + 1) * D;
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(src[d]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = fmaxf(amax * (1.f / 127.f), 1e-8f);
      int8_t* dst = (warp == 0 ? a.kc : a.vc) + (slab + len) * D;
      float* nq = warp == 0 ? sm.nk : sm.nv;
      for (int d = lane; d < D; d += 32) {
        const float qv = fminf(fmaxf(rintf(src[d] / s), -127.f), 127.f);
        dst[d] = static_cast<int8_t>(qv);
        nq[d] = qv;
      }
      if (lane == 0) {
        const __nv_bfloat16 sb = __float2bfloat16_rn(s);
        (warp == 0 ? a.ksc : a.vsc)[slab + len] = sb;
        sm.nsc[warp] = bf(sb);
      }
    }
    __syncthreads();

    // 4. attention over rows [0, len), staged kSChunk rows at a time
    const int8_t* k_rows = a.kc + slab * D;
    const int8_t* v_rows = a.vc + slab * D;
    const int sub = lane % kSLanesPerRow, rg = lane / kSLanesPerRow;
    float qr[G][DL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < DL; ++i) qr[g][i] = sm.q[g][sub * DL + i];
    }
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int c0 = 0; c0 < len; c0 += kSChunk) {
      const int n = min(kSChunk, len - c0);
      for (int t = tid; t < n * kVecPerRow; t += kSThreads) {
        const size_t off = static_cast<size_t>(c0) * D + static_cast<size_t>(t) * 16;
        reinterpret_cast<uint4*>(sm.k)[t] = *reinterpret_cast<const uint4*>(k_rows + off);
        reinterpret_cast<uint4*>(sm.v)[t] = *reinterpret_cast<const uint4*>(v_rows + off);
      }
      for (int j = tid; j < n; j += kSThreads) {
        sm.ksc[j] = bf(a.ksc[slab + c0 + j]);
        sm.vsc[j] = bf(a.vsc[slab + c0 + j]);
      }
      __syncthreads();
      for (int base = 0; base < n; base += kRowsPerPass) {
        const int jj = base + warp * (32 / kSLanesPerRow) + rg;
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = 0.f;
        if (jj < n) {
          const Vec raw = *reinterpret_cast<const Vec*>(sm.k + jj * D + sub * DL);
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
#pragma unroll
          for (int g = 0; g < G; ++g) sm.p[g][jj] = part[g] * sm.ksc[jj] * a.scale;
        }
      }
      __syncthreads();
      for (int g = warp; g < G; g += kSWarps) {
        float mx = kNegInf;
        for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, sm.p[g][jj]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = sm.m[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int jj = lane; jj < n; jj += 32) {
          const float p = expf(sm.p[g][jj] - m_new);
          sum += p;
          sm.p[g][jj] = round_bf(p * sm.vsc[jj]);  // bf16 p * v_scale, as the TPU kernel
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          sm.alpha[g] = alpha;
          sm.l[g] = sm.l[g] * alpha + sum;
          sm.m[g] = m_new;
        }
      }
      __syncthreads();
      if (tid < D) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] *= sm.alpha[g];
        for (int jj = 0; jj < n; ++jj) {
          const float vv = static_cast<float>(sm.v[jj * D + tid]);
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] += sm.p[g][jj] * vv;
        }
      }
      __syncthreads();
    }

    // 5. fold in this step's row, dequantized in float32
    for (int g = warp; g < G; g += kSWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += sm.q[g][d] * (sm.nk[d] * sm.nsc[0]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const float s_x = dot * a.scale;
        const float m_new = fmaxf(sm.m[g], s_x);
        const float p_x = expf(s_x - m_new);
        const float alpha = expf(sm.m[g] - m_new);
        sm.l[g] = alpha * sm.l[g] + p_x;
        sm.alpha[g] = alpha;
        sm.px[g] = p_x;
      }
    }
    __syncthreads();
    if (tid < D) {
      const float nv = sm.nv[tid] * sm.nsc[1];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float o = acc[g] * sm.alpha[g] + sm.px[g] * nv;
        const float ll = sm.l[g] == 0.f ? 1.f : sm.l[g];
        a.attn[static_cast<size_t>(b) * a.QD + (kvh * G + g) * D + tid] =
            __float2bfloat16_rn(o / ll);
      }
    }
    __syncthreads();  // the next unit overwrites the shared arrays
  }
}

// ---------------------------------------------------------------------------
// the kernel: D == 0 is dense_stream, otherwise the megakernel
// ---------------------------------------------------------------------------

template <int RPT, int D, int G>
__global__ void __launch_bounds__(kSThreads, 1) stream_kernel(StreamArgs a) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int H = a.H, QKV = a.QKV, FF = a.FF, QD = a.QD, B = a.B;
  for (int l = 0; l < a.L; ++l) {
    row_in(a, l, smem);
    grid_sync(a.bar);
    products<RPT, false>(smem, a.xn, H, a.wqkv + static_cast<size_t>(l) * QKV * H, nullptr,
                         QKV, H, B, a.part_qkv, nullptr, nullptr, nullptr);
    const int8_t* wo = a.wo + static_cast<size_t>(l) * H * QD;
    if constexpr (D == 0) {
      products<RPT, false>(smem, a.attn_in + static_cast<size_t>(l) * B * QD, QD, wo,
                           nullptr, H, QD, B, a.part_h, nullptr, nullptr, nullptr);
      grid_sync(a.bar);
    } else {
      grid_sync(a.bar);
      attend<D, G>(a, l, smem);
      grid_sync(a.bar);
      products<RPT, false>(smem, a.attn, QD, wo, nullptr, H, QD, B, a.part_h, nullptr,
                           nullptr, nullptr);
      grid_sync(a.bar);
    }
    row_mid(a, l, smem);
    grid_sync(a.bar);
    const size_t wff = static_cast<size_t>(l) * FF * H;
    products<RPT, true>(smem, a.xn, H, a.wg + wff, a.wu + wff, FF, H, B, nullptr,
                        a.gs + static_cast<size_t>(l) * FF, a.us + static_cast<size_t>(l) * FF,
                        a.h);
    grid_sync(a.bar);
    products<RPT, false>(smem, a.h, FF, a.wd + wff, nullptr, H, FF, B, a.part_h, nullptr,
                         nullptr, nullptr);
    grid_sync(a.bar);
  }
  row_in(a, a.L, smem);
}

// ---------------------------------------------------------------------------
// host side: shared memory, grid, workspace layout, launch
// ---------------------------------------------------------------------------

template <int RPT, int D, int G>
size_t smem_bytes(int H) {
  size_t prod = (8 * RPT * kXsPitch + 2 * kSK * kSN) * sizeof(float);
  size_t rows = (H + kSWarps) * sizeof(float);
  size_t att = D == 0 ? 0 : sizeof(AttnSmem<D == 0 ? 16 : D, G == 0 ? 1 : G>);
  return std::max(prod, std::max(rows, att));
}

// co-resident blocks of the instance: occupancy x SMs (0 on failure)
template <int RPT, int D, int G>
cudaError_t grid_of(int H, int device, int* grid) {
  const size_t smem = smem_bytes<RPT, D, G>(H);
  auto kernel = stream_kernel<RPT, D, G>;
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

struct Layout {
  size_t x, xn, h, attn, pq, ph, total;
};

inline Layout layout(bool mega, int B, int H, int QKV, int FF, int QD, int grid) {
  Layout o;
  size_t off = 0;
  auto take = [&](size_t n) {
    const size_t at = off;
    off += (n + 255) & ~static_cast<size_t>(255);
    return at;
  };
  int cq, co, cd, per;
  split_plan(QKV, H, grid, &cq, &per);
  split_plan(H, QD, grid, &co, &per);
  split_plan(H, FF, grid, &cd, &per);
  o.x = take(static_cast<size_t>(B) * H * 2);
  o.xn = take(static_cast<size_t>(B) * H * 2);
  o.h = take(static_cast<size_t>(B) * FF * 2);
  o.attn = take(mega ? static_cast<size_t>(B) * QD * 2 : 0);
  o.pq = take(static_cast<size_t>(cq) * B * QKV * 4);
  o.ph = take(static_cast<size_t>(std::max(co, cd)) * B * H * 4);
  o.total = off;
  return o;
}

template <int RPT, int D, int G>
cudaError_t launch(StreamArgs a, void* work, int device, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = grid_of<RPT, D, G>(a.H, device, &grid);
  if (err != cudaSuccess) return err;
  const Layout o = layout(D != 0, a.B, a.H, a.QKV, a.FF, a.QD, grid);
  char* w = static_cast<char*>(work);
  a.x = reinterpret_cast<__nv_bfloat16*>(w + o.x);
  a.xn = reinterpret_cast<__nv_bfloat16*>(w + o.xn);
  a.h = reinterpret_cast<__nv_bfloat16*>(w + o.h);
  a.attn = reinterpret_cast<__nv_bfloat16*>(w + o.attn);
  a.part_qkv = reinterpret_cast<float*>(w + o.pq);
  a.part_h = reinterpret_cast<float*>(w + o.ph);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(stream_kernel<RPT, D, G>),
                                    dim3(grid), dim3(kSThreads), args,
                                    smem_bytes<RPT, D, G>(a.H), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows per thread of the product tiles: the smallest instance that holds B
inline int rpt_for(int B) {
  constexpr int kRpt[] = {1, 4, 10, 16};
  for (int r : kRpt) {
    if (8 * r >= B) return r;
  }
  return 0;
}

// the two things done per instance, as functors for dispatch()
struct GridOf {
  int H, device;
  int* grid;
  template <int R, int DD, int GG>
  cudaError_t operator()() const { return grid_of<R, DD, GG>(H, device, grid); }
};

struct Launch {
  StreamArgs a;
  void* work;
  int device;
  cudaStream_t stream;
  template <int R, int DD, int GG>
  cudaError_t operator()() const { return launch<R, DD, GG>(a, work, device, stream); }
};

// Calls f.template operator()<RPT, D, G>() for the instance of (B, D, G);
// D == 0 selects dense_stream. Returns cudaErrorInvalidValue without one.
template <typename F>
cudaError_t dispatch(int B, int D, int G, const F& f) {
#define KARANTA_STREAM_RPT(DD, GG)                                              \
  switch (rpt_for(B)) {                                                         \
    case 1: return f.template operator()<1, DD, GG>();                          \
    case 4: return f.template operator()<4, DD, GG>();                          \
    case 10: return f.template operator()<10, DD, GG>();                        \
    case 16: return f.template operator()<16, DD, GG>();                        \
    default: return cudaErrorInvalidValue;                                      \
  }
  if (D == 0) { KARANTA_STREAM_RPT(0, 0) }
  if (D == 128 && G == 7) { KARANTA_STREAM_RPT(128, 7) }  // Qwen2.5-VL-7B
  if (D == 64 && G == 2) { KARANTA_STREAM_RPT(64, 2) }    // the tiny test config
#undef KARANTA_STREAM_RPT
  return cudaErrorInvalidValue;
}

inline bool shapes_ok(int B, int H, int QKV, int FF, int QD) {
  return B >= 1 && B <= 128 && H % kSK == 0 && FF % kSK == 0 && QD % kSK == 0 &&
         QKV > 0 && H > 0 && FF > 0 && QD > 0;
}

}  // namespace karanta

// C interface (loaded with ctypes). Bytes of workspace a call needs (the
// grid is the device's co-resident block count), or a negative CUDA error.
extern "C" long long karanta_decode_stream_workspace(int mega, int B, int H, int QKV,
                                                     int FF, int QD, int D, int G,
                                                     int device) {
  using namespace karanta;
  if (!shapes_ok(B, H, QKV, FF, QD)) return -static_cast<long long>(cudaErrorInvalidValue);
  int grid = 0;
  const cudaError_t err = dispatch(B, mega ? D : 0, mega ? G : 0, GridOf{H, device, &grid});
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(layout(mega != 0, B, H, QKV, FF, QD, grid).total);
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
