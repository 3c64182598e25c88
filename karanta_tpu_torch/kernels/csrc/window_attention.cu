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
// cores.
//
// The bf16 instance (window_tc_kernel) runs the products on the tensor
// cores. One block of 8 warps owns one window of kWindowHeads (2)
// neighbouring heads (fewer where the window's tiles would not fit in
// shared memory, and the last group holds what is left of H): at the 7B
// shape, 640 blocks, two resident an SM (127 registers). It loads
// every head's Q and K rows and the window's float32 cos/sin rows with
// 16-byte cp.async (lanes on neighbouring addresses: a row's heads are
// contiguous in (B, S, H, D)), then V and the mask slice as a second group;
// shared rows are padded by 16 bytes (176 at D = 80), so every ldmatrix is
// conflict-free. While V lands, rope rotates Q and K in place in shared
// memory: each (row, 4 dims) of cos/sin serves all the block's heads, in
// float32, with the separate roundings of the plain version (__fmul_rn /
// __fadd_rn), then rounded to bf16. (Where the staged cos/sin would not fit
// beside one head's tiles, at W = 256 and D = 80, rope reads them in place
// from device memory.) Each
// warp then owns (head, 16-row) units: Q.K^T over the whole window with
// mma.sync.m16n8k16 (bf16 operands, float32 accumulators; K through
// ldmatrix as the B operand), 64 keys of scores at a time in the
// accumulator fragments. The softmax is exact, with no online rescale: a
// row max over the quad of lanes that share a row, ex2 in the log2 domain
// (scale * log2(e) folded into the scores), the row sum, then P is
// normalised and rounded to bf16 (the TPU kernel's p.astype(v.dtype),
// attention.py:342-343, :396-397) and used from registers as the A operand
// of P.V, V through ldmatrix.trans. A window of 64 keys is one pass of
// scores; a wider window recomputes its 64-key score chunks for the sum and
// for P.V instead of rescaling, so it rounds where the TPU kernel does too.
// Masked keys score -1e30, so a row whose window has no live key averages
// its window's values uniformly (its output is unspecified: the encoder
// drops it). The output goes through the warp's own Q rows in shared memory
// to 16-byte stores.
//
// Measured on the card at the 7B shape (PERF.md): 2 heads and 8 warps a
// block, 109 KB of shared memory, two blocks an SM, was fastest; 1, 3, 4 or
// 6 heads, 4 warps, a persistent grid that loads the next window while this
// one computes (double-buffered, 162 registers, three blocks an SM), and
// rope reading cos/sin from device memory were slower. The
// block's load, rope, products and stores run one after another; what
// overlaps them is the other resident block.
//
// The float32 instance (window_attention_kernel) stays on the CUDA cores:
// the tensor cores would multiply in TF32. One block per (window, head,
// batch), one thread per query row keeps its rotated query and float32
// accumulator in registers and runs an online softmax over the window's
// keys, sixteen keys per rescale.
#include "common.cuh"
#include "mma.cuh"

namespace karanta {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// warps a block and heads it covers when their tiles fit (measured on the
// card: PERF.md)
constexpr int kWinWarps = 8;
constexpr int kWindowHeads = 2;
constexpr int kWinThreads = kWinWarps * 32;
constexpr int kWinKeys = 64;  // keys of one score chunk (8 n-tiles)
constexpr size_t kWinSmemCap = 227 * 1024;

template <int D>
struct WinTile {
  static constexpr int kPitch = D + 8;  // shared row pitch (elements)
  // Q, K and V tiles of one head
  static size_t head_bytes(int W) {
    return 3 * static_cast<size_t>(W) * kPitch * sizeof(__nv_bfloat16);
  }
  // with the window's cos/sin rows staged (float32 [W][D] each) or not
  static size_t smem(int W, int hg, bool staged) {
    return hg * head_bytes(W) + W * sizeof(float) +
           (staged ? 2 * static_cast<size_t>(W) * D * sizeof(float) : 0);
  }
  // heads per block (kWindowHeads, fewer for H or for shared memory) and
  // whether cos/sin are staged (with rope, where they fit beside one head)
  static int heads(int W, int H, bool& staged) {
    int hg = kWindowHeads < H ? kWindowHeads : H;
    while (smem(W, hg, staged) > kWinSmemCap) {
      if (hg > 1) {
        --hg;
      } else {
        staged = false;
      }
    }
    return hg;
  }
};

template <int D>
__global__ void __launch_bounds__(kWinThreads) window_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    const float* __restrict__ cos, const float* __restrict__ sin,
    __nv_bfloat16* __restrict__ out, int S, int H, int W, int hg, int staged,
    float scale_log2) {
  constexpr int P = WinTile<D>::kPitch;
  constexpr int kVecs = D / 8;  // 16-byte chunks per row
  constexpr int kHalf = D / 2;
  constexpr int kKT = D / 16;   // k-steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [hg][Q,K,V][W][P]
  float* live_s = reinterpret_cast<float*>(tiles + static_cast<size_t>(hg) * 3 * W * P);
  float* cs_s = live_s + W;     // [W][D] when staged
  float* sn_s = cs_s + W * D;   // [W][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.x * hg, s0 = blockIdx.y * W, b = blockIdx.z;
  const int nh = min(hg, H - h0);
  const size_t pitch = static_cast<size_t>(H) * D;  // elements from one s to the next
  const size_t base = (static_cast<size_t>(b) * S + s0) * pitch + static_cast<size_t>(h0) * D;
  auto tile = [&](int hh, int which) {
    return tiles + (static_cast<size_t>(hh) * 3 + which) * W * P;
  };

  // group 0: Q and K of every head and, when staged, the window's cos/sin
  // rows; group 1: V and the mask slice. The heads of one row are
  // contiguous, so neighbouring lanes copy neighbouring 16-byte chunks.
  const int row_vecs = nh * kVecs;
  for (int c = tid; c < W * row_vecs; c += kWinThreads) {
    const int r = c / row_vecs, hh = (c % row_vecs) / kVecs, col = (c % kVecs) * 8;
    const size_t off = base + r * pitch + hh * D + col;
    cp_async16(tile(hh, 0) + r * P + col, q + off, 16);
    cp_async16(tile(hh, 1) + r * P + col, k + off, 16);
  }
  // the window's cos/sin rows: from shared memory when staged, else read in
  // place (the rows of one window are contiguous either way)
  const size_t cs0 = (static_cast<size_t>(b) * S + s0) * D;
  const float* cs_rows = cos == nullptr ? nullptr : (staged ? cs_s : cos + cs0);
  const float* sn_rows = sin == nullptr ? nullptr : (staged ? sn_s : sin + cs0);
  if (cos != nullptr && staged) {
    for (int c = tid; c < W * D / 4; c += kWinThreads) {
      cp_async16(cs_s + 4 * c, cos + cs0 + 4 * c, 16);
      cp_async16(sn_s + 4 * c, sin + cs0 + 4 * c, 16);
    }
  }
  cp_async_commit();
  for (int c = tid; c < W * row_vecs; c += kWinThreads) {
    const int r = c / row_vecs, hh = (c % row_vecs) / kVecs, col = (c % kVecs) * 8;
    cp_async16(tile(hh, 2) + r * P + col, v + base + r * pitch + hh * D + col, 16);
  }
  for (int c = tid; c < W; c += kWinThreads) {
    if (mask != nullptr) {
      cp_async4(live_s + c, mask + static_cast<size_t>(b) * S + s0 + c, 4);
    } else {
      live_s[c] = 1.f;
    }
  }
  cp_async_commit();

  if (cos != nullptr) {
    cp_async_wait<1>();
    __syncthreads();  // Q and K landed
    // rotate each (d, d + D/2) pair, four dims at a time
    constexpr int kQuads = kHalf / 4;
    for (int c = tid; c < W * kQuads; c += kWinThreads) {
      const int r = c / kQuads, d = (c % kQuads) * 4;
      const float* cr = cs_rows + r * D;
      const float* sr = sn_rows + r * D;
      const float4 c_lo = *reinterpret_cast<const float4*>(cr + d);
      const float4 c_hi = *reinterpret_cast<const float4*>(cr + d + kHalf);
      const float4 s_lo = *reinterpret_cast<const float4*>(sr + d);
      const float4 s_hi = *reinterpret_cast<const float4*>(sr + d + kHalf);
      const float cl[4] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w};
      const float ch[4] = {c_hi.x, c_hi.y, c_hi.z, c_hi.w};
      const float sl[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
      const float sh[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
      for (int hw = 0; hw < 2 * nh; ++hw) {  // Q and K of each head
        __nv_bfloat16* x = tile(hw >> 1, hw & 1) + r * P + d;
        uint2 lo_raw = *reinterpret_cast<const uint2*>(x);
        uint2 hi_raw = *reinterpret_cast<const uint2*>(x + kHalf);
        __nv_bfloat16* lo = reinterpret_cast<__nv_bfloat16*>(&lo_raw);
        __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(&hi_raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // x*cos + rotate_half(x)*sin: rotate_half(x)[d] = -x[d + D/2]
          // below D/2 and x[d - D/2] above
          const float a = __bfloat162float(lo[i]), z = __bfloat162float(hi[i]);
          lo[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(a, cl[i]), __fmul_rn(-z, sl[i])));
          hi[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(z, ch[i]), __fmul_rn(a, sh[i])));
        }
        *reinterpret_cast<uint2*>(x) = lo_raw;
        *reinterpret_cast<uint2*>(x + kHalf) = hi_raw;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V, the mask and the rotated Q/K are in place

  // this lane's ldmatrix offsets, as in flash_attention.cu: Q as A, K as B
  // of Q.K^T, V as B of P.V through .trans
  const int q_lane = (lane & 15) * P + (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * P + (lane >> 4) * 8;
  const int m_tiles = W / 16, n_chunks = (W + kWinKeys - 1) / kWinKeys;

  for (int u = warp; u < nh * m_tiles; u += kWinWarps) {
    const int hh = u / m_tiles, mt = u % m_tiles;
    __nv_bfloat16* qs = tile(hh, 0) + mt * 16 * P;
    const __nv_bfloat16* ks = tile(hh, 1);
    const __nv_bfloat16* vs = tile(hh, 2);
    uint32_t qa[kKT][4];
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) ldmatrix_x4(qa[kk], qs + q_lane + kk * 16);

    // scores of keys k0 .. k0 + 63 in the log2 domain: element e of
    // fragment j is row g + 8 (e / 2), key k0 + 8j + 2t + e % 2; masked
    // keys -1e30, keys past the window -inf
    float s[kWinKeys / 8][4];
    auto scores = [&](int k0) {
#pragma unroll
      for (int j = 0; j < kWinKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
        for (int jp = 0; jp < kWinKeys / 16; ++jp) {
          if (k0 + 16 * jp >= W) break;
          uint32_t bb[4];
          ldmatrix_x4(bb, ks + (k0 + 16 * jp) * P + k_lane + kk * 16);
          mma_bf16_16816(s[2 * jp], qa[kk], bb[0], bb[1]);
          mma_bf16_16816(s[2 * jp + 1], qa[kk], bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kWinKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = key >= W ? -CUDART_INF_F
                             : (live_s[key] > 0.f ? s[j][e] * scale_log2 : kNegInf);
        }
      }
    };
    auto exp_sum = [&](const float (&mx)[2], float (&l)[2]) {
#pragma unroll
      for (int j = 0; j < kWinKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fast_exp2(s[j][e] - mx[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }
    };

    // exact softmax: the row max, then the row sum, then normalised P. A
    // single chunk keeps its scores in registers across the three steps.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int ck = 0; ck < n_chunks; ++ck) {
      scores(ck * kWinKeys);
#pragma unroll
      for (int j = 0; j < kWinKeys / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    for (int ck = 0; ck < n_chunks; ++ck) {
      if (n_chunks > 1) scores(ck * kWinKeys);
      exp_sum(mx, l);
    }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / l[i];  // >= 1: the row max contributes exp2(0)
    }

    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int ck = 0; ck < n_chunks; ++ck) {
      const int k0 = ck * kWinKeys;
      if (n_chunks > 1) {
        float unused[2] = {0.f, 0.f};
        scores(k0);
        exp_sum(mx, unused);
      }
      // O += P V, P normalised and rounded to bf16 as the A operand
#pragma unroll
      for (int kk = 0; kk < kWinKeys / 16; ++kk) {
        if (k0 + 16 * kk >= W) break;
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
        pa[1] = pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
        pa[2] = pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]);
        pa[3] = pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vs + (k0 + 16 * kk) * P + v_lane + np * 16);
          mma_bf16_16816(o[2 * np], pa, bb[0], bb[1]);
          mma_bf16_16816(o[2 * np + 1], pa, bb[2], bb[3]);
        }
      }
    }

    // out: through this unit's own Q rows (no other warp reads them), then
    // 16-byte stores, a row's D elements contiguous
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(qs + g * P + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(qs + (g + 8) * P + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * kVecs; c += 32) {
      const int r = c / kVecs, col = (c % kVecs) * 8;
      *reinterpret_cast<uint4*>(out + base + (mt * 16 + r) * pitch + hh * D + col) =
          *reinterpret_cast<const uint4*>(qs + r * P + col);
    }
  }
}

template <int D>
cudaError_t launch_window_tc(const void* q, const void* k, const void* v, const float* mask,
                             const float* cos, const float* sin, void* out, int B, int S,
                             int H, int W, float scale, cudaStream_t stream) {
  bool staged = cos != nullptr;
  const int hg = WinTile<D>::heads(W, H, staged);
  const size_t smem = WinTile<D>::smem(W, hg, staged);
  auto kernel = window_tc_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // head groups fastest: the blocks of one window (one cos/sin slice) run together
  dim3 grid((H + hg - 1) / hg, S / W, B);
  kernel<<<grid, kWinThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, cos, sin,
      static_cast<__nv_bfloat16*>(out), S, H, W, hg, staged ? 1 : 0, scale * kLog2e);
  return cudaGetLastError();
}

// registers, local (spilled) bytes, dynamic shared bytes, resident blocks per
// SM and heads per block of the bf16 instance for window W with rope (a
// head count that fills the block)
template <int D>
cudaError_t window_tc_info(int W, int* info) {
  bool staged = true;
  const int hg = WinTile<D>::heads(W, kWindowHeads, staged);
  const size_t smem = WinTile<D>::smem(W, hg, staged);
  const void* fn = reinterpret_cast<const void*>(window_tc_kernel<D>);
  cudaError_t err = allow_smem(window_tc_kernel<D>, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[4] = hg;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, kWinThreads, smem);
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
cudaError_t launch_window(int dtype, const void* q, const void* k, const void* v,
                          const float* mask, const float* cos, const float* sin, void* out,
                          int B, int S, int H, int W, float scale, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_window_tc<D>(q, k, v, mask, cos, sin, out, B, S, H, W, scale, st);
  }
  if (dtype == kFloat32) {
    return launch_window_f32<D>(q, k, v, mask, cos, sin, out, B, S, H, W, scale, st);
  }
  return cudaErrorInvalidValue;
}

// Qwen2.5-VL vision heads are 80 wide (16 in the tiny test config)
#define KARANTA_WINDOW_HEAD_DIMS(X) X(16) X(64) X(80)

}  // namespace karanta

// C interface (loaded with ctypes). q/k/v/out are contiguous (B, S, H, D) of
// the type `dtype` names; returns the CUDA error code of the launch.
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
#define KARANTA_CASE(d)                                                                  \
  case d:                                                                                \
    return static_cast<int>(karanta::launch_window<d>(dtype, q, k, v, mask, cos, sin,  \
                                                      out, B, S, H, W, scale, st));
    KARANTA_WINDOW_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// info[5] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, resident blocks per SM and heads per block of the
// bf16 instance for head dim D and window W. Returns the CUDA error code.
extern "C" int karanta_window_attention_info(int D, int W, int* info) {
  if (W <= 0 || W > 256 || W % karanta::kWinChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
#define KARANTA_CASE(d) \
  case d:               \
    return static_cast<int>(karanta::window_tc_info<d>(W, info));
    KARANTA_WINDOW_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
