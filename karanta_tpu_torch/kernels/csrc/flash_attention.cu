// Flash attention (online softmax, BSHD) for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/attention.py:235 flash_attention
// (body _flash_kernel :163). q (B, Sq, H, D), k/v (B, Sk, KVH, D), optional
// float kv mask (B, Sk), causal masking at q_offset + row >= col, GQA through
// kv_head = h / (H / KVH). Key tiles entirely above the causal diagonal are
// skipped; masked keys score the finite -1e30 and keys past Sk -inf, so a row
// whose every key is masked averages the masked values uniformly; l == 0
// divides by 1.
//
// What bounds it on this card: at the decoder-prefill shape (Sq = Sk = 1408,
// 28 heads, D = 128, causal), the vision full layers (S = 5120, 16 heads,
// D = 80) and the prefix continuation, attention does hundreds of flops per
// byte, far above the card's balance point, so the bound is the tensor
// cores' 989 TFLOP/s in bf16.
//
// The bf16 instance (flash_tc_kernel) is FlashAttention-2's structure on the
// tensor cores. One block of 4 warps owns 128 query rows of one (batch,
// head); each warp owns 32 rows as two 16-row m-tiles, so every K and V
// fragment it loads feeds two products (16-row warps, 8 to a block, ran
// slower: twice the ldmatrix traffic per flop). Q.K^T and P.V are
// mma.sync.m16n8k16 in bf16 with float32 accumulators, operands from
// ldmatrix (V through .trans, since it is key-major in shared memory but the
// B operand of P.V); one template covers D = 16..128, which are whole
// 16-wide k-steps and 8-wide n-tiles. 64-key K and V tiles and the tile's
// mask slice stream through a ring of cp.async stages (2 at D = 128, 3
// below), so the next tiles load while one computes; shared rows are padded
// by 16 bytes, which makes every ldmatrix conflict-free. Registers: up to
// 255 a thread, 2 blocks an SM. The scores stay in the accumulator
// fragments: scale * log2(e) is folded into them, the row max and sum reduce
// over the 4 lanes that share a row, and each score costs one ex2. P is
// rounded to bf16 in registers and fed back as the A operand of P.V (as the
// JAX kernel's p.astype(v.dtype)), while l sums the unrounded P. Causal
// masking is applied only on tiles that cross a warp's diagonal and the Sk
// tail only on the last tile; under causal masking query tiles are issued
// longest first, heads fastest, so the last wave holds the shortest blocks.
// wgmma (warpgroup products from shared memory) is the step past this
// design, with what makes it pay: TMA loads from a producer warp, swizzled
// operand tiles, and warpgroups that take turns so one's softmax overlaps
// another's products. A wgmma kernel on this one's cp.async ring and
// unswizzled tiles was right but no faster, and is not kept.
//
// The float32 instance (flash_f32_kernel) stays on the CUDA cores: the tensor
// cores would multiply in TF32, and the tiny config's card-vs-CPU check and
// the float32 tests need full float32 products. One block per (64-query
// tile, head, batch), four threads per query row, each owning every fourth
// feature dim; the row's partial dot products meet with two warp shuffles,
// and the online softmax rescales once per sixteen keys.
#include "common.cuh"
#include "mma.cuh"

namespace karanta {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// one block: kWarps warps of 16 * kMT query rows each; kBK-key tiles in a
// ring of kStages; kMinBlocks resident blocks an SM (sets the register cap)
template <int D>
struct TcTile {
  static constexpr int kWarps = 4;
  static constexpr int kMT = 2;
  static constexpr int kBK = 64;
  static constexpr int kMinBlocks = 2;
  static constexpr int kBQ = kWarps * 16 * kMT;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kPitch = D + 8;  // shared row pitch (elements)
  static constexpr int kTileElems = kBK * kPitch;
  static constexpr int kStages = D >= 128 ? 2 : 3;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kBQ) * kPitch + 2 * kStages * kTileElems) *
          sizeof(__nv_bfloat16) +
      kStages * kBK * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(TcTile<D>::kThreads, TcTile<D>::kMinBlocks)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KVH,
                    float scale_log2, int causal, int q_offset) {
  using Tile = TcTile<D>;
  constexpr int P = Tile::kPitch, kMT = Tile::kMT, kBK = Tile::kBK, kBQ = Tile::kBQ;
  constexpr int kStages = Tile::kStages, kThreads = Tile::kThreads;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kN = kBK / 8;     // score n-tiles per key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][P]
  __nv_bfloat16* k_s = q_s + kBQ * P;                       // [stages][BK][P]
  __nv_bfloat16* v_s = k_s + kStages * Tile::kTileElems;    // [stages][BK][P]
  float* live_s = reinterpret_cast<float*>(v_s + kStages * Tile::kTileElems);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int kvh = h / (H / KVH);
  const size_t q_pitch = static_cast<size_t>(H) * D;
  const size_t kv_pitch = static_cast<size_t>(KVH) * D;
  const __nv_bfloat16* q_base = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* k_base = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const __nv_bfloat16* v_base = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* mask_row = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Sk;

  const int k_end = causal ? min(Sk, q_offset + q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  // rows past Sq and keys past Sk are zero-filled (src-size 0 from row 0)
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = q0 + r < Sq;
    cp_async16(q_s + r * P + col, q_base + (ok ? q0 + r : 0) * q_pitch + col, ok ? 16 : 0);
  }
  auto load_tile = [&](int tile) {
    const int k0 = tile * kBK, stage = tile % kStages;
    __nv_bfloat16* ks = k_s + stage * Tile::kTileElems;
    __nv_bfloat16* vs = v_s + stage * Tile::kTileElems;
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool ok = k0 + r < Sk;
      const size_t off = (ok ? k0 + r : 0) * kv_pitch + col;
      cp_async16(ks + r * P + col, k_base + off, ok ? 16 : 0);
      cp_async16(vs + r * P + col, v_base + off, ok ? 16 : 0);
    }
    if (mask_row != nullptr) {
      for (int c = tid; c < kBK; c += kThreads) {
        const bool ok = k0 + c < Sk;
        cp_async4(live_s + stage * kBK + c, mask_row + (ok ? k0 + c : 0), ok ? 4 : 0);
      }
    }
  };
  // prologue: Q with tile 0, then tiles up to kStages - 2, one group each
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }

  // this lane's ldmatrix row addresses: Q as A (rows + lane % 16, column
  // half lane / 16), K as B of Q.K^T (keys + lane % 8 + 8 (lane / 16),
  // column half (lane / 8) % 2), V as B of P.V through .trans (keys +
  // lane % 8 + 8 ((lane / 8) % 2), column half lane / 16)
  const int w0 = warp * 16 * kMT;  // the warp's first row in the block
  const __nv_bfloat16* q_frag = q_s + (w0 + (lane & 15)) * P + (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * P + (lane >> 4) * 8;

  // lane rows: w0 + 16 mt + g + 8 i for m-tile mt and half i
  const int qpos0 = q_offset + q0 + w0 + g;
  const int warp_first = q_offset + q0 + w0;  // the warp's lowest position

  float o[kMT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile landed for every thread; tile - 1's stage is free
    if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);
    cp_async_commit();

    const int stage = tile % kStages, k0 = tile * kBK;
    const __nv_bfloat16* ks = k_s + stage * Tile::kTileElems;
    const __nv_bfloat16* vs = v_s + stage * Tile::kTileElems;
    const float* live = live_s + stage * kBK;

    // S = Q K^T: 16 kMT rows x kBK keys per warp, in accumulator fragments
    float s[kMT][kN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kN; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) ldmatrix_x4(a[mt], q_frag + mt * 16 * P + kk * 16);
#pragma unroll
      for (int jp = 0; jp < kN / 2; ++jp) {
        uint32_t bb[4];
        ldmatrix_x4(bb, ks + jp * 16 * P + k_lane + kk * 16);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16_16816(s[mt][2 * jp], a[mt], bb[0], bb[1]);
          mma_bf16_16816(s[mt][2 * jp + 1], a[mt], bb[2], bb[3]);
        }
      }
    }

    // scale into the log2 domain, then mask: element e of fragment j of
    // m-tile mt is row w0 + 16 mt + g + 8 (e / 2), key k0 + 8j + 2t + e % 2;
    // masked keys score -1e30, keys past Sk -inf
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] *= scale_log2;
      }
    }
    if (mask_row != nullptr) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float2 lv = *reinterpret_cast<const float2*>(live + 8 * j + 2 * t);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!(((e & 1) ? lv.y : lv.x) > 0.f)) s[mt][j][e] = kNegInf;
          }
        }
      }
    }
    if (causal && k0 + kBK - 1 > warp_first) {  // the tile crosses the diagonal
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + 8 * j + 2 * t + (e & 1) > qpos0 + 16 * mt + 8 * (e >> 1)) {
              s[mt][j][e] = kNegInf;
            }
          }
        }
      }
    }
    if (k0 + kBK > Sk) {  // the last tile: keys past Sk are not keys at all
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + 8 * j + 2 * t + (e & 1) >= Sk) s[mt][j][e] = -CUDART_INF_F;
          }
        }
      }
    }

    // online softmax over the quad of lanes that share a row, one rescale
    // of O per tile
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]}, alpha[2];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = fast_exp2(m[mt][i] - mx[i]);
        m[mt][i] = mx[i];
        l[mt][i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] = fast_exp2(s[mt][j][e] - mx[e >> 1]);
          l[mt][e >> 1] += s[mt][j][e];  // this lane's share of the row sum
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[mt][n][0] *= alpha[0];
        o[mt][n][1] *= alpha[0];
        o[mt][n][2] *= alpha[1];
        o[mt][n][3] *= alpha[1];
      }
    }

    // O += P V: P's accumulator fragments are the A fragments of 16-key steps
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vs + kk * 16 * P + v_lane + np * 16);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16_16816(o[mt][2 * np], a[mt], bb[0], bb[1]);
          mma_bf16_16816(o[mt][2 * np + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[mt][i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = sum == 0.f ? 1.f : 1.f / sum;
      const int row = q0 + w0 + 16 * mt + g + 8 * i;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[mt][n][2 * i] * inv, o[mt][n][2 * i + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v, const float* mask,
                            void* out, int B, int Sq, int Sk, int H, int KVH, float scale,
                            int causal, int q_offset, cudaStream_t stream) {
  using Tile = TcTile<D>;
  auto kernel = flash_tc_kernel<D>;
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (Sq + Tile::kBQ - 1) / Tile::kBQ, B);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), Sq, Sk,
      H, KVH, scale * kLog2e, causal, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFlashBQ = 64;     // query rows per block
constexpr int kFlashBK = 64;     // keys per shared-memory tile
constexpr int kFlashTPR = 4;     // threads per query row
constexpr int kFlashChunk = 16;  // keys per online-softmax rescale
constexpr int kFlashThreads = kFlashBQ * kFlashTPR;

template <int D>
__global__ void __launch_bounds__(kFlashThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask,  // (B, Sk) or null
    float* __restrict__ out, int Sq, int Sk, int H, int KVH, float scale, int causal,
    int q_offset) {
  constexpr int DP = D / kFlashTPR;  // dims per thread
  constexpr int kVecPerRow = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // [BK][D]
  float* v_s = k_s + kFlashBK * D;                  // [BK][D]
  float* live = v_s + kFlashBK * D;                 // [BK]

  const int tid = threadIdx.x;
  const int r = tid / kFlashTPR, sub = tid % kFlashTPR;
  const int q0 = blockIdx.x * kFlashBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;

  float qf[DP], acc[DP];
  const float* qrow = q + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qf[i] = row_ok ? qrow[i * kFlashTPR + sub] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + q0 + kFlashBQ);  // tiles past it skip

  for (int k0 = 0; k0 < k_end; k0 += kFlashBK) {
    const int nk = min(kFlashBK, Sk - k0);
    for (int t = tid; t < kFlashBK * kVecPerRow; t += kFlashThreads) {
      const int j = t / kVecPerRow, c = t % kVecPerRow;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (j < nk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + k0 + j) * KVH + kvh) * D;
        kv4 = reinterpret_cast<const float4*>(k + off)[c];
        vv4 = reinterpret_cast<const float4*>(v + off)[c];
      }
      reinterpret_cast<float4*>(k_s + j * D)[c] = kv4;
      reinterpret_cast<float4*>(v_s + j * D)[c] = vv4;
    }
    for (int j = tid; j < kFlashBK; j += kFlashThreads) {
      live[j] = (j < nk && mask != nullptr)
                    ? mask[static_cast<size_t>(b) * Sk + k0 + j] : 1.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kFlashChunk) {
      float sc[kFlashChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kFlashChunk; ++jj) {
        const int j = j0 + jj;  // uniform across the block: shuffles are safe
        const float* kr = k_s + j * D;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) dot += qf[i] * kr[i * kFlashTPR + sub];
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        float s;
        if (j >= nk) {
          s = -CUDART_INF_F;  // past Sk: not a key at all
        } else if (!(live[j] > 0.f) || (causal && k0 + j > qpos)) {
          s = kNegInf;
        } else {
          s = dot * scale;
        }
        sc[jj] = s;
        cmax = fmaxf(cmax, s);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kFlashChunk; ++jj) {
        const float p = __expf(sc[jj] - m_new);
        l += p;
        const float* vr = v_s + (j0 + jj) * D;
#pragma unroll
        for (int i = 0; i < DP; ++i) acc[i] += p * vr[i * kFlashTPR + sub];
      }
      m = m_new;
    }
    __syncthreads();  // the next tile overwrites k_s / v_s
  }

  if (row_ok) {
    const float inv = l == 0.f ? 1.f : 1.f / l;
    float* orow = out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) orow[i * kFlashTPR + sub] = acc[i] * inv;
  }
}

template <int D>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const float* mask,
                             void* out, int B, int Sq, int Sk, int H, int KVH, float scale,
                             int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(kFlashBK) * D + kFlashBK) * sizeof(float);
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kFlashBQ - 1) / kFlashBQ, H, B);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), Sq, Sk, H, KVH, scale, causal, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_flash(int dtype, const void* q, const void* k, const void* v,
                         const float* mask, void* out, int B, int Sq, int Sk, int H,
                         int KVH, float scale, int causal, int q_offset, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_flash_tc<D>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal,
                              q_offset, st);
  }
  if (dtype == kFloat32) {
    return launch_flash_f32<D>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal,
                               q_offset, st);
  }
  return cudaErrorInvalidValue;
}

// registers, local (spilled) bytes, dynamic shared bytes and resident
// blocks per SM of the bf16 instance
template <int D>
cudaError_t flash_tc_info(int* info) {
  using Tile = TcTile<D>;
  const void* fn = reinterpret_cast<const void*>(flash_tc_kernel<D>);
  cudaError_t err = allow_smem(flash_tc_kernel<D>, Tile::kSmem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(Tile::kSmem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, Tile::kThreads,
                                                       Tile::kSmem);
}

#define KARANTA_FLASH_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(128)

}  // namespace karanta

// C interface (loaded with ctypes). q/out contiguous (B, Sq, H, D), k/v
// contiguous (B, Sk, KVH, D), of the type `dtype` names; mask float32 (B, Sk)
// or null. Returns the CUDA error code of the launch.
extern "C" int karanta_flash_attention(const void* q, const void* k, const void* v,
                                       const float* mask, void* out, int B, int Sq,
                                       int Sk, int H, int KVH, int D, float scale,
                                       int causal, int q_offset, int dtype,
                                       void* stream) {
  if (KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define KARANTA_CASE(d)                                                                  \
  case d:                                                                                \
    return static_cast<int>(karanta::launch_flash<d>(dtype, q, k, v, mask, out, B, Sq, \
                                                     Sk, H, KVH, scale, causal,          \
                                                     q_offset, st));
    KARANTA_FLASH_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// info[4] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the bf16 instance for
// head dim D. Returns the CUDA error code.
extern "C" int karanta_flash_attention_info(int D, int* info) {
  switch (D) {
#define KARANTA_CASE(d) \
  case d:               \
    return static_cast<int>(karanta::flash_tc_info<d>(info));
    KARANTA_FLASH_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
