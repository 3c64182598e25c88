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
// cores' 989 TFLOP/s in bf16. The exponentials come next: the card does 16
// ex2 a clock an SM, and a score costs one ex2 beside 4 D flops of
// products, so at the clock that gives 989 TFLOP/s they take about 63/D of
// the tensor-core time (79% at D = 80, 49% at D = 128). A kernel that ran
// softmax and products one after the other could not pass about 55% of
// the bound at D = 80.
//
// The bf16 instance (flash_wgmma_kernel) is warp-specialised for Hopper.
// A block of three warpgroups owns 128 query rows of one (batch, head).
// Warpgroup 0 is the producer: after setmaxnreg.dec to 24 registers, one
// of its threads loads Q once and then K, V and the mask slice tile by tile
// with TMA (cp.async.bulk.tensor) into a ring of 128-key stages (2 at D =
// 128, 3 below), each with a full and an empty mbarrier; the tensor maps are
// encoded on the host for every call, with the BSHD strides, so a box is
// one head's rows. Warpgroups 1 and 2 are consumers of 64 rows each, at 240
// registers after setmaxnreg.inc: S = Q.K^T is wgmma m64n128k16 with both
// operands in shared memory; the softmax runs on the accumulator
// fragments (scale * log2(e) folded in; a masked key's score is
// fma(s, scale, -1e30); row max and sum over the quad of lanes that share
// a row; one ex2 a score); P is rounded to bf16 in registers (the JAX
// kernel's p.astype(v.dtype); l sums the unrounded P) and is the register
// A operand of O += P.V, V the shared B operand, N-major through the
// descriptor's transpose bit. The two consumers take turns to issue their
// products under named barriers 1 and 2, so one's softmax runs while the
// other's products do; each issues tile i's Q.K^T together with tile
// i - 1's P.V and waits for the scores alone (wgmma.wait_group 1) before
// its softmax. One block an SM; one fixed order of sums and no atomics,
// and no tile or split depends on B, H or the grid, so a call gives the
// same bits as any other and a batch the bits of its pages called alone.
// Causal key tiles wholly above the block's diagonal are skipped and the
// diagonal masked only on the tiles that cross a warpgroup's first row;
// query tiles are issued longest first, heads fastest. TMA zero-fills rows
// past Sq and Sk; the kernel masks keys past Sk itself and guards its
// stores past Sq. The mask's box starts at the 16-byte aligned element
// below the tile's first key (TMA's rule), four elements longer.
//
// Operand tiles are column planes, [plane][row][width], each plane as wide
// as its swizzle, so that no head dim is padded: Q and K in planes of 64
// columns (128-byte swizzle) and, at D = 80, one of 16 (32-byte swizzle);
// V in planes of 64 columns, or of 16 at D = 80, so P.V is one product a
// key step; D = 16 and 32 are one plane. Measured on an NVIDIA H100 80GB
// HBM3 at its 700 W limit (bench/flash_ab.py, variants built from copies of
// this file, each timed in turns with this one; PERF.md):
// 16-column planes at every D ran as fast at D = 80 (vision (1, 5120, 16,
// 80): 0.3221-0.3247 ms against 0.3183-0.3248) and 10-12% slower at D =
// 128 (prefill (1, 1408, 28/4, 128): 0.0470-0.0474 against 0.0423-0.0426);
// 64-column planes zero-filled to 128 at D = 80 (60% more Q.K^T) ran
// 0.3426-0.3500 ms against the 16-column planes' 0.3623-0.3831 before the
// mask became an fma, which took the vision shape from 0.36-0.38 to 0.32.
// The turns under the named barriers are worth 5-10% (without them 0.3899-
// 0.4049 ms at the vision shape against 0.3623-0.3831). ptxas schedules the
// softmax's exponentials after the wait for the warpgroup's own P.V, not
// under it; a copy whose stage release depends on the row sums keeps them
// under it and ran 4% slower (0.3193-0.3203 against 0.3065-0.3072). At the
// vision shape a consumer warpgroup spends 2,904 cycles a key tile, 56% of
// them in the softmax, 22% issuing products, 11% waiting for tiles, turns
// and products (bench/flash_trace.py): the softmax's issue and the ex2
// unit, shared by the two consumers' warps on each scheduler, bound it.
//
// The float32 instance (flash_f32_kernel) runs on the tensor cores too, in
// 3xTF32, as PyTorch's float32 SDPA does (CUTLASS's OpMultiplyAddFastF32).
// One TF32 pass keeps 10 mantissa bits: a numpy model against float64
// attention at (4, 197, 197, 6, 64) gives 6.4e-4, 30x the float32 tests'
// 2e-5. Split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), an operand
// keeps about 22 bits, and hi.hi + hi.lo + lo.hi (lo.lo, 2^-22 of the
// product, dropped) gives 1.3e-6 there, plain float32 8.9e-7
// (tests/test_torch_attention.py holds the same model). The tensor cores
// truncate as they add into an accumulator, so a long chain of products
// drifts: every kGroup = 2 k-steps sum into a fresh accumulator that one
// rounded float32 add takes into S or O (every product chained into S and
// O, a sharply peaked softmax at D = 80 and 128 read 1.9e-5 to 3.1e-5 from
// the plain version on an H100, over the tests' 2e-5; grouped 1.5e-5 to
// 1.6e-5, as the CUDA-core loop it replaces read). The structure is the bf16 instance's: 4 warps of 32 query rows (two
// 16-row m-tiles; one above D = 64), Q.K^T and P.V as mma.sync.m16n8k8 TF32,
// the scores in accumulator fragments with scale * log2(e) folded in, one
// ex2 a score, quad shuffles for the row max and sum, one rescale of O a
// tile, K/V tiles (64 keys at D <= 32, 32 above) and the tile's mask slice
// through a cp.async ring. Rows are padded to D + 4 floats, which makes
// every 32-bit fragment load conflict-free. Q stays in shared memory and is
// split as its fragments are read; the block splits each landed K and V tile
// once, hi in place and lo into a plane of its own, which measured faster
// on an H100 SXM than each warp splitting the fragments it reads (0.0671
// against 0.0864 ms at the ViT's (32, 197, 6, 64) with 32-key tiles, where
// the warp's split spills, and 0.1865 against 0.2013 at SegFormer stage 1
// with 64-key tiles); 128-row blocks beat 64-row ones at every classifier
// shape, the ViT's 197 rows included. 255 registers a thread at D = 32 and 64, no spills, two
// blocks an SM. P stays in registers, split unrounded, and is the A operand
// of P.V without shuffles: a lane's accumulator holds keys 2t and 2t + 1 of
// an 8-key n-tile where the A operand wants columns t and t + 4, and since
// P.V sums over keys, column t is taken as key 2t and t + 4 as key 2t + 1,
// V's B fragment read from those two rows. D = 8 is one k-step of Q.K^T and
// one n-tile of P.V.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace karanta {

// ---------------------------------------------------------------------------
// bf16: TMA, wgmma, warp specialisation
// ---------------------------------------------------------------------------

// One block: kBM = 128 query rows of one (batch, head). Warpgroup 0 is the
// producer (one thread issues every TMA load), warpgroups 1 and 2 the
// consumers, 64 rows each. K and V come in kBN-key tiles through a ring of
// kStages, the tile's mask slice beside K. An operand tile is stored as
// column planes, [plane][row][width], each plane as wide as its swizzle:
// Q and K as kFull planes of kWide = min(D, 64) columns and, at D = 80, one
// more of kRest = 16 columns, so no head dim is padded; V as planes of
// kVWide columns (16 at D = 80), so P.V is one product a key step.
template <int D>
struct WgTile {
  static constexpr int kWide = D >= 64 ? 64 : D;
  static constexpr int kFull = D / kWide;
  static constexpr int kRest = D % kWide;
  static constexpr int kVWide = kRest > 0 ? kRest : kWide;
  static constexpr int kBM = 128, kBN = 128;
  static constexpr int kStages = D >= 128 ? 2 : 3;
  static constexpr int kThreads = 384;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kTileBytes = kBN * D * 2;  // one K or V tile
  // the mask slice's box starts at the 16-byte aligned element below the
  // tile's first key (b Sk need not be a multiple of 4), so it is 4 longer
  static constexpr int kMaskBox = kBN + 4;
  static constexpr uint32_t kMaskBytes = kMaskBox * 4;
  static constexpr uint32_t kMaskSlot = (kMaskBytes + 127) / 128 * 128;
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
  static constexpr uint32_t kOffMask = kOffV + kStages * kTileBytes;
  static constexpr uint32_t kOffBar = kOffMask + kStages * kMaskSlot;
  static constexpr int kBars = 1 + 4 * kStages;
  // + 1024: the base is rounded up to the swizzle atoms' 1024-byte alignment
  static constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;

  // the byte offset of column `col`'s plane in a tile of `rows` rows, its
  // width, and the column's byte offset inside the plane's rows
  __device__ static constexpr uint32_t plane_base(int col, int rows) {
    return (col / kWide) * rows * kWide * 2;
  }
  __device__ static constexpr int plane_width(int col) {
    return col < kFull * kWide ? kWide : kRest;
  }
  __device__ static constexpr uint32_t in_row(int col) { return (col % kWide) * 2; }
};

// S = Q K^T of one warpgroup's 64 rows (from row q_row of Q's planes) over
// the depth's 16-wide k-steps, Q and K K-major; a k-step is 32 bytes along
// its plane's rows
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[WgTile<D>::kBN / 2], uint32_t q_addr,
                                         int q_row, uint32_t k_addr) {
  using T = WgTile<D>;
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = 16 * kk, w = T::plane_width(col);
    const uint64_t da =
        kmajor_desc(q_addr + T::plane_base(col, T::kBM) + q_row * 2 * w + T::in_row(col), w);
    const uint64_t db = kmajor_desc(k_addr + T::plane_base(col, T::kBN) + T::in_row(col), w);
    wgmma_ss<T::kBN>(s, da, db, kk > 0);
  }
  wgmma_commit();
  reg_fence(s);
}

// O += P V over the tile's 16-key steps: P from registers, V N-major (a
// step starts 16 rows into the planes, whose N atoms lie a plane apart,
// the leading byte offset)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[WgTile<D>::kBN / 16][4],
                                         uint32_t v_addr) {
  using T = WgTile<D>;
  constexpr uint32_t kRow = 2 * T::kVWide;
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::kBN / 16; ++kk) {
    wgmma_rs_tb<D>(o, p[kk],
                   gmma_desc(v_addr + kk * 16 * kRow, T::kBN * kRow, 8 * kRow,
                             plane_layout(T::kVWide)),
                   1);
  }
  wgmma_commit();
  reg_fence(o);
}

// One tile's scores into the log2 domain and masked: a masked key's score
// is fma(s, scale, -1e30) = -1e30 (the scores are far below an ulp of
// 1e30), keys above the diagonal -1e30, keys past Sk -inf. Then the online
// softmax over the quad of lanes that share a row: the new max, alpha =
// exp2(old - new), one ex2 a score in place, l rescaled and summed. The
// lane holds rows (positions) pos0 and pos0 + 8, columns k0 + 8j + 2t + e.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&s)[WgTile<D>::kBN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const float* live, int k0, int Sk, int t,
                                             int pos0, bool diag, float scale_log2) {
  constexpr int kBN = WgTile<D>::kBN;
  if (live != nullptr) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float b0 = live[8 * j + 2 * t] > 0.f ? 0.f : kNegInf;
      const float b1 = live[8 * j + 2 * t + 1] > 0.f ? 0.f : kNegInf;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[4 * j + 2 * i] = fmaf(s[4 * j + 2 * i], scale_log2, b0);
        s[4 * j + 2 * i + 1] = fmaf(s[4 * j + 2 * i + 1], scale_log2, b1);
      }
    }
  } else {
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) s[x] *= scale_log2;
  }
  if (diag) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (k0 + 8 * j + 2 * t + (x & 1) > pos0 + 8 * (x >> 1)) s[4 * j + x] = kNegInf;
      }
    }
  }
  if (k0 + kBN > Sk) {  // the last tile: keys past Sk are not keys at all
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (k0 + 8 * j + 2 * t + (x & 1) >= Sk) s[4 * j + x] = -CUDART_INF_F;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[i] = fast_exp2(m[i] - mx);
    m[i] = mx;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int x = 0; x < kBN / 2; ++x) {
    s[x] = fast_exp2(s[x] - m[(x >> 1) & 1]);
    l[(x >> 1) & 1] += s[x];  // this lane's share of the row sum
  }
}

// P rounded to bf16 as the A operand of P.V (the JAX kernel's
// p.astype(v.dtype)); l summed the unrounded P. Columns 16kk..16kk+15 are
// the A operand of k-step kk.
template <int D>
__device__ __forceinline__ void scores_to_p(const float (&s)[WgTile<D>::kBN / 2],
                                            uint32_t (&p)[WgTile<D>::kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < WgTile<D>::kBN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
}

// lane 0 of each consumer warp frees a stage once the whole warp is done
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// one tile (`rows` rows from `row`) of a tensor into its planes: the full
// planes through `wide`, the last 16 columns at D = 80 through `rest`
template <int D>
__device__ __forceinline__ void load_planes(unsigned char* dst, const CUtensorMap* wide,
                                            const CUtensorMap* rest, uint64_t* bar, int rows,
                                            int row, int head, int b) {
  using T = WgTile<D>;
#pragma unroll
  for (int p = 0; p < T::kFull; ++p) {
    tma_load_4d(dst + p * rows * T::kWide * 2, wide, bar, p * T::kWide, row, head, b);
  }
  if constexpr (T::kRest > 0) {
    tma_load_4d(dst + T::kFull * rows * T::kWide * 2, rest, bar, T::kFull * T::kWide, row,
                head, b);
  }
}

// Maps: q and k through boxes of kWide columns, q2 and k2 their last 16
// columns at D = 80 (unused otherwise), v through boxes of kVWide columns,
// the mask as one row of B Sk values.
template <int D>
__global__ void __launch_bounds__(WgTile<D>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_q2,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_k2,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_mask, int has_mask,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KVH,
                       float scale_log2, int causal, int q_offset) {
  using T = WgTile<D>;
  constexpr int kBM = T::kBM, kBN = T::kBN, kStages = T::kStages;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + T::kOffK;
  unsigned char* v_s = smem + T::kOffV;
  float* mask_s = reinterpret_cast<float*>(smem + T::kOffMask);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + T::kOffBar);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBM;
  const int kvh = h / (H / KVH);
  const int k_end = causal ? min(Sk, q_offset + q0 + kBM) : Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  if (tid == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // lane 0 of each consumer warp
      mbar_init(&empty_v[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: Q once, then K (with its mask slice) and V tile by tile
    regs_dec<T::kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(full_q, T::kQBytes);
      load_planes<D>(q_s, &tm_q, &tm_q2, full_q, kBM, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;  // first pass: free
        mbar_wait(&empty_k[s], parity);
        mbar_expect_tx(&full_k[s], T::kTileBytes + (has_mask ? T::kMaskBytes : 0));
        load_planes<D>(k_s + s * T::kTileBytes, &tm_k, &tm_k2, &full_k[s], kBN, i * kBN, kvh, b);
        if (has_mask) {
          tma_load_1d(mask_s + s * (T::kMaskSlot / 4), &tm_mask, &full_k[s],
                      (b * Sk + i * kBN) & ~3);
        }
        mbar_wait(&empty_v[s], parity);
        mbar_expect_tx(&full_v[s], T::kTileBytes);
#pragma unroll
        for (int p = 0; p < D / T::kVWide; ++p) {
          tma_load_4d(v_s + s * T::kTileBytes + p * kBN * T::kVWide * 2, &tm_v, &full_v[s],
                      p * T::kVWide, i * kBN, kvh, b);
        }
      }
    }
  } else {
    regs_inc<T::kConsumerRegs>();
    const int cw = wg - 1;  // consumer warpgroup: rows 64 cw .. 64 cw + 63
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = 64 * cw + 16 * warp + g;  // the lane's rows: row0, row0 + 8
    const int pos0 = q_offset + q0 + row0;
    const int wg_first = q_offset + q0 + 64 * cw;  // the warpgroup's lowest position
    const uint32_t q_addr = smem_u32(q_s), k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
    // the lane's mask values start (b Sk) % 4 into each slot
    const float* live = has_mask ? mask_s + ((b * Sk) & 3) : nullptr;

    float s[kBN / 2], o[D / 2];
    uint32_t p[kBN / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) s[x] = 0.f;
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;

    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so one's softmax runs under the other's products;
    // the second waits for the first's first turn.
    if (cw == 1) named_arrive(1, 256);
    mbar_wait(full_q, 0);

    mbar_wait(&full_k[0], 0);
    named_sync(1 + cw, 256);
    issue_qk<D>(s, q_addr, 64 * cw, k_addr);
    named_arrive(2 - cw, 256);
    wgmma_wait<0>();
    reg_fence(s);
    softmax_tile<D>(s, m, l, alpha, live, 0, Sk, t, pos0, causal && kBN - 1 > wg_first,
                    scale_log2);
    release(&empty_k[0], lane);
    scores_to_p<D>(s, p);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, pst = (i - 1) % kStages;
      mbar_wait(&full_k[st], (i / kStages) & 1);
      named_sync(1 + cw, 256);
      issue_qk<D>(s, q_addr, 64 * cw, k_addr + st * T::kTileBytes);  // under the softmax below
      rescale<D>(o, alpha);
      mbar_wait(&full_v[pst], ((i - 1) / kStages) & 1);
      issue_pv<D>(o, p, v_addr + pst * T::kTileBytes);
      named_arrive(2 - cw, 256);
      wgmma_wait<1>();  // tile i's scores landed; P.V of tile i - 1 may still run
      reg_fence(s);
      softmax_tile<D>(s, m, l, alpha, has_mask ? live + st * (T::kMaskSlot / 4) : nullptr,
                      i * kBN, Sk, t, pos0, causal && (i + 1) * kBN - 1 > wg_first,
                      scale_log2);
      release(&empty_k[st], lane);
      wgmma_wait<0>();
      reg_fence(o);
      release(&empty_v[pst], lane);
      scores_to_p<D>(s, p);
    }
    const int lst = (n_tiles - 1) % kStages;
    rescale<D>(o, alpha);
    mbar_wait(&full_v[lst], ((n_tiles - 1) / kStages) & 1);
    named_sync(1 + cw, 256);
    issue_pv<D>(o, p, v_addr + lst * T::kTileBytes);
    if (cw == 0) named_arrive(2, 256);  // the second's last turn; the first has none left
    wgmma_wait<0>();
    reg_fence(o);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = sum == 0.f ? 1.f : 1.f / sum;
      const int row = q0 + row0 + 8 * i;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// the float32 mask (B, Sk) as one row of B Sk values, boxes of `n` (a box
// must start at a 16-byte aligned element)
inline CUresult encode_mask(CUtensorMap* map, const float* mask, int B, int Sk, int n) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(B) * Sk};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(n)};
  const cuuint32_t step[1] = {1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(mask), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// 0, the launch's CUDA error code, or the driver's code of a failed encode
template <int D>
int launch_flash_wgmma(const void* q, const void* k, const void* v, const float* mask, void* out,
                       int B, int Sq, int Sk, int H, int KVH, float scale, int causal,
                       int q_offset, cudaStream_t stream) {
  using T = WgTile<D>;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv, tq2, tk2, tm;
  memset(&tq2, 0, sizeof(tq2));
  memset(&tk2, 0, sizeof(tk2));
  memset(&tm, 0, sizeof(tm));
  CUresult r = encode_bshd(&tq, q, B, Sq, H, D, T::kWide, T::kBM);
  if (r == CUDA_SUCCESS) r = encode_bshd(&tk, k, B, Sk, KVH, D, T::kWide, T::kBN);
  if (r == CUDA_SUCCESS) r = encode_bshd(&tv, v, B, Sk, KVH, D, T::kVWide, T::kBN);
  if (T::kRest > 0) {
    if (r == CUDA_SUCCESS) r = encode_bshd(&tq2, q, B, Sq, H, D, T::kRest, T::kBM);
    if (r == CUDA_SUCCESS) r = encode_bshd(&tk2, k, B, Sk, KVH, D, T::kRest, T::kBN);
  }
  if (r == CUDA_SUCCESS && mask != nullptr) r = encode_mask(&tm, mask, B, Sk, T::kMaskBox);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = allow_smem(kernel, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, (Sq + T::kBM - 1) / T::kBM, B);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(tq, tq2, tk, tk2, tv, tm, mask != nullptr,
                                                  static_cast<__nv_bfloat16*>(out), Sq, Sk, H,
                                                  KVH, scale * kLog2e, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: tensor cores in 3xTF32
// ---------------------------------------------------------------------------

// one block: kWarps warps of 16 * kMT query rows each; kBK-key tiles in a
// ring of kStages; the block splits each landed K and V tile into TF32 hi
// (in place) and lo planes; kGroup 8-wide k-steps sum into a fresh
// accumulator before one float32 add takes them into S or O (see the header)
template <int D>
struct F32Tile {
  static constexpr int kWarps = 4;
  static constexpr int kMT = D <= 64 ? 2 : 1;
  static constexpr int kBK = D <= 32 ? 64 : 32;
  static constexpr int kStages = D >= 128 ? 2 : 2 + (kBK == 32);
  static constexpr int kGroup = 2;
  static constexpr int kBQ = kWarps * 16 * kMT;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kPitch = D + 4;  // shared row pitch (floats)
  static constexpr int kTileElems = kBK * kPitch;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kBQ) * kPitch + 2 * (kStages + 1) * kTileElems + kStages * kBK) *
      sizeof(float);
};

// the landed 16-byte chunk at p: hi = tf32(x) in place, lo = tf32(x - hi)
// to lo
__device__ __forceinline__ void split_chunk(float* p, float* lo) {
  float4 x = *reinterpret_cast<float4*>(p);
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// acc += the sum over the group's first `steps` k-steps f of A_f B_f in
// 3xTF32, summed into a fresh accumulator that one float32 add then takes
// into acc
template <int kGroup>
__device__ __forceinline__ void mma_3xtf32_group(float (&acc)[4],
                                                 const uint32_t (&a_hi)[kGroup][4],
                                                 const uint32_t (&a_lo)[kGroup][4],
                                                 const uint32_t (&b_hi)[kGroup][2],
                                                 const uint32_t (&b_lo)[kGroup][2],
                                                 int steps) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int f = 0; f < kGroup; ++f) {
    if (f < steps) mma_3xtf32(c, a_hi[f], a_lo[f], b_hi[f], b_lo[f]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     float* __restrict__ out, int Sq, int Sk, int H, int KVH,
                     float scale_log2, int causal, int q_offset) {
  using Tile = F32Tile<D>;
  constexpr int P = Tile::kPitch, kMT = Tile::kMT, kBK = Tile::kBK, kBQ = Tile::kBQ;
  constexpr int kStages = Tile::kStages, kThreads = Tile::kThreads;
  constexpr int kGroup = Tile::kGroup;
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  constexpr int kN = kBK / 8;     // score n-tiles (P.V k-steps) per key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);     // [BQ][P]
  float* k_s = q_s + kBQ * P;                          // [stages][BK][P]
  float* v_s = k_s + kStages * Tile::kTileElems;       // [stages][BK][P]
  float* live_s = v_s + kStages * Tile::kTileElems;    // [stages][BK]
  float* klo_s = live_s + kStages * kBK;               // [BK][P]
  float* vlo_s = klo_s + Tile::kTileElems;             // [BK][P]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int kvh = h / (H / KVH);
  const size_t q_pitch = static_cast<size_t>(H) * D;
  const size_t kv_pitch = static_cast<size_t>(KVH) * D;
  const float* q_base = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* k_base = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* v_base = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* mask_row = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Sk;

  const int k_end = causal ? min(Sk, q_offset + q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  // rows past Sq and keys past Sk are zero-filled (src-size 0 from row 0)
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool ok = q0 + r < Sq;
    cp_async16(q_s + r * P + col, q_base + (ok ? q0 + r : 0) * q_pitch + col, ok ? 16 : 0);
  }
  auto load_tile = [&](int tile) {
    const int k0 = tile * kBK, stage = tile % kStages;
    float* ks = k_s + stage * Tile::kTileElems;
    float* vs = v_s + stage * Tile::kTileElems;
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
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

  // this lane's fragment offsets (floats): Q as A of Q.K^T (row g, column
  // t; +8 rows for a1/a3, +4 columns for a2/a3), K as B of Q.K^T (key g,
  // feature t; +4 for b1), V as B of P.V (key 2t, feature g; key 2t + 1
  // for b1: P's columns are relabelled, see below)
  const int w0 = warp * 16 * kMT;  // the warp's first row in the block
  const float* q_frag = q_s + (w0 + g) * P + t;
  const int k_lane = g * P + t;
  const int v_lane = 2 * t * P + g;

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
    float* ks = k_s + stage * Tile::kTileElems;
    float* vs = v_s + stage * Tile::kTileElems;
    const float* live = live_s + stage * kBK;
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int off = (c / kChunks) * P + (c % kChunks) * 4;
      split_chunk(ks + off, klo_s + off);
      split_chunk(vs + off, vlo_s + off);
    }
    __syncthreads();

    // S = Q K^T in 3xTF32: 16 kMT rows x kBK keys per warp, in accumulator
    // fragments; Q is split as it is read. Each group of kGroup 8-feature
    // steps sums into a fresh accumulator, then into S.
    float s[kMT][kN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kN; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    }
#pragma unroll
    for (int kg = 0; kg < D / 8; kg += kGroup) {
      const int steps = min(kGroup, D / 8 - kg);
      uint32_t a_hi[kMT][kGroup][4], a_lo[kMT][kGroup][4];
#pragma unroll
      for (int f = 0; f < kGroup; ++f) {
        if (f >= steps) break;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(q_frag[(16 * mt + 8 * (i & 1)) * P + 4 * (i >> 1) + 8 * (kg + f)],
                       a_hi[mt][f][i], a_lo[mt][f][i]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t b_hi[kGroup][2], b_lo[kGroup][2];
#pragma unroll
        for (int f = 0; f < kGroup; ++f) {
          if (f >= steps) break;
          const int off = j * 8 * P + k_lane + 8 * (kg + f);
          b_hi[f][0] = __float_as_uint(ks[off]);
          b_lo[f][0] = __float_as_uint(klo_s[off]);
          b_hi[f][1] = __float_as_uint(ks[off + 4]);
          b_lo[f][1] = __float_as_uint(klo_s[off + 4]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_3xtf32_group<kGroup>(s[mt][j], a_hi[mt], a_lo[mt], b_hi, b_lo, steps);
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

    // O += P V in 3xTF32, one 8-key step per score n-tile j, kGroup steps
    // to a fresh accumulator. The lane holds P's keys 2t and 2t + 1 (c0/c1,
    // c2/c3), where the A operand wants columns t and t + 4: P.V sums over
    // keys, so column t is taken to be key 2t and column t + 4 key 2t + 1,
    // and V's B fragment is read from those two keys' rows. P is split in
    // registers, unrounded.
#pragma unroll
    for (int jg = 0; jg < kN; jg += kGroup) {
      const int steps = min(kGroup, kN - jg);
      uint32_t a_hi[kMT][kGroup][4], a_lo[kMT][kGroup][4];
#pragma unroll
      for (int f = 0; f < kGroup; ++f) {
        if (f >= steps) break;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          split_tf32(s[mt][jg + f][0], a_hi[mt][f][0], a_lo[mt][f][0]);
          split_tf32(s[mt][jg + f][2], a_hi[mt][f][1], a_lo[mt][f][1]);
          split_tf32(s[mt][jg + f][1], a_hi[mt][f][2], a_lo[mt][f][2]);
          split_tf32(s[mt][jg + f][3], a_hi[mt][f][3], a_lo[mt][f][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b_hi[kGroup][2], b_lo[kGroup][2];
#pragma unroll
        for (int f = 0; f < kGroup; ++f) {
          if (f >= steps) break;
          const int off = (jg + f) * 8 * P + v_lane + 8 * n;
          b_hi[f][0] = __float_as_uint(vs[off]);
          b_lo[f][0] = __float_as_uint(vlo_s[off]);
          b_hi[f][1] = __float_as_uint(vs[off + P]);
          b_lo[f][1] = __float_as_uint(vlo_s[off + P]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_3xtf32_group<kGroup>(o[mt][n], a_hi[mt], a_lo[mt], b_hi, b_lo, steps);
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
      float* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[mt][n][2 * i] * inv, o[mt][n][2 * i + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const float* mask,
                             void* out, int B, int Sq, int Sk, int H, int KVH, float scale,
                             int causal, int q_offset, cudaStream_t stream) {
  using Tile = F32Tile<D>;
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (Sq + Tile::kBQ - 1) / Tile::kBQ, B);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), Sq, Sk, H, KVH, scale * kLog2e, causal, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <int D>
int launch_flash(int dtype, const void* q, const void* k, const void* v, const float* mask,
                 void* out, int B, int Sq, int Sk, int H, int KVH, float scale, int causal,
                 int q_offset, cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_flash_wgmma<D>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal,
                                 q_offset, st);
  }
  if (dtype == kFloat32) {
    return static_cast<int>(launch_flash_f32<D>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale,
                                                causal, q_offset, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// registers, local (spilled) bytes, dynamic shared bytes and resident
// blocks per SM of one instance
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, size_t smem, int* info) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_smem(kernel, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, threads, smem);
}

template <int D>
cudaError_t flash_f32_info(int* info) {
  return kernel_info(flash_f32_kernel<D>, F32Tile<D>::kThreads, F32Tile<D>::kSmem, info);
}

template <int D>
cudaError_t flash_info(int dtype, int* info) {
  if (dtype == kBFloat16) {
    return kernel_info(flash_wgmma_kernel<D>, WgTile<D>::kThreads, WgTile<D>::kSmem, info);
  }
  if (dtype == kFloat32) return flash_f32_info<D>(info);
  return cudaErrorInvalidValue;
}

#define KARANTA_FLASH_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(128)

}  // namespace karanta

// C interface (loaded with ctypes). q/out contiguous (B, Sq, H, D), k/v
// contiguous (B, Sk, KVH, D), of the type `dtype` names; mask float32 (B, Sk)
// or null, all 16-byte aligned. D is one of KARANTA_FLASH_HEAD_DIMS, or 8 in
// float32. Returns 0, the CUDA error code of the launch, or (bf16) the
// driver's CUresult of a tensor map it could not encode.
extern "C" int karanta_flash_attention(const void* q, const void* k, const void* v,
                                       const float* mask, void* out, int B, int Sq,
                                       int Sk, int H, int KVH, int D, float scale,
                                       int causal, int q_offset, int dtype,
                                       void* stream) {
  if (KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 8) {  // float32 only (a bf16 tile needs 16 dims): tiny SegFormer heads
    if (dtype != karanta::kFloat32) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(karanta::launch_flash_f32<8>(q, k, v, mask, out, B, Sq, Sk, H,
                                                         KVH, scale, causal, q_offset, st));
  }
  switch (D) {
#define KARANTA_CASE(d)                                                                  \
  case d:                                                                                \
    return karanta::launch_flash<d>(dtype, q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, \
                                    causal, q_offset, st);
    KARANTA_FLASH_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// info[4] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the instance of the
// type `dtype` names for head dim D. Returns the CUDA error code.
extern "C" int karanta_flash_attention_info(int D, int dtype, int* info) {
  if (D == 8) {
    if (dtype != karanta::kFloat32) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(karanta::flash_f32_info<8>(info));
  }
  switch (D) {
#define KARANTA_CASE(d) \
  case d:               \
    return static_cast<int>(karanta::flash_info<d>(dtype, info));
    KARANTA_FLASH_HEAD_DIMS(KARANTA_CASE)
#undef KARANTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// regs[2] = the registers a thread of the bf16 instance's producer and of
// its consumer warpgroups holds after setmaxnreg (the same at every D)
extern "C" int karanta_flash_attention_roles(int* regs) {
  regs[0] = karanta::WgTile<16>::kProducerRegs;
  regs[1] = karanta::WgTile<16>::kConsumerRegs;
  return 0;
}
