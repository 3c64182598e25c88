// Fused int8-KV append + decode attention for one layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/decode_attention.py:887
// paged_decode_append_quant (body _decode_append_quant_kernel :673). For each
// slot b it writes this step's int8 K/V rows and their scales at cache_len[b]
// of layer `layer`, in place in the four cache tensors, then attends over
// rows [0, cache_len[b]) with the per-row scales folded into the scores and
// probabilities, and folds the new row in last, in float32 from its int8
// value times its scale (decode_attention.py:852-873).
//
// What bounds it on this card: every cache byte is used once per step for
// about G * 2 flops (G = query heads per kv head), so the kernel is bound by
// device-memory bytes: B * KVH * live_rows * (D + 2) * 2 per layer at
// 3.35 TB/s.
//
// The bf16 instance (decode_quant_tma_kernel) replaces the one that ran an
// int8 instance of #5's split body (decode_split.cuh until its int8 branch
// was deleted: a cp.async ring per warp, each landed 16-row chunk converted
// into a bf16 stage and read back with ldmatrix, blocks of (slot, kv head,
// run) in a grid whose last wave was ragged at B = 80), which reached 47%
// of the bound at B = 80 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
// Its design (its body and the pieces the verify kernels #4 and #7 share
// are in quant_tma.cuh; the megakernel's attention, #11, runs the same
// body, one walker a block):
//
// - Work. A (slot, kv head) segment's live rows are cut into chunks of
//   kQRows rows (one chunk when cache_len is 0) and the chunks into runs
//   of run_rows rows: the items, in a fixed order (every segment's first
//   run, then every second run, and so on). The grid is every block the
//   card holds at once, and walks the items in rounds: block i takes item
//   i of each even round and grid - 1 - i of each odd one. When all the
//   items fit the grid a block takes one; when they do not, a block goes
//   on to its next item as it finishes one (its producer starts that
//   item's loads while the consumers merge), and the order evens the
//   blocks' rows out (no block takes a first, longest run every round).
//   Every block reads cache_len and finds its items itself (the host
//   cannot read it without a sync). An item's rows and so its partial
//   depend only on its slot's length and run_rows, not on the other slots
//   or on which block took it. A segment of one run finishes in its block;
//   one of several (at most kQMaxPieces) is finished by the last of its
//   blocks, which a counter taken with acquire-release semantics names,
//   merging the runs' partials in run order in one round of loads, so two
//   calls give the same bits. The block of a segment's first run writes
//   the new row and its scales at cache_len (no block loads that row as a
//   key).
// - Loads. A producer warpgroup, one warp of it working, issues 1-D bulk
//   copies (cp.async.bulk, no tensor map) into a ring of kQStages stages,
//   each under a full and an empty mbarrier: a chunk's K rows, its V rows
//   and its two scale columns are each one contiguous range of the slab,
//   four copies a chunk, under an L2 evict-first policy (the cache is read
//   once a step); Q and this step's K/V rows come the same way, once an
//   item, into a two-slot ring of their own, beside the new row's two
//   scales (a producer lane's plain loads). Only the live rows are copied.
//   When M is not a multiple of 8 a slab's scales are not 16-byte aligned,
//   and the producer's lanes load the chunk's scales with plain loads. The
//   producer warpgroup gives its registers to the consumers (setmaxnreg),
//   so two blocks fit an SM without spills.
// - No bf16 stage. The consumer warpgroup's 4 warps share each stage, two
//   16-key tiles a warp, and turn the landed int8 bytes into mma.sync
//   operands in registers (each byte into a float 2^23 + 128 + b, minus
//   the bias, its upper half the exact bf16). Q.K^T sums over D in any
//   order, so D is permuted alike in Q's A fragments (read once an item)
//   and in the K bytes: lane (g, t) reads D / 4 contiguous bytes of key g
//   and of key g + 8 (two 16-byte loads at D = 128, taken in an order set
//   by g's parity, so a warp's loads meet no bank conflict). P.V sums over
//   the keys: P comes from the S accumulators as they are (the A operand),
//   and lane (g, t) reads D / 8 contiguous bytes of each of its four keys,
//   whose byte n and its pair's make the B operand of output column
//   g D / 8 + n (those reads meet 4-way bank conflicts, which cost less
//   than a stage would). A stage's scales are read beside the rows.
// - Stale bytes. Rows past a chunk's live rows are whatever the stage held
//   (NaN or inf scales included), so a dead key's score and its p * vsc are
//   selected away, never multiplied away.
// - Products on mma.sync.m16n8k16 (bf16, float32 accumulators), not wgmma:
//   the G <= 8 query heads would fill 8 of wgmma's 64 rows, and its B
//   operand would have to be bf16 in shared memory, the stage this design
//   removes. Each warp keeps an online softmax (log2 domain) and a float32
//   (m, l, O); p * vsc is rounded to bf16 before P.V, as the TPU kernel
//   rounds it (decode_attention.py:821-846), and l sums the unrounded p.
//   At an item's start the consumers compute the new row's score (while
//   the first chunk lands); at its end they merge their warps in shared
//   memory in a fixed order, then store a partial or finish: the new row
//   folded in float32 from its int8 values times its scales, then the
//   division.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (bench/flash_ab.py --kernel
// 3, the old instance built from its source and timed in turns; PERF.md
// has every shape): at B = 80 filled to 1,650 of 1,920 rows 0.0658 ms
// against 0.089 (63% of the 0.0414 ms bound), at B = 4 0.0106-0.0109 ms
// against 0.0138. Equal shares of the chunks in place of the items were
// 7% faster at B = 80 but cut a slot where the shares fell, so its bits
// depended on the other slots; a walk of one direction left blocks three
// first runs (0.0734 ms); runs of 256 or 512 rows at B = 80 cost more in
// item starts and merges (0.090 / 0.071 ms) than they gain in balance. A
// per-phase trace (bench/flash_trace.py --kernel 3) showed an item's
// start and end as the cost at small B; 64-row stages (one 16-key tile a
// warp) in rings of 3, 4 or 5 were slower than two 128-row stages; without
// the evict-first policy B = 80 took 6% longer.
//
// The float32 instance stays on the CUDA cores (the tensor cores would
// multiply in TF32): one block per (kv head, slot) owns that slab of the
// cache: it writes row cache_len itself and only ever reads rows below it,
// so no block reads a row that is being written and no other block touches
// the slab. Rows stream in chunks of 128, staged in shared memory with
// 16-byte loads; eight lanes share a 128-byte int8 row (16 bytes each), dot
// it against all G query heads held in registers and reduce with three
// shuffles; one warp per head turns the chunk's scores into probabilities
// (online softmax across chunks); then each thread owns one output dim and
// accumulates the chunk's int8 V column for all G heads. Dequantization
// happens in registers; the dequantized cache never exists.
#include "decode_rows.cuh"
#include "hopper.cuh"
#include "quant_tma.cuh"

namespace karanta {

constexpr int kDecThreads = 128;
constexpr int kDecChunk = 128;  // cache rows staged per chunk
constexpr int kDecLanesPerRow = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecThreads) decode_append_quant_kernel(
    const T* __restrict__ q,                                   // (B, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, KVH, D)
    const T* __restrict__ new_ks, const T* __restrict__ new_vs,          // (B, KVH)
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,  // (L, B, KVH, M, D)
    T* __restrict__ ks_cache, T* __restrict__ vs_cache,          // (L, B, KVH, M)
    const int* __restrict__ cache_len,                           // (B,)
    T* __restrict__ out,                                         // (B, KVH*G, D)
    int B, int KVH, int M, int layer, float scale) {
  constexpr int DL = D / kDecLanesPerRow;  // int8 dims per lane
  using Vec = typename Bytes<DL>::type;
  constexpr int kWarps = kDecThreads / 32;
  constexpr int kRowsPerPass = kWarps * (32 / kDecLanesPerRow);  // 16

  constexpr int kVecPerRow = D / 16;  // 16-byte vectors per int8 row
  __shared__ float q_s[G][D];
  __shared__ float p_s[G][kDecChunk];
  __shared__ float m_s[G], l_s[G], alpha_s[G], px_s[G];
  __shared__ __align__(16) int8_t k_s[kDecChunk * D];
  __shared__ __align__(16) int8_t v_s[kDecChunk * D];
  __shared__ float ksc_s[kDecChunk], vsc_s[kDecChunk];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = KVH * G;
  // rows already present; the engine keeps it below M, the clamp only
  // keeps a bad value from writing outside the slab
  const int len = min(max(cache_len[b], 0), M - 1);

  const size_t slab = ((static_cast<size_t>(layer) * B + b) * KVH + kvh) * M;
  int8_t* k_rows = k_cache + slab * D;
  int8_t* v_rows = v_cache + slab * D;
  T* k_sc = ks_cache + slab;
  T* v_sc = vs_cache + slab;
  const size_t nrow = static_cast<size_t>(b) * KVH + kvh;

  // 1. append: row `len` of this slab (read by nobody in this step)
  for (int d = tid; d < D; d += kDecThreads) {
    k_rows[static_cast<size_t>(len) * D + d] = new_k[nrow * D + d];
    v_rows[static_cast<size_t>(len) * D + d] = new_v[nrow * D + d];
  }
  if (tid == 0) {
    k_sc[len] = new_ks[nrow];
    v_sc[len] = new_vs[nrow];
  }

  for (int i = tid; i < G * D; i += kDecThreads) {
    q_s[i / D][i % D] = to_f<T>(q[(static_cast<size_t>(b) * H + kvh * G + i / D) * D + i % D]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int sub = lane % kDecLanesPerRow;   // which DL-wide slice of the row
  const int rg = lane / kDecLanesPerRow;    // row within the warp's pass
  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DL; ++i) qr[g][i] = q_s[g][sub * DL + i];
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  // 2. attend over rows [0, len), one chunk of rows at a time: the block
  //    stages the chunk's int8 K/V rows and scales in shared memory with
  //    16-byte loads (many in flight), then computes from there
  for (int c0 = 0; c0 < len; c0 += kDecChunk) {
    const int n = min(kDecChunk, len - c0);
    for (int t = tid; t < n * kVecPerRow; t += kDecThreads) {
      const size_t off = static_cast<size_t>(c0) * D + static_cast<size_t>(t) * 16;
      reinterpret_cast<uint4*>(k_s)[t] = *reinterpret_cast<const uint4*>(k_rows + off);
      reinterpret_cast<uint4*>(v_s)[t] = *reinterpret_cast<const uint4*>(v_rows + off);
    }
    for (int j = tid; j < n; j += kDecThreads) {
      ksc_s[j] = to_f<T>(k_sc[c0 + j]);
      vsc_s[j] = to_f<T>(v_sc[c0 + j]);
    }
    __syncthreads();

    for (int base = 0; base < n; base += kRowsPerPass) {
      const int jj = base + warp * (32 / kDecLanesPerRow) + rg;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (jj < n) {
        const Vec raw = *reinterpret_cast<const Vec*>(k_s + jj * D + sub * DL);
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
        const float ksc = ksc_s[jj];
#pragma unroll
        for (int g = 0; g < G; ++g) p_s[g][jj] = part[g] * ksc * scale;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, p_s[g][jj]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < n; jj += 32) {
        const float p = __expf(p_s[g][jj] - m_new);
        sum += p;
        p_s[g][jj] = p * vsc_s[jj];  // V scale folds into p
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= alpha_s[g];
      for (int jj = 0; jj < n; ++jj) {
        const float vv = static_cast<float>(v_s[jj * D + tid]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += p_s[g][jj] * vv;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows and p_s
  }

  // 3. fold in the new row, dequantized in float32
  const float nks = to_f<T>(new_ks[nrow]);
  for (int g = warp; g < G; g += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) {
      dot += q_s[g][d] * (static_cast<float>(new_k[nrow * D + d]) * nks);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) {
      const float s_x = dot * scale;
      const float m_new = fmaxf(m_s[g], s_x);
      const float p_x = __expf(s_x - m_new);
      const float alpha = __expf(m_s[g] - m_new);
      l_s[g] = alpha * l_s[g] + p_x;
      alpha_s[g] = alpha;
      px_s[g] = p_x;
    }
  }
  __syncthreads();
  if (tid < D) {
    const float nv = static_cast<float>(new_v[nrow * D + tid]) * to_f<T>(new_vs[nrow]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = acc[g] * alpha_s[g] + px_s[g] * nv;
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];
      out[(static_cast<size_t>(b) * H + kvh * G + g) * D + tid] = from_f<T>(a / l);
    }
  }
}

template <typename T, int D, int G>
cudaError_t launch_decode(const void* q, const int8_t* nk, const int8_t* nv,
                          const void* nks, const void* nvs, int8_t* kc, int8_t* vc,
                          void* ksc, void* vsc, const int* lens, void* out, int B,
                          int KVH, int M, int layer, float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  decode_append_quant_kernel<T, D, G><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), nk, nv, static_cast<const T*>(nks),
      static_cast<const T*>(nvs), kc, vc, static_cast<T*>(ksc), static_cast<T*>(vsc),
      lens, static_cast<T*>(out), B, KVH, M, layer, scale);
  return cudaGetLastError();
}

// --- the bf16 instance ---------------------------------------------------------
// (its layout QuantTma, constants and the walker's pieces are in quant_tma.cuh)

template <int D, int G>
__global__ void __launch_bounds__(kQThreads, 2) decode_quant_tma_kernel(
    const __nv_bfloat16* __restrict__ q,                                 // (B, KVH*G, D)
    const int8_t* __restrict__ new_k, const int8_t* __restrict__ new_v,  // (B, KVH, D)
    const __nv_bfloat16* __restrict__ new_ks,                            // (B, KVH)
    const __nv_bfloat16* __restrict__ new_vs,
    int8_t* k_cache, int8_t* v_cache,                  // (L, B, KVH, M, D)
    __nv_bfloat16* ks_cache, __nv_bfloat16* vs_cache,  // (L, B, KVH, M)
    const int* __restrict__ cache_len,                 // (B,)
    __nv_bfloat16* __restrict__ out,                   // (B, KVH*G, D)
    float* __restrict__ partials,  // (B*KVH, ceil(M / run_rows), kPartial)
    int* __restrict__ counters,    // (B*KVH,), 0 between calls
    int B, int KVH, int M, int layer, int run_rows, float scale_log2) {
  static_assert(G <= 8, "the query heads fill at most half the 16-row tile");
  using L = QuantTma<D, G>;
  extern __shared__ __align__(128) unsigned char smem[];
  int* lvl = reinterpret_cast<int*>(smem + L::kOffLens);  // [n_runs + 1]
  int* lens = lvl + kQMaxPieces + 1;                       // [B]
  int* nruns = lens + B;                                   // [B]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int run = run_rows / kQRows;                    // chunks an item (a run)
  const int n_runs = (M + run_rows - 1) / run_rows;    // the partials' stride

  if (tid == 0) {
    quant_init<D, G>(smem);
    fence_barrier_init();
  }
  // every slot's live rows (the clamp keeps a bad value inside the slab; the
  // new row goes to len) and runs (of max(1, ceil(len / kQRows)) chunks),
  // then the items before each run r: KVH for every slot with more than r
  for (int b = tid; b < B; b += kQThreads) {
    const int len = min(max(cache_len[b], 0), M - 1);
    lens[b] = len;
    nruns[b] = (max(1, (len + kQRows - 1) / kQRows) + run - 1) / run;
  }
  __syncthreads();
  if (warp == 0) item_offsets(nruns, B, KVH, n_runs, lvl, lane);
  __syncthreads();

  // This block's items: walk_item(k) for k = 0, 1, ... below n_items
  const int n_items = lvl[n_runs];
  if (static_cast<int>(blockIdx.x) >= n_items) return;
  const QuantArgs a{q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, ks_cache, vs_cache, out,
                    partials, counters, B, KVH, M, layer, run, n_runs, scale_log2};

  if (warp >= kQWarps) {
    regs_dec<kQProducerRegs>();
    if (warp > kQWarps) return;
    quant_produce<D, G>(smem, a, lens, nruns, lvl, n_items, blockIdx.x, gridDim.x, lane);
    return;
  }
  regs_inc<kQConsumerRegs>();
  quant_consume<D, G, false>(smem, a, lens, nruns, lvl, n_items, blockIdx.x, gridDim.x, tid, 1);
}

// internal linkage: its cache is this library's own (a function-local static
// of a template with external linkage is one object in the whole process,
// shared by every library built from this source)
namespace {

template <int D, int G>
cudaError_t launch_quant_tma(const void* q, const int8_t* nk, const int8_t* nv, const void* nks,
                             const void* nvs, int8_t* kc, int8_t* vc, void* ksc, void* vsc,
                             const int* lens, void* out, float* partials, int* counters, int B,
                             int KVH, int M, int layer, int run_rows, float scale,
                             cudaStream_t stream) {
  if (run_rows < kQRows || run_rows % kQRows || (M + run_rows - 1) / run_rows > kQMaxPieces) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decode_quant_tma_kernel<D, G>;
  const size_t smem = QuantTma<D, G>::smem(B);
  // the grid: every block the card holds at once
  static ResidentGrid cache;
  int grid = 0;
  const cudaError_t err = resident_grid(kernel, kQThreads, smem, cache, &grid);
  if (err != cudaSuccess) return err;
  // the kernel's item indices (items and the grid) stay in 32 bits
  const long long items = static_cast<long long>(B) * KVH * ((M + kQRows - 1) / kQRows);
  if (items + grid >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<grid, kQThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), nk, nv, static_cast<const __nv_bfloat16*>(nks),
      static_cast<const __nv_bfloat16*>(nvs), kc, vc, static_cast<__nv_bfloat16*>(ksc),
      static_cast<__nv_bfloat16*>(vsc), lens, static_cast<__nv_bfloat16*>(out), partials,
      counters, B, KVH, M, layer, run_rows, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// registers, local (spilled) bytes, dynamic shared bytes (at B = 0; 8 bytes
// more a slot), resident blocks per SM at that size, the most runs a slot
// may have, rows a chunk, ring stages and consumer warps of the bf16 instance
template <int D, int G>
cudaError_t quant_tma_info(int* info) {
  auto kernel = decode_quant_tma_kernel<D, G>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const size_t smem = QuantTma<D, G>::smem(0);
  cudaFuncAttributes attr;
  cudaError_t err = allow_all_smem(kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[4] = kQMaxPieces;
  info[5] = kQRows;
  info[6] = kQStages;
  info[7] = kQWarps;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, kQThreads, smem);
}

template <int D, int G>
cudaError_t launch_pair(int dtype, const void* q, const int8_t* nk, const int8_t* nv,
                        const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                        void* vsc, const int* lens, void* out, float* partials, int* counters,
                        int B, int KVH, int M, int layer, int run_rows, float scale,
                        cudaStream_t st) {
  if (dtype == kBFloat16) {
    return launch_quant_tma<D, G>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, partials,
                                  counters, B, KVH, M, layer, run_rows, scale, st);
  }
  if (dtype == kFloat32) {
    return launch_decode<float, D, G>(q, nk, nv, nks, nvs, kc, vc, ksc, vsc, lens, out, B, KVH,
                                      M, layer, scale, st);
  }
  return cudaErrorInvalidValue;
}

#define KARANTA_DECODE_CASE(DD, GG)                                                          \
  if (D == DD && G == GG)                                                                     \
    return static_cast<int>(launch_pair<DD, GG>(dtype, q, nk, nv, nks, nvs, kc, vc, ksc, vsc, \
                                                lens, out, partials, counters, B, KVH, M,     \
                                                layer, run_rows, scale,                      \
                                                static_cast<cudaStream_t>(stream)));

inline int decode_entry(int D, int G, const void* q, const int8_t* nk, const int8_t* nv,
                        const void* nks, const void* nvs, int8_t* kc, int8_t* vc, void* ksc,
                        void* vsc, const int* lens, void* out, float* partials, int* counters,
                        int B, int KVH, int M, int layer, int run_rows, float scale, int dtype,
                        void* stream) {
  KARANTA_ROW_PAIRS(KARANTA_DECODE_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef KARANTA_DECODE_CASE

}  // namespace karanta

// C interface (loaded with ctypes). Caches are updated in place. Returns the
// CUDA error code of the launch; cudaErrorInvalidValue for a (D, G) pair
// without an instantiation. The bf16 instance needs `partials`, float32
// (B * KVH * ceil(M / run_rows) * (8 D + 16)), and `counters`, int32
// (B * KVH), zero before the first call (each call leaves them zero; the
// other split kernels' counters may be the same array on one stream), and
// cuts each (slot, kv head) into runs of `run_rows` rows (a multiple of
// info[5], with ceil(M / run_rows) at most info[4] of
// karanta_decode_append_quant_info; the wrapper's rule picks it); the
// float32 instance ignores the three.
extern "C" int karanta_decode_append_quant(
    const void* q, const int8_t* new_k, const int8_t* new_v, const void* new_ks,
    const void* new_vs, int8_t* k_cache, int8_t* v_cache, void* ks_cache, void* vs_cache,
    const int* cache_len, void* out, float* partials, int* counters, int B, int KVH, int G,
    int M, int D, int layer, int run_rows, float scale, int dtype, void* stream) {
  return karanta::decode_entry(D, G, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                               ks_cache, vs_cache, cache_len, out, partials, counters, B, KVH,
                               M, layer, run_rows, scale, dtype, stream);
}

#define KARANTA_DECODE_SUPPORTED(DD, GG) \
  if (D == DD && G == GG) return 1;

// (D, G) pairs with an instantiation, for the wrapper's checks
extern "C" int karanta_decode_supported(int D, int G) {
  KARANTA_ROW_PAIRS(KARANTA_DECODE_SUPPORTED)
  return 0;
}

#define KARANTA_DECODE_INFO(DD, GG) \
  if (D == DD && G == GG) return static_cast<int>(karanta::quant_tma_info<DD, GG>(info));

// info[8] = registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block (at B = 0; 8 more a slot), resident blocks per SM,
// the most runs a slot may have (ceil(M / run_rows)), rows a chunk, ring
// stages and consumer warps of the bf16 instance for (D, G). Returns the
// CUDA error code.
extern "C" int karanta_decode_append_quant_info(int D, int G, int* info) {
  KARANTA_ROW_PAIRS(KARANTA_DECODE_INFO)
  return static_cast<int>(cudaErrorInvalidValue);
}
