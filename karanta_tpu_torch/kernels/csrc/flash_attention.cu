// Flash attention (online softmax, BSHD) for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/attention.py:235 flash_attention
// (body _flash_kernel :163). q (B, Sq, H, D), k/v (B, Sk, KVH, D), optional
// float kv mask (B, Sk), causal masking at q_offset + row >= col, GQA through
// kv_head = h / (H / KVH). Key tiles entirely above the causal diagonal are
// skipped; rows that saw no key (l == 0) return 0.
//
// What bounds it on this card: at the decoder-prefill shape (Sq = Sk = 1408,
// 28 heads, D = 128, causal) and the vision full layers (S = 5120, 16 heads,
// D = 80) attention does hundreds of flops per byte, far above the card's
// balance point, so the bound is the tensor cores' 989 TFLOP/s in bf16. This
// first version computes on the CUDA cores in float32 and is therefore
// bound by instruction issue; wgmma and TMA are the later step.
//
// Design: one block per (64-query tile, head, batch) and four threads per
// query row, each owning every fourth feature dim (so a warp's shared-memory
// reads are conflict-free). The row's float32 accumulator lives in those
// four threads' registers; partial dot products meet with two warp shuffles.
// 64-key tiles of K and V stream through shared memory; the online softmax
// rescales once per sixteen keys.
#include "common.cuh"

namespace karanta {

constexpr int kFlashBQ = 64;     // query rows per block
constexpr int kFlashBK = 64;     // keys per shared-memory tile
constexpr int kFlashTPR = 4;     // threads per query row
constexpr int kFlashChunk = 16;  // keys per online-softmax rescale
constexpr int kFlashThreads = kFlashBQ * kFlashTPR;

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask,  // (B, Sk) or null
    T* __restrict__ out, int Sq, int Sk, int H, int KVH, float scale, int causal,
    int q_offset) {
  constexpr int DP = D / kFlashTPR;  // dims per thread
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);       // [BK][D]
  T* v_s = k_s + kFlashBK * D;                   // [BK][D]
  float* live = reinterpret_cast<float*>(v_s + kFlashBK * D);  // [BK]

  const int tid = threadIdx.x;
  const int r = tid / kFlashTPR, sub = tid % kFlashTPR;
  const int q0 = blockIdx.x * kFlashBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;

  float qf[DP], acc[DP];
  const T* qrow = q + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qf[i] = row_ok ? to_f<T>(qrow[i * kFlashTPR + sub]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + q0 + kFlashBQ);  // tiles past it skip

  for (int k0 = 0; k0 < k_end; k0 += kFlashBK) {
    const int nk = min(kFlashBK, Sk - k0);
    for (int t = tid; t < kFlashBK * kVecPerRow; t += kFlashThreads) {
      const int j = t / kVecPerRow, c = t % kVecPerRow;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (j < nk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + k0 + j) * KVH + kvh) * D;
        kv4 = reinterpret_cast<const uint4*>(k + off)[c];
        vv4 = reinterpret_cast<const uint4*>(v + off)[c];
      }
      reinterpret_cast<uint4*>(k_s + j * D)[c] = kv4;
      reinterpret_cast<uint4*>(v_s + j * D)[c] = vv4;
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
        const T* kr = k_s + j * D;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) dot += qf[i] * to_f<T>(kr[i * kFlashTPR + sub]);
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
        const T* vr = v_s + (j0 + jj) * D;
#pragma unroll
        for (int i = 0; i < DP; ++i) acc[i] += p * to_f<T>(vr[i * kFlashTPR + sub]);
      }
      m = m_new;
    }
    __syncthreads();  // the next tile overwrites k_s / v_s
  }

  if (row_ok) {
    const float inv = l == 0.f ? 1.f : 1.f / l;
    T* orow = out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) orow[i * kFlashTPR + sub] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const float* mask,
                         void* out, int B, int Sq, int Sk, int H, int KVH, float scale,
                         int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kFlashBK) * D * sizeof(T)
                      + kFlashBK * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kFlashBQ - 1) / kFlashBQ, H, B);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), Sq, Sk, H, KVH, scale, causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int D, const void* q, const void* k, const void* v,
                           const float* mask, void* out, int B, int Sq, int Sk, int H,
                           int KVH, float scale, int causal, int q_offset,
                           cudaStream_t st) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal, q_offset, st);
    case 32: return launch_flash<T, 32>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal, q_offset, st);
    case 64: return launch_flash<T, 64>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal, q_offset, st);
    case 80: return launch_flash<T, 80>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal, q_offset, st);
    case 128: return launch_flash<T, 128>(q, k, v, mask, out, B, Sq, Sk, H, KVH, scale, causal, q_offset, st);
    default: return cudaErrorInvalidValue;
  }
}

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
  cudaError_t err;
  if (dtype == karanta::kBFloat16) {
    err = karanta::dispatch_flash<__nv_bfloat16>(D, q, k, v, mask, out, B, Sq, Sk, H, KVH,
                                                 scale, causal, q_offset, st);
  } else if (dtype == karanta::kFloat32) {
    err = karanta::dispatch_flash<float>(D, q, k, v, mask, out, B, Sq, Sk, H, KVH, scale,
                                         causal, q_offset, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
