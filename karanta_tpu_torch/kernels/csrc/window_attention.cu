// Vision window attention with fused rotary embedding, for Hopper (sm_90a).
//
// Replaces the TPU kernel karanta_tpu/ops/attention.py:403
// _window_attention_kernel_call (bodies _window_rope_kernel :362 and
// _window_kernel :316). Each query attends only to the keys of its own
// `window`-token segment that are live under the kv mask; with cos/sin the
// queries and keys are rotated first (q*cos + rotate_half(q)*sin, in float32,
// rounded back to the activation type as the TPU kernel does).
//
// What bounds it on this card: per (window, head) the work is a W x W x D
// product twice (QK^T, PV) on data read once, about 2*W flops per byte at
// W = 64 in bf16, so at the Qwen2.5-VL shapes (S = 5120, 16 heads, D = 80)
// the kernel is close to the card's balance point; this first version runs
// the products on the CUDA cores in float32, so it is bound by instruction
// issue, not by the 3.35 TB/s of device memory.
//
// Design: one block per (window, head, batch), one thread per query row.
// The block loads its window's K (rotated) and V rows into shared memory
// once; each thread keeps its rotated query row and float32 accumulator in
// registers and runs an online softmax over the window's keys, sixteen keys
// per rescale. The TPU kernel's (D, D) rotate-half permutation matmul was a
// lane-tiling device; here rotate-half is a register index.
#include "common.cuh"

namespace karanta {

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

template <typename T, int D>
cudaError_t launch_window(const void* q, const void* k, const void* v,
                          const float* mask, const float* cos, const float* sin,
                          void* out, int B, int S, int H, int W, float scale,
                          cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(W) * D * sizeof(T) + W * sizeof(float);
  auto kernel = window_attention_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / W, H, B);
  kernel<<<grid, W, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, cos, sin, static_cast<T*>(out), S, H, W, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_window(int D, const void* q, const void* k, const void* v,
                            const float* mask, const float* cos, const float* sin,
                            void* out, int B, int S, int H, int W, float scale,
                            cudaStream_t stream) {
  switch (D) {
    // Qwen2.5-VL vision heads are 80 wide (16 in the tiny test config);
    // each width is a separate, fully unrolled instantiation
    case 16: return launch_window<T, 16>(q, k, v, mask, cos, sin, out, B, S, H, W, scale, stream);
    case 64: return launch_window<T, 64>(q, k, v, mask, cos, sin, out, B, S, H, W, scale, stream);
    case 80: return launch_window<T, 80>(q, k, v, mask, cos, sin, out, B, S, H, W, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

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
  cudaError_t err;
  if (dtype == karanta::kBFloat16) {
    err = karanta::dispatch_window<__nv_bfloat16>(D, q, k, v, mask, cos, sin, out, B, S, H,
                                                  W, scale, st);
  } else if (dtype == karanta::kFloat32) {
    err = karanta::dispatch_window<float>(D, q, k, v, mask, cos, sin, out, B, S, H, W,
                                          scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
