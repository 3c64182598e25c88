// Length-bounded decode attention of one (slot, kv head) over the rows of its
// cache slab, for a cache in the activations' dtype T. Shared by the float32
// instances of decode_append.cu (kernel #5: append, then attend) and
// decode_attention.cu (kernels #8 and #9: attend over rows already written);
// their bf16 instances run decode_split.cuh.
//
// One block of kRowThreads threads per (kv head, slot). Rows stream in chunks
// of 16 KB per cache, staged in shared memory with 16-byte loads; eight lanes
// share a row (D/8 elements each), dot it against all G query heads held in
// registers and reduce with three shuffles; one warp per head turns the
// chunk's scores into probabilities (online softmax across chunks); then each
// thread owns one output dim and accumulates the chunk's V column for all G
// heads. Probabilities stay in float32 for the PV product.
#pragma once

#include "common.cuh"

namespace karanta {

constexpr int kRowThreads = 128;
constexpr int kRowLanes = 8;  // lanes that share one cache row

// N consecutive elements of T from shared memory into float registers, with
// 16-byte loads where the run is a whole number of them
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* __restrict__ src, float (&dst)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kVec = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N / kVec; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[i * kVec + j] = to_f<T>(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f<T>(src[i]);
  }
}

// Shared memory of one block: the G query heads, one chunk's scores, the
// online-softmax state per head and the staged K/V rows.
template <typename T, int D, int G>
struct RowSmem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static_assert(kRowBytes % 16 == 0, "rows must be whole 16-byte vectors");
  static constexpr int kChunk = (16384 / kRowBytes) < 128 ? (16384 / kRowBytes) : 128;
  float q[G][D];
  float p[G][kChunk];
  float m[G], l[G], alpha[G], px[G];
  alignas(16) T k[kChunk * D];
  alignas(16) T v[kChunk * D];
};

// Loads the G query heads q_heads (G x D, contiguous) into sm.q and attends
// them over rows [0, n) of the slab k_rows / v_rows (n x D each). On return
// sm.m and sm.l hold each head's running max and sum, and each thread
// tid < D holds in acc[g] the unnormalised output of dim tid for head g.
// Every thread of the block must call it.
template <typename T, int D, int G>
__device__ void attend_rows(RowSmem<T, D, G>& sm, const T* __restrict__ q_heads,
                            const T* __restrict__ k_rows, const T* __restrict__ v_rows,
                            int n, float scale, float (&acc)[G]) {
  constexpr int DL = D / kRowLanes;  // elements per lane
  constexpr int kWarps = kRowThreads / 32;
  constexpr int kRowsPerPass = kWarps * (32 / kRowLanes);  // 16
  constexpr int kChunk = RowSmem<T, D, G>::kChunk;
  constexpr int kRowBytes = RowSmem<T, D, G>::kRowBytes;
  constexpr int kVecPerRow = kRowBytes / 16;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < G * D; i += kRowThreads) sm.q[i / D][i % D] = to_f<T>(q_heads[i]);
  if (tid < G) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  const int sub = lane % kRowLanes;   // which DL-wide slice of the row
  const int rg = lane / kRowLanes;    // row within the warp's pass
  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < DL; ++i) qr[g][i] = sm.q[g][sub * DL + i];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int nc = min(kChunk, n - c0);
    for (int t = tid; t < nc * kVecPerRow; t += kRowThreads) {
      const size_t off = static_cast<size_t>(c0) * kRowBytes + static_cast<size_t>(t) * 16;
      reinterpret_cast<uint4*>(sm.k)[t] =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(k_rows) + off);
      reinterpret_cast<uint4*>(sm.v)[t] =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(v_rows) + off);
    }
    __syncthreads();

    for (int base = 0; base < nc; base += kRowsPerPass) {
      const int jj = base + warp * (32 / kRowLanes) + rg;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (jj < nc) {
        float kv[DL];
        load_vals<T, DL>(sm.k + jj * D + sub * DL, kv);
#pragma unroll
        for (int i = 0; i < DL; ++i) {
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] += qr[g][i] * kv[i];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 1);
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 2);
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], 4);
      }
      if (jj < nc && sub == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) sm.p[g][jj] = part[g] * scale;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int jj = lane; jj < nc; jj += 32) mx = fmaxf(mx, sm.p[g][jj]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < nc; jj += 32) {
        const float p = __expf(sm.p[g][jj] - m_new);
        sum += p;
        sm.p[g][jj] = p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        sm.alpha[g] = alpha;
        sm.l[g] = sm.l[g] * alpha + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= sm.alpha[g];
      for (int jj = 0; jj < nc; ++jj) {
        const float vv = to_f<T>(sm.v[jj * D + tid]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += sm.p[g][jj] * vv;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows and sm.p
  }
}

// (D, G) pairs with an instantiation: Qwen2.5-VL-7B (28 heads over 4), -3B
// (16 over 2), the tiny test config (4 heads over 2) and the shapes of the
// JAX package's tests
#define KARANTA_ROW_PAIRS(X) \
  X(128, 7) X(128, 8) X(128, 4) X(128, 2) X(64, 4) X(64, 2) X(32, 2) X(16, 2)

}  // namespace karanta
