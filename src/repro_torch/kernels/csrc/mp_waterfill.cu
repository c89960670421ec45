// Row-wise reverse water-filling z = MP(L, gamma) by bisection.
//
// Replaces: src/repro/kernels/mp_waterfill.py, mp_waterfill_pallas (Pallas
// body _mp_waterfill_kernel). Plain PyTorch version:
// repro_torch/kernels/ref.py, mp_waterfill.
//
// What it computes: for each row r of L (R, m), hi = max_i L[r, i],
// lo = hi - gamma, then `iters` halvings of [lo, hi]: mid = (lo + hi) / 2,
// h = sum_i max(L[r, i] - mid, 0), the root lies above mid when h > gamma.
// z[r] = (lo + hi) / 2. Add, compare and halve only, like the hardware.
//
// What bounds it on an H100: operations, about 79 f32 operations per
// element (the max, then subtract, max and add in each of 26 steps)
// against 4 bytes read once. So a step must cost its three operations per
// element and little else:
//   * a row belongs to a group of G lanes (a power of two chosen from m,
//     kernels/mp_kernels.py, mp_waterfill_plan): G = 1 for m <= 32, so a
//     thread holds the whole row in registers and a step's sum takes no
//     shuffle; wider groups for longer rows, at most K = 32 elements per
//     lane. A step's sum is then a tree over the lane's K registers and
//     log2(G) shuffles (5 in the one-warp-per-row design this replaces,
//     which at m = 32 spent more on its shuffles than on its elements);
//   * a CTA of 256 threads takes 256 / G consecutive rows, one contiguous
//     block of L: it is read into shared memory with coalesced 16-byte
//     loads, each row at a stride s >= m with s = G (mod 32), so that a
//     warp's lanes read their rows' elements from 32 different banks;
//   * rows longer than 1024 keep one warp per row and re-read global
//     memory in every step.
// The tail lanes of a row hold -inf, which adds max(-inf - mid, 0) = 0 to
// every sum, as the TPU kernel's -1e30 padding did. The step's arithmetic
// is the plain version's (max(L - mid, 0) summed, compared with gamma,
// the same halving); only the order of the sum differs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// the shared row stride: the least s >= m with s = G (mod 32)
__host__ __device__ constexpr int row_stride(int m, int G) {
  return m + (((G - m) % 32) + 32) % 32;
}

// the shared words a CTA stages: 256 / G rows at the largest stride
// (m <= K G)
template <int K, int G>
__host__ __device__ constexpr int smem_words() {
  return (kThreads / G) * row_stride(K * G, G);
}

// Sum (max) over the G lanes of a group: an xor butterfly, which leaves
// the same bits in every lane of the group.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Adjacent-pair tree over the first W of K registers (W a power of two),
// one level per instantiation so that every index is a constant and h
// stays in registers.
template <int W, int K>
__device__ __forceinline__ float tree_sum(float (&h)[K]) {
  if constexpr (W == 1) {
    return h[0];
  } else {
#pragma unroll
    for (int k = 0; k < W / 2; ++k) h[k] = h[2 * k] + h[2 * k + 1];
    return tree_sum<W / 2>(h);
  }
}

// Rows of m <= K G elements, G lanes each, staged through shared memory.
template <int K, int G>
__global__ void __launch_bounds__(kThreads)
    mp_waterfill_rows_kernel(const float* __restrict__ L,
                             float* __restrict__ z, int R, int m,
                             float gamma, int iters) {
  constexpr int kRows = kThreads / G;
  __shared__ float sm[smem_words<K, G>()];
  const int t = threadIdx.x;
  const long r0 = (long)blockIdx.x * kRows;
  const int rows = R - r0 < kRows ? (int)(R - r0) : kRows;
  const int s = row_stride(m, G);
  const float* src = L + r0 * m;
  const int total = rows * m;
  // coalesced: 16 bytes a thread where every float4 lies in one row
  if ((m & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = t; q < total / 4; q += kThreads) {
      const float4 v = __ldg(src4 + q);
      const int e = 4 * q, r = e / m, c = e - r * m;
      float* d = sm + r * s + c;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    for (int e = t; e < total; e += kThreads) {
      const int r = e / m;
      sm[r * s + e - r * m] = __ldg(src + e);
    }
  }
  __syncthreads();
  const int row = t / G, j = t % G;
  const bool live = row < rows;
  float v[K];
  float hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = j + G * k;
    v[k] = (live && i < m) ? sm[row * s + i] : -INFINITY;
    hi = fmaxf(hi, v[k]);
  }
  hi = group_max<G>(hi);
  float lo = hi - gamma;
  for (int it = 0; it < iters; ++it) {
    const float mid = (lo + hi) * 0.5f;
    float h[K];
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = fmaxf(v[k] - mid, 0.f);
    const float sum = group_sum<G>(tree_sum<K>(h));
    const bool too_low = sum > gamma;
    lo = too_low ? mid : lo;
    hi = too_low ? hi : mid;
  }
  if (live && j == 0) z[r0 + row] = (lo + hi) * 0.5f;
}

// Rows longer than 1024: one warp per row, elements re-read from global
// memory in every step.
__global__ void __launch_bounds__(kThreads)
    mp_waterfill_long_kernel(const float* __restrict__ L,
                             float* __restrict__ z, int R, int m,
                             float gamma, int iters) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= R) return;              // the whole warp leaves together
  const float* Lr = L + row * (long)m;
  float hi = -INFINITY;
  for (int i = lane; i < m; i += 32) hi = fmaxf(hi, Lr[i]);
  hi = group_max<32>(hi);
  float lo = hi - gamma;
  for (int it = 0; it < iters; ++it) {
    const float mid = (lo + hi) * 0.5f;
    float h = 0.f;
    for (int i = lane; i < m; i += 32) h += fmaxf(Lr[i] - mid, 0.f);
    const bool too_low = group_sum<32>(h) > gamma;
    lo = too_low ? mid : lo;
    hi = too_low ? hi : mid;
  }
  if (lane == 0) z[row] = (lo + hi) * 0.5f;
}

template <int K, int G>
int launch(const float* L, float* z, int R, int m, float gamma, int iters,
           cudaStream_t stream) {
  const long grid = ((long)R + kThreads / G - 1) / (kThreads / G);
  mp_waterfill_rows_kernel<K, G><<<(unsigned)grid, kThreads, 0, stream>>>(
      L, z, R, m, gamma, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (R, m) float32 -> z (R,) float32, with the plan's group width G and
// elements per lane K (kernels/mp_kernels.py, mp_waterfill_plan: G = 1
// and K = m rounded up to a power of two for m <= 32; K = 32 and G = m /
// 32 rounded up to a power of two for m <= 1024; G = 32, K = 0 above,
// the global-memory path). Returns 0, a cudaError_t code, or -1 for a
// plan or shapes it does not take (R, m >= 1, iters >= 0).
extern "C" int mp_waterfill_launch(const void* L, void* z, int R, int m,
                                   float gamma, int iters, int G, int K,
                                   void* stream) {
  if (R < 1 || m < 1 || iters < 0) return -1;
  int want_g = 1, want_k = 1;
  if (m > 1024) {
    want_g = 32, want_k = 0;
  } else if (m > 32) {
    want_k = 32;
    while (want_g * 32 < m) want_g *= 2;
  } else {
    while (want_k < m) want_k *= 2;
  }
  if (G != want_g || K != want_k) return -1;
  const float* Lp = static_cast<const float*>(L);
  float* zp = static_cast<float*>(z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MP_WATERFILL_ARGS Lp, zp, R, m, gamma, iters, st
  switch (G * 64 + K) {
    case 64 + 1: return launch<1, 1>(MP_WATERFILL_ARGS);
    case 64 + 2: return launch<2, 1>(MP_WATERFILL_ARGS);
    case 64 + 4: return launch<4, 1>(MP_WATERFILL_ARGS);
    case 64 + 8: return launch<8, 1>(MP_WATERFILL_ARGS);
    case 64 + 16: return launch<16, 1>(MP_WATERFILL_ARGS);
    case 64 + 32: return launch<32, 1>(MP_WATERFILL_ARGS);
    case 2 * 64 + 32: return launch<32, 2>(MP_WATERFILL_ARGS);
    case 4 * 64 + 32: return launch<32, 4>(MP_WATERFILL_ARGS);
    case 8 * 64 + 32: return launch<32, 8>(MP_WATERFILL_ARGS);
    case 16 * 64 + 32: return launch<32, 16>(MP_WATERFILL_ARGS);
    case 32 * 64 + 32: return launch<32, 32>(MP_WATERFILL_ARGS);
    default: break;
  }
#undef MP_WATERFILL_ARGS
  const long grid = ((long)R + kThreads / 32 - 1) / (kThreads / 32);
  mp_waterfill_long_kernel<<<(unsigned)grid, kThreads, 0, st>>>(
      Lp, zp, R, m, gamma, iters);
  return static_cast<int>(cudaGetLastError());
}
