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
// element (the max, then subtract, max and add in each of 26 steps) against
// 4 bytes read once. One warp owns one row: its elements live in registers
// (K per lane, m <= 32 K; longer rows re-read global memory each step), and
// each step's sum is a butterfly of warp shuffles, which leaves the same
// bits in every lane, so the warp takes every branch together. The TPU
// kernel padded m to 128 lanes with -1e30; here the tail lanes hold -inf,
// which contributes max(-inf - mid, 0) = 0 to every sum, as the padding did.
// At m = 32 each lane holds one element and the five shuffles of the sum
// outweigh its three operations: that is the first thing to change when
// this kernel has to be fast (several rows per warp).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;        // 8 warps, one row each
constexpr int kRows = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// K > 0: the row's elements in K registers per lane (m <= 32 K).
// K == 0: any m, elements re-read from global memory in every step.
template <int K>
__global__ void __launch_bounds__(kThreads)
    mp_waterfill_kernel(const float* __restrict__ L, float* __restrict__ z,
                        int R, int m, float gamma, int iters) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kRows + (threadIdx.x >> 5);
  if (row >= R) return;              // the whole warp leaves together
  const float* Lr = L + row * (long)m;
  float v[K > 0 ? K : 1];
  float hi = -INFINITY;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < m ? Lr[i] : -INFINITY;
      hi = fmaxf(hi, v[k]);
    }
  } else {
    for (int i = lane; i < m; i += 32) hi = fmaxf(hi, Lr[i]);
  }
  hi = warp_max(hi);
  float lo = hi - gamma;
  for (int it = 0; it < iters; ++it) {
    const float mid = (lo + hi) * 0.5f;
    float h = 0.f;
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) h += fmaxf(v[k] - mid, 0.f);
    } else {
      for (int i = lane; i < m; i += 32) h += fmaxf(Lr[i] - mid, 0.f);
    }
    h = warp_sum(h);
    if (h > gamma) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  if (lane == 0) z[row] = (lo + hi) * 0.5f;
}

template <int K>
int launch(const float* L, float* z, int R, int m, float gamma, int iters,
           cudaStream_t stream) {
  const int grid = (R + kRows - 1) / kRows;
  mp_waterfill_kernel<K><<<grid, kThreads, 0, stream>>>(L, z, R, m, gamma,
                                                        iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (R, m) float32 -> z (R,) float32. Returns 0, a cudaError_t code, or -1
// for shapes outside what it takes (R, m >= 1, iters >= 0).
extern "C" int mp_waterfill_launch(const void* L, void* z, int R, int m,
                                   float gamma, int iters, void* stream) {
  if (R < 1 || m < 1 || iters < 0) return -1;
#define MP_WATERFILL_ARGS                                                  \
  static_cast<const float*>(L), static_cast<float*>(z), R, m, gamma, iters, \
      static_cast<cudaStream_t>(stream)
  if (m <= 32) return launch<1>(MP_WATERFILL_ARGS);
  if (m <= 64) return launch<2>(MP_WATERFILL_ARGS);
  if (m <= 128) return launch<4>(MP_WATERFILL_ARGS);
  if (m <= 256) return launch<8>(MP_WATERFILL_ARGS);
  if (m <= 512) return launch<16>(MP_WATERFILL_ARGS);
  if (m <= 1024) return launch<32>(MP_WATERFILL_ARGS);
  return launch<0>(MP_WATERFILL_ARGS);
#undef MP_WATERFILL_ARGS
}
