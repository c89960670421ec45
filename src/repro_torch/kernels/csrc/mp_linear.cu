// Fused multiplierless MP matrix product (paper eq. 9).
//
// Replaces: src/repro/kernels/mp_linear.py, mp_linear_pallas (Pallas body
// _mp_linear_kernel). Plain PyTorch version: repro_torch/kernels/ref.py,
// mp_linear.
//
// What it computes: x (B, d), w (d, O) -> y (B, O) with, for each (b, o),
//   u_i = x[b, i] + w[i, o],  v_i = x[b, i] - w[i, o]   (i < d),
// both water-fillings over [u; -u] and [v; -v] bisected together:
// hi = max_i |.|, lo = hi - gamma, then `iters` steps of
// mid = (lo + hi) / 2 and h = sum_i max(t_i - mid, 0) + max(-t_i - mid, 0),
// the root above mid when h > gamma; y = (lo_u + hi_u) / 2 - (lo_v + hi_v) / 2.
//
// What bounds it on an H100: operations. Each (b, o, i) costs about 370 f32
// operations (the max pass, then 26 steps of u, v and two hinges per
// branch), against 4 bytes of w that serve all B rows: at B = 2 that is
// ~185 operations per byte, far above the card's 10. The trap is re-reading
// w from device memory in each of the 27 passes. So a CTA owns a tile of
// TO output columns for all d and BB batch rows, copies its d x TO slice of
// w into shared memory once (d <= 14,080 at TO = 2; 110 KB keeps two or
// more CTAs on each SM), and runs every pass from there. Its 256 threads
// split d; each keeps 2 x BB x TO partial sums in registers, and one block
// reduction per step (warp butterflies, then the 8 warp sums in order)
// gives the sums, from which NV threads move the bisection states. x is
// read through the read-only cache (B x d floats, shared by all CTAs).
// Wider d reads w from device memory in every pass (correct, slow).
//
// The TPU kernel streamed d in chunks of 512 (a VMEM limit) and needed d to
// be a multiple of it, and padded O to 128 columns; here any d and O go,
// the ragged column tile and batch tile are masked. The sums run in another
// order than the reference's, so a comparison right at gamma can go the
// other way; bisection still brackets the root within the sums' rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kResidentBytes = 110 * 1024;   // w tile in shared memory

// BB batch rows x TO output columns per CTA. RES: w tile resident in
// shared memory ([TO][d]); otherwise read from device memory every pass.
template <int BB, int TO, bool RES>
__global__ void __launch_bounds__(kThreads)
    mp_linear_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int B, int d, int O, float gamma,
                     int iters) {
  // accumulator k = (s * BB + b) * TO + o; s = 0: u = x + w, s = 1: x - w
  constexpr int NV = 2 * BB * TO;
  extern __shared__ float wtile[];
  __shared__ float red[kWarps][NV];
  __shared__ float st_lo[NV], st_hi[NV];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = blockIdx.x * TO, b0 = blockIdx.y * BB;

  const float* xr[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) xr[b] = x + (size_t)min(b0 + b, B - 1) * d;
  int oc[TO];   // column of w (clamped; masked columns are never stored)
#pragma unroll
  for (int o = 0; o < TO; ++o) oc[o] = min(o0 + o, O - 1);

  if constexpr (RES) {
    for (int i = tid; i < d * TO; i += kThreads) {
      const int dd = i / TO, o = i % TO;
      wtile[o * d + dd] = w[(size_t)dd * O + oc[o]];
    }
    __syncthreads();
  }
  auto wat = [&](int o, int dd) -> float {
    if constexpr (RES) {
      return wtile[o * d + dd];
    } else {
      return __ldg(w + (size_t)dd * O + oc[o]);
    }
  };

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  // hi = max_i |u_i| and max_i |v_i|
#pragma unroll 2
  for (int dd = tid; dd < d; dd += kThreads) {
    float xv[BB], wv[TO];
#pragma unroll
    for (int b = 0; b < BB; ++b) xv[b] = __ldg(xr[b] + dd);
#pragma unroll
    for (int o = 0; o < TO; ++o) wv[o] = wat(o, dd);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
#pragma unroll
      for (int o = 0; o < TO; ++o) {
        const int ku = b * TO + o, kv = (BB + b) * TO + o;
        acc[ku] = fmaxf(acc[ku], fabsf(xv[b] + wv[o]));
        acc[kv] = fmaxf(acc[kv], fabsf(xv[b] - wv[o]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] = fmaxf(acc[k], __shfl_xor_sync(kFull, acc[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[warp][k] = acc[k];
  }
  __syncthreads();
  if (tid < NV) {
    float hi = red[0][tid];
    for (int q = 1; q < kWarps; ++q) hi = fmaxf(hi, red[q][tid]);
    st_hi[tid] = hi;
    st_lo[tid] = hi - gamma;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float mid[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      mid[k] = (st_lo[k] + st_hi[k]) * 0.5f;
      acc[k] = 0.f;
    }
#pragma unroll 2
    for (int dd = tid; dd < d; dd += kThreads) {
      float xv[BB], wv[TO];
#pragma unroll
      for (int b = 0; b < BB; ++b) xv[b] = __ldg(xr[b] + dd);
#pragma unroll
      for (int o = 0; o < TO; ++o) wv[o] = wat(o, dd);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
#pragma unroll
        for (int o = 0; o < TO; ++o) {
          const int ku = b * TO + o, kv = (BB + b) * TO + o;
          const float u = xv[b] + wv[o], v = xv[b] - wv[o];
          acc[ku] += fmaxf(u - mid[ku], 0.f) + fmaxf(-u - mid[ku], 0.f);
          acc[kv] += fmaxf(v - mid[kv], 0.f) + fmaxf(-v - mid[kv], 0.f);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k) red[warp][k] = acc[k];
    }
    __syncthreads();
    if (tid < NV) {
      float h = red[0][tid];
      for (int q = 1; q < kWarps; ++q) h += red[q][tid];
      // the same mid, from shared memory: a runtime index into mid[]
      // would push the array out of registers
      const float m = (st_lo[tid] + st_hi[tid]) * 0.5f;
      if (h > gamma) {
        st_lo[tid] = m;
      } else {
        st_hi[tid] = m;
      }
    }
    __syncthreads();
  }

  if (tid < BB * TO) {
    const int b = tid / TO, o = tid % TO;
    if (b0 + b < B && o0 + o < O) {
      const float zu = (st_lo[tid] + st_hi[tid]) * 0.5f;
      const float zv = (st_lo[BB * TO + tid] + st_hi[BB * TO + tid]) * 0.5f;
      y[(size_t)(b0 + b) * O + o0 + o] = zu - zv;
    }
  }
}

template <int BB, int TO, bool RES>
int launch(const float* x, const float* w, float* y, int B, int d, int O,
           float gamma, int iters, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (RES) {
    smem = (size_t)d * TO * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        mp_linear_kernel<BB, TO, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kResidentBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((O + TO - 1) / TO, (B + BB - 1) / BB);
  mp_linear_kernel<BB, TO, RES><<<grid, kThreads, smem, stream>>>(
      x, w, y, B, d, O, gamma, iters);
  return static_cast<int>(cudaGetLastError());
}

// The widest column tile (TO <= 16 / BB, at most 8) whose w slice fits in
// kResidentBytes; past d = 14,080 the tile is read from device memory.
template <int BB>
int pick_tile(const float* x, const float* w, float* y, int B, int d, int O,
              float gamma, int iters, cudaStream_t stream) {
  const size_t col = (size_t)d * sizeof(float);
  if constexpr (BB <= 2) {
    if (8 * col <= kResidentBytes)
      return launch<BB, 8, true>(x, w, y, B, d, O, gamma, iters, stream);
  }
  if (4 * col <= kResidentBytes)
    return launch<BB, 4, true>(x, w, y, B, d, O, gamma, iters, stream);
  if (2 * col <= kResidentBytes)
    return launch<BB, 2, true>(x, w, y, B, d, O, gamma, iters, stream);
  return launch<BB, (BB <= 2 ? 8 : 4), false>(x, w, y, B, d, O, gamma, iters,
                                              stream);
}

}  // namespace

// x (B, d), w (d, O) float32, row-major -> y (B, O) float32. Returns 0, a
// cudaError_t code, or -1 for shapes outside what it takes (B, d, O >= 1,
// iters >= 0). Batch tiles: BB = 1 or 2 for B = 1 or 2, else 4.
extern "C" int mp_linear_launch(const void* x, const void* w, void* y, int B,
                                int d, int O, float gamma, int iters,
                                void* stream) {
  if (B < 1 || d < 1 || O < 1 || iters < 0) return -1;
#define MP_LINEAR_ARGS                                                    \
  static_cast<const float*>(x), static_cast<const float*>(w),             \
      static_cast<float*>(y), B, d, O, gamma, iters,                      \
      static_cast<cudaStream_t>(stream)
  if (B == 1) return pick_tile<1>(MP_LINEAR_ARGS);
  if (B == 2) return pick_tile<2>(MP_LINEAR_ARGS);
  return pick_tile<4>(MP_LINEAR_ARGS);
#undef MP_LINEAR_ARGS
}
