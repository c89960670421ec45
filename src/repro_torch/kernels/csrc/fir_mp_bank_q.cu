// One-shot integer MP FIR bank (the fixed-point twin of fir_mp_bank.cu).
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_bank_q_pallas (Pallas body
// _fir_mp_bank_q_kernel / _fxp_fir_mp_body / _fxp_mpabs_ops). Plain
// PyTorch version: repro_torch/kernels/ref.py, fir_mp_bank_q /
// fir_mp_bank_q_accumulate.
//
// What it computes: for row b, filter f and position n, with int32 codes
// already on the stage's internal grid,
//   u_k = clip(h_f[k] + x[b, n - k], qmin, qmax),
//   v_k = clip(h_f[k] - x[b, n - k], qmin, qmax)      (k < M, zero left
//   fill), y = mpabs(u) - mpabs(v), each by `iters` steps of integer
//   bisection (add, compare, arithmetic shift; see fixed_point.cuh).
// Output (B, F, N) int32; or, in accumulate mode, (B, F) sums of
// max(y, 0) over the N positions.
//
// What bounds it on an H100: operations. A second of 16 kHz audio is
// 64 KB of codes per row, while each (position, filter) costs ~1.6k int32
// instructions (12 bisection steps over 2 x 16 operands, for u and v).
// The grid is (position tile of 256, filter, row), one thread per output
// position holding its M shifted codes and operands in registers; the
// tap codes ride in the launch's parameter space (__grid_constant__: read
// in place, one address for the whole CTA). B = 8, N = 16000, F = 5 gives
// 2,520 CTAs for 132 SMs.
//
// Accumulate mode: integer addition is associative, so the HWR sum may
// reduce in any order and still give the reference's bits. Each warp sums
// with __reduce_add_sync, each CTA adds its warps in shared memory, and
// one atomicAdd per CTA lands in the (zeroed) output. None of the float
// bank's tile-partials-then-ordered-sum machinery is needed. Sums are
// taken in unsigned arithmetic, which wraps like the reference's int32
// sum (signed overflow would be undefined in C++); the reference's
// interval proof keeps them far from 2**31 anyway.

#include <cuda_runtime.h>

#include "fixed_point.cuh"

namespace {

constexpr int kTile = 256;      // positions per CTA
constexpr int kMaxTaps = 512;   // F * M tap codes in the parameter space
constexpr unsigned kFull = 0xffffffffu;

struct TapCodes {
  int h[kMaxTaps];              // (F, M) row-major
};

template <int P>
__global__ void __launch_bounds__(kTile)
fir_mp_bank_q_kernel(const int* __restrict__ x,
                     const __grid_constant__ TapCodes taps,
                     int* __restrict__ y, int N, int F, int M, int gamma,
                     int iters, int qmin, int qmax, int accumulate) {
  __shared__ int xt[kTile + P];
  __shared__ unsigned total;
  const int t = threadIdx.x;
  const int tile = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int n0 = tile * kTile;
  const int* xr = x + (size_t)b * N;
  if (t == 0) total = 0u;
  for (int i = t; i < kTile + M - 1; i += kTile) {
    const int src = n0 - (M - 1) + i;
    xt[i] = (src >= 0 && src < N) ? xr[src] : 0;
  }
  __syncthreads();

  int u[P], v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int xk = k < M ? xt[M - 1 + t - k] : 0;    // x[n - k]
    const unsigned hk = k < M ? taps.h[f * M + k] : 0;
    u[k] = fxp::clamp(static_cast<int>(hk + static_cast<unsigned>(xk)), qmin,
                      qmax);
    v[k] = fxp::clamp(static_cast<int>(hk - static_cast<unsigned>(xk)), qmin,
                      qmax);
  }
  const int yv = fxp::mp_dot_q(u, v, M, gamma, iters);
  const int pos = n0 + t;

  if (!accumulate) {
    if (pos < N) y[((size_t)b * F + f) * N + pos] = yv;
    return;
  }
  const unsigned h = pos < N ? static_cast<unsigned>(max(yv, 0)) : 0u;
  const unsigned w = __reduce_add_sync(kFull, h);
  if ((t & 31) == 0) atomicAdd(&total, w);
  __syncthreads();
  if (t == 0)
    atomicAdd(reinterpret_cast<unsigned*>(y) + (size_t)b * F + f, total);
}

template <int P>
int launch(const int* x, const TapCodes& taps, int* out, int B, int N, int F,
           int M, int gamma, int iters, int qmin, int qmax, int accumulate,
           cudaStream_t stream) {
  if (accumulate) {
    cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(int) * (size_t)B * F, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kTile - 1) / kTile, F, B);
  fir_mp_bank_q_kernel<P><<<grid, kTile, 0, stream>>>(
      x, taps, out, N, F, M, gamma, iters, qmin, qmax, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, N) int32 codes, taps (F, M) int32 host codes -> out (B, F, N), or
// (B, F) when accumulate. Returns 0, a cudaError_t code, or -1 for shapes
// outside what it takes (1 <= M <= 16, F * M <= 512, B, N, F >= 1, B and
// F <= 65535, iters >= 0, qmin <= qmax). The 8-lane body serves the 6-tap
// low-pass, the 16-lane body the 16-tap band-pass.
extern "C" int fir_mp_bank_q_launch(const void* x, const void* taps_host,
                                    void* out, int B, int N, int F, int M,
                                    int gamma, int iters, int qmin, int qmax,
                                    int accumulate, void* stream) {
  if (B < 1 || N < 1 || F < 1 || M < 1 || M > 16 || F * M > kMaxTaps ||
      B > 65535 || F > 65535 || iters < 0 || qmin > qmax)
    return -1;
  TapCodes taps;
  const int* h = static_cast<const int*>(taps_host);
  for (int i = 0; i < F * M; ++i) taps.h[i] = h[i];
#define FIR_MP_BANK_Q_ARGS                                                   \
  static_cast<const int*>(x), taps, static_cast<int*>(out), B, N, F, M,     \
      gamma, iters, qmin, qmax, accumulate, static_cast<cudaStream_t>(stream)
  if (M <= 8) return launch<8>(FIR_MP_BANK_Q_ARGS);
  return launch<16>(FIR_MP_BANK_Q_ARGS);
#undef FIR_MP_BANK_Q_ARGS
}
