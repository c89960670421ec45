// One-shot MP FIR bank, and its single-filter form (F = 1).
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_bank_pallas (Pallas body
// _fir_mp_bank_kernel / _fir_mp_body) and fir_mp_pallas (_fir_mp_kernel),
// which is the same body with one filter. Plain PyTorch versions:
// repro_torch/kernels/ref.py, fir_mp_bank / fir_mp_bank_accumulate /
// fir_mp / fir_mp_accumulate.
//
// What it computes: for row b, filter f and position n,
//   u_k = x[b, n - k] + h_f[k],  v_k = x[b, n - k] - h_f[k]   (k < M,
//   zero left fill), both bisected together for `iters` steps on
//   [max|.| - gamma, max|.|] with the constraint sum accumulated
//   sequentially over k, y = (lo_u + hi_u) / 2 - (lo_v + hi_v) / 2.
// Output (B, F, N); or, in accumulate mode, (B, F) sums of max(y, 0) over
// the N positions.
//
// What bounds it on an H100: operations. One second of 16 kHz audio is
// 64 KB per row, while each (position, filter) costs about 5k f32
// instructions (26 bisection steps over 2 x 16 operands). So the design
// spends nothing on data movement beyond one shared-memory tile of the row
// per CTA and spreads positions wide: the grid is (position tile of 256,
// filter, row), one thread per output position, holding its M shifted
// samples and taps in registers — B = 8, N = 16000, F = 5 gives 2,520 CTAs
// for 132 SMs.
//
// Accumulate mode avoids float atomics, whose order changes from run to
// run: each CTA reduces its 256 HWR values by an adjacent-pair tree (warp
// shuffles, then the same tree over the 8 warp sums) into a partial, and a
// second small kernel adds each row's partials in ascending tile order.
// The TPU kernel's plain jnp.sum has no specified order, so the reference
// is held at a tolerance; the plain PyTorch version repeats this order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 256;          // positions per CTA (ref.BANK_TILE)
constexpr unsigned kFull = 0xffffffffu;

template <int P>
__global__ void fir_mp_bank_kernel(const float* __restrict__ x,
                                   const float* __restrict__ H,
                                   float* __restrict__ y,
                                   float* __restrict__ partial, int N, int F,
                                   int M, float gamma, int iters,
                                   int accumulate, int ntiles) {
  __shared__ float xt[kTile + P];
  __shared__ float wsum[kTile / 32];
  const int t = threadIdx.x;
  const int tile = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int n0 = tile * kTile;
  const float* xr = x + (size_t)b * N;
  for (int i = t; i < kTile + M - 1; i += kTile) {
    const int src = n0 - (M - 1) + i;
    xt[i] = (src >= 0 && src < N) ? xr[src] : 0.f;
  }
  __syncthreads();

  const int pos = n0 + t;
  float xs[P], hk[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    xs[k] = k < M ? xt[M - 1 + t - k] : 0.f;   // x[n - k]
    hk[k] = k < M ? H[f * M + k] : 0.f;
  }
  float hi_u = -INFINITY, hi_v = -INFINITY;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < M) {
      hi_u = fmaxf(hi_u, fabsf(xs[k] + hk[k]));
      hi_v = fmaxf(hi_v, fabsf(xs[k] - hk[k]));
    }
  }
  float lo_u = hi_u - gamma, lo_v = hi_v - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < iters; ++it) {
    const float mid_u = (lo_u + hi_u) * 0.5f;
    const float mid_v = (lo_v + hi_v) * 0.5f;
    float hu = 0.f, hv = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < M) {
        const float u = xs[k] + hk[k];
        const float v = xs[k] - hk[k];
        hu = hu + fmaxf(u - mid_u, 0.f) + fmaxf(-u - mid_u, 0.f);
        hv = hv + fmaxf(v - mid_v, 0.f) + fmaxf(-v - mid_v, 0.f);
      }
    }
    const bool tu = hu > gamma, tv = hv > gamma;
    lo_u = tu ? mid_u : lo_u;
    hi_u = tu ? hi_u : mid_u;
    lo_v = tv ? mid_v : lo_v;
    hi_v = tv ? hi_v : mid_v;
  }
  const float yv = (lo_u + hi_u) * 0.5f - (lo_v + hi_v) * 0.5f;

  if (!accumulate) {
    if (pos < N) y[((size_t)b * F + f) * N + pos] = yv;
    return;
  }
  float h = pos < N ? fmaxf(yv, 0.f) : 0.f;
  for (int off = 1; off < 32; off <<= 1)
    h = h + __shfl_down_sync(kFull, h, off);
  if ((t & 31) == 0) wsum[t >> 5] = h;
  __syncthreads();
  if (t == 0) {
    float w[kTile / 32];
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) w[i] = wsum[i];
#pragma unroll
    for (int width = kTile / 32; width > 1; width >>= 1) {
#pragma unroll
      for (int i = 0; i < width / 2; ++i) w[i] = w[2 * i] + w[2 * i + 1];
    }
    partial[((size_t)b * F + f) * ntiles + tile] = w[0];
  }
}

// out[r] = partial[r, 0] + partial[r, 1] + ... in ascending tile order
__global__ void row_sum_kernel(const float* __restrict__ partial,
                               float* __restrict__ out, int rows,
                               int ntiles) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = partial + (size_t)r * ntiles;
  float s = p[0];
  for (int i = 1; i < ntiles; ++i) s = s + p[i];
  out[r] = s;
}

template <int P>
int launch(const float* x, const float* H, float* out, float* partial, int B,
           int N, int F, int M, float gamma, int iters, int accumulate,
           cudaStream_t stream) {
  const int ntiles = (N + kTile - 1) / kTile;
  const dim3 grid(ntiles, F, B);
  fir_mp_bank_kernel<P><<<grid, kTile, 0, stream>>>(
      x, H, out, partial, N, F, M, gamma, iters, accumulate, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !accumulate) return static_cast<int>(err);
  const int rows = B * F;
  row_sum_kernel<<<(rows + 127) / 128, 128, 0, stream>>>(partial, out, rows,
                                                         ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, N), H (F, M) -> out (B, F, N), or (B, F) when accumulate; partial
// is (B, F, ceil(N / 256)) scratch, used only when accumulate. Returns 0,
// a cudaError_t code, or -1 for shapes outside what it takes (M <= 16,
// B, N, F >= 1, B and F <= 65535). The 8-lane body serves the 6-tap
// low-pass, the 16-lane body the 16-tap band-pass.
extern "C" int fir_mp_bank_launch(const void* x, const void* H, void* out,
                                  void* partial, int B, int N, int F, int M,
                                  float gamma, int iters, int accumulate,
                                  void* stream) {
  if (B < 1 || N < 1 || F < 1 || M < 1 || M > 16 || B > 65535 || F > 65535 ||
      iters < 0)
    return -1;
#define FIR_MP_BANK_ARGS                                                 \
  static_cast<const float*>(x), static_cast<const float*>(H),           \
      static_cast<float*>(out), static_cast<float*>(partial), B, N, F, M, \
      gamma, iters, accumulate, static_cast<cudaStream_t>(stream)
  if (M <= 8) return launch<8>(FIR_MP_BANK_ARGS);
  return launch<16>(FIR_MP_BANK_ARGS);
#undef FIR_MP_BANK_ARGS
}
