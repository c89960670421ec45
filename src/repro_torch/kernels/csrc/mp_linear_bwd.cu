// The backward of the multiplierless MP product (paper eq. 9).
//
// Replaces: src/repro/kernels/ops.py, _mp_linear_vjp_bwd (jnp, the custom
// VJP of mp_linear_pallas). Plain PyTorch version: repro_torch/kernels/
// ref.py, mp_linear_bwd.
//
// What it computes: for y = mp_linear(x, w, gamma) and the output gradient
// g (B, O), with u = x[b] + w[:, o] and v = x[b] - w[:, o] (d each) and
// z_t the exact water level of [t; -t] (the sort-based closed form, not
// the forward's bisection midpoint),
//   m_t[i] = (1{t_i > z_t} - 1{-t_i > z_t}) / k_t,
//   k_t = max(#{operands of [t; -t] above z_t}, 1),
//   dx[b, i] = sum_o g[b, o] (m_u[i] - m_v[i]),
//   dw[i, o] = sum_b g[b, o] (m_u[i] + m_v[i]).
// dgamma is zero, as in the reference. Nothing of size (B, O, d) is
// stored: three passes, each recomputing its masks from x, w and the
// levels.
//
// 1. Levels (mp_linear.cuh's kernel with LEVELS, the forward's tile plan):
//    per (b, o) the forward's bisection, then an exact solve on the
//    support it found; writes lv[b, o] = {z_u, z_v, g / k_u, g / k_v}
//    (B x O x 16 bytes, allocated by the caller).
// 2. dx: a CTA per (BB rows, TI positions); its threads take the columns
//    o in turn (coalesced w and lv loads), each keeping BB x TI sums, then
//    one transposed warp reduction and the 8 warp sums in a fixed order.
// 3. dw: a thread per column o and TI positions (its w values held in
//    registers), summing over the B rows in order; x is read at addresses
//    uniform over the warp.
// A simple form that is right: the levels pass costs about the forward
// (its steps plus ~3 passes of the exact solve); dx and dw each re-read
// the levels once per position tile (PERF.md has the times).
//
// Ties: an operand within rounding of z may land on either side of it
// here and in the sort-based solve, which sum in other orders; the
// comparisons with the plain version state their tolerance for that.

#include "mp_linear.cuh"

namespace {

constexpr int kDxPositions = 8;    // TI of the dx kernel
constexpr int kDwPositions = 32;   // TI of the dw kernel

// the sign mask of one branch: 1{t > z} - 1{-t > z}
__device__ __forceinline__ float sign_mask(float t, float z) {
  return (t > z ? 1.f : 0.f) - (-t > z ? 1.f : 0.f);
}

template <typename WT, int BB, int TI>
__global__ void __launch_bounds__(kThreads)
    mp_linear_dx_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                        const float4* __restrict__ lv, float* __restrict__ dx,
                        int B, int d, int O) {
  constexpr int NV = BB * TI;   // sums per thread, k = b * TI + i
  constexpr int SPREAD = 5 - (NV == 8 ? 3 : NV == 16 ? 4 : 5);
  static_assert(NV == 8 || NV == 16 || NV == 32, "tile");
  __shared__ float red[kWarps][NV];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = static_cast<int>(blockIdx.x) * TI;
  const int b0 = static_cast<int>(blockIdx.y) * BB;
  float xv[BB][TI], acc[NV];
  size_t xrow[BB], wrow[TI];
#pragma unroll
  for (int b = 0; b < BB; ++b) xrow[b] = (size_t)min(b0 + b, B - 1);
#pragma unroll
  for (int i = 0; i < TI; ++i) wrow[i] = (size_t)min(i0 + i, d - 1) * O;
#pragma unroll
  for (int b = 0; b < BB; ++b) {
#pragma unroll
    for (int i = 0; i < TI; ++i)
      xv[b][i] = __ldg(x + xrow[b] * d + min(i0 + i, d - 1));
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  for (int o = tid; o < O; o += kThreads) {
    float4 l[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) l[b] = __ldg(lv + xrow[b] * O + o);
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const float wv = widen1(__ldg(w + wrow[i] + o));
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const float su = sign_mask(xv[b][i] + wv, l[b].x);
        const float sv = sign_mask(xv[b][i] - wv, l[b].y);
        acc[b * TI + i] += l[b].z * su - l[b].w * sv;
      }
    }
  }
  const float v = warp_transpose_reduce<NV>(acc, lane, Add());
  if ((lane & ((1 << SPREAD) - 1)) == 0) red[warp][lane >> SPREAD] = v;
  __syncthreads();
  if (tid < NV) {
    float s = red[0][tid];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s += red[q][tid];
    const int b = tid / TI, i = tid % TI;
    if (b0 + b < B && i0 + i < d) dx[(size_t)(b0 + b) * d + i0 + i] = s;
  }
}

template <typename WT, int TI>
__global__ void __launch_bounds__(kThreads)
    mp_linear_dw_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                        const float4* __restrict__ lv, float* __restrict__ dw,
                        int B, int d, int O) {
  const int o = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  const int i0 = static_cast<int>(blockIdx.y) * TI;
  if (o >= O) return;
  float wv[TI], acc[TI];
  int col[TI];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    col[i] = min(i0 + i, d - 1);
    wv[i] = widen1(__ldg(w + (size_t)col[i] * O + o));
    acc[i] = 0.f;
  }
  for (int b = 0; b < B; ++b) {
    const float4 l = __ldg(lv + (size_t)b * O + o);
    const float* xr = x + (size_t)b * d;
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const float xi = __ldg(xr + col[i]);
      acc[i] += l.z * sign_mask(xi + wv[i], l.x) +
                l.w * sign_mask(xi - wv[i], l.y);
    }
  }
#pragma unroll
  for (int i = 0; i < TI; ++i)
    if (i0 + i < d) dw[(size_t)(i0 + i) * O + o] = acc[i];
}

template <typename WT>
int grads(const float* x, const WT* w, const float4* lv, float* dx,
          float* dw, int B, int d, int O, cudaStream_t s) {
  constexpr int TI = kDxPositions;
  const dim3 gx(static_cast<unsigned>(ceil_div(d, TI)),
                static_cast<unsigned>(ceil_div(B, B == 1 ? 1 : B == 2 ? 2
                                                                     : 4)));
  if (B == 1)
    mp_linear_dx_kernel<WT, 1, TI><<<gx, kThreads, 0, s>>>(x, w, lv, dx, B,
                                                           d, O);
  else if (B == 2)
    mp_linear_dx_kernel<WT, 2, TI><<<gx, kThreads, 0, s>>>(x, w, lv, dx, B,
                                                           d, O);
  else
    mp_linear_dx_kernel<WT, 4, TI><<<gx, kThreads, 0, s>>>(x, w, lv, dx, B,
                                                           d, O);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gw(static_cast<unsigned>(ceil_div(O, kThreads)),
                static_cast<unsigned>(ceil_div(d, kDwPositions)));
  mp_linear_dw_kernel<WT, kDwPositions><<<gw, kThreads, 0, s>>>(x, w, lv, dw,
                                                                B, d, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, d) float32, w (d, O) float32 (w_bf16 = 0) or bfloat16 (w_bf16 = 1),
// g (B, O) float32, row-major; lv (B, O, 4) float32 scratch for the
// levels -> dx (B, d), dw (d, O) float32, by the three passes above on
// `stream`, `iters` bisection steps before the exact solve. Returns 0, a
// cudaError_t code, or -1 for what it does not take (mp_linear_launch's
// shapes; O / 256 and d / 32 tiles within the grid).
extern "C" int mp_linear_bwd_launch(const void* x, const void* w,
                                    const void* g, void* lv, void* dx,
                                    void* dw, int B, int d, int O,
                                    int w_bf16, float gamma, int iters,
                                    void* stream) {
  if (!takes(B, d, O, w_bf16, 0, iters) ||
      ceil_div(d, kDwPositions) > 65535)
    return -1;
  const Plan p = plan_for(B, d, O, w_bf16 ? 2 : 4, 0);
  if (p.BB == 0) return -1;
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float4* l = static_cast<float4*>(lv);
  int code = dispatch<true>(p, x, w, nullptr, B, d, O, w_bf16, gamma, iters,
                            stream, nullptr, gf, l);
  if (code != 0) return code;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dw);
  if (w_bf16)
    return grads<uint16_t>(xf, static_cast<const uint16_t*>(w), l, dxf, dwf,
                           B, d, O, s);
  return grads<float>(xf, static_cast<const float*>(w), l, dxf, dwf, B, d, O,
                      s);
}
