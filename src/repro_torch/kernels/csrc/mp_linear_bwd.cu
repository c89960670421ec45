// The backward of the multiplierless MP product (paper eq. 9): its grads
// pass.
//
// Replaces: src/repro/kernels/ops.py, _mp_linear_vjp_bwd (jnp, the custom
// VJP of mp_linear_pallas). Plain PyTorch version: repro_torch/kernels/
// ref.py, mp_linear_bwd_from_levels (on given levels; mp_linear_bwd, the
// sort-based rule, for the whole backward).
//
// What it computes: for y = mp_linear(x, w, gamma) and the output gradient
// g (B, O), with u = x[b] + w[:, o] and v = x[b] - w[:, o] (d each) and
// z_t the exact water level of [t; -t] (the sort-based closed form, not
// the forward's bisection midpoint),
//   m_t[i] = (1{t_i > z_t} - 1{-t_i > z_t}) / k_t,
//   k_t = max(#{operands of [t; -t] above z_t}, 1),
//   dx[b, i] = sum_o g[b, o] (m_u[i] - m_v[i]),
//   dw[i, o] = sum_b g[b, o] (m_u[i] + m_v[i]).
// dgamma is zero, as in the reference. The levels come from the training
// forward (mp_linear.cu with a levels buffer): lv[b, o] = {z_u, z_v,
// 1 / k_u, 1 / k_v}; this pass multiplies g[b, o] * (1 / k) itself.
//
// What bounds it: operations, ~14 f32 per (b, o, i) as the rule reads (u,
// v, four compares, two sign subtractions, two products by g / k, two adds
// and two accumulates), against loads of x, w, g and lv that serve many of
// them. Tensor cores cannot help: every mask is a comparison at one
// (b, o, i), used once. So one pass forms each (b, o, i)'s two masks once,
// in ten instructions (u, v, and per branch a compare, a sign and two
// predicated adds: with_sign_of below), and feeds both sums:
//  - a CTA owns 64 positions (8 per warp) x a group of 128-column chunks;
//    lane l takes columns l + 32 j (j < 4) of a chunk, so a warp's loads
//    of lv and g are whole 512-byte lines, and every warp of the CTA reads
//    the same ones (L1);
//  - per chunk a thread holds its 8 x 4 w values and dw sums in registers
//    and walks the rows b in order, x[b] from a shared tile (one broadcast
//    read per warp), so each dw[i, o] is summed over b in order by one
//    thread and written once;
//  - per row the warp's 8 dx sums over its 4 columns go through one
//    transposed warp reduction into a shared [rows][64] partial, which the
//    CTA keeps across its chunks and writes once per column group;
//  - a second launch adds the groups' partials in group order.
// Rows go in blocks of 64 (shared x and dx tiles); a later block reloads
// the dw sums it left, so the order over b stays the same. No atomics: two
// runs give the same bits. Column groups are sized in Python
// (mp_kernels.mp_linear_grads_plan) so that the CTAs fill the card's SMs
// many times over at the head (O = 152,064) and at k/v (O = 1,024) alike;
// the launch refuses a group count that does not cover O.
//
// Ties: an operand within rounding of z may land on either side of it
// here and in the sort-based solve, which sum in other orders; the
// comparisons with the plain version state their tolerance for that.

#include "mp_linear.cuh"

namespace {

constexpr int kPosPerWarp = 8;                            // TI per warp
constexpr int kColsPerLane = 4;
constexpr int kTilePositions = kWarps * kPosPerWarp;      // 64
constexpr int kChunkCols = 32 * kColsPerLane;             // 128
constexpr int kRows = 64;                                 // rows per block

// One branch's mask times g / k, (1{t > z} - 1{-t > z}) g / k, in three
// instructions: with z's threshold tau (mp_linear.cuh) the mask is
// 1{|t| > tau} sign(t), for z < 0 too (a pair with both members above z
// has mask 0): a compare on |t| (abs is an operand modifier), g / k with
// t's sign bit (one logic op), and an add under the compare's predicate.
__device__ __forceinline__ float with_sign_of(float gk, float t) {
  return __int_as_float(__float_as_int(gk) ^
                        (__float_as_int(t) & static_cast<int>(0x80000000u)));
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 2)
    mp_linear_grads_kernel(const float* __restrict__ x,
                           const WT* __restrict__ w,
                           const float* __restrict__ g,
                           const float4* __restrict__ lv,
                           float* __restrict__ dxp, float* __restrict__ dw,
                           int B, int d, int O, int chunks_per_group) {
  constexpr int TI = kPosPerWarp, TJ = kColsPerLane;
  __shared__ __align__(16) float xs[kRows][kTilePositions];
  __shared__ float dxs[kRows][kTilePositions];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = static_cast<int>(blockIdx.x) * kTilePositions;
  const int group = static_cast<int>(blockIdx.y);
  const int pw = warp * TI;   // the warp's positions in the tile
  const int c_begin = group * chunks_per_group;
  const int c_end =
      min((O + kChunkCols - 1) / kChunkCols, c_begin + chunks_per_group);
  float* dxg = dxp + (size_t)group * B * d;

  for (int r0 = 0; r0 < B; r0 += kRows) {
    const int nr = min(kRows, B - r0);
    __syncthreads();   // the last block's dx partial is out
    for (int e = tid; e < kRows * kTilePositions; e += kThreads) {
      const int b = e / kTilePositions, i = e % kTilePositions;
      xs[b][i] = b < nr && i0 + i < d ? x[(size_t)(r0 + b) * d + i0 + i]
                                      : 0.f;
      dxs[b][i] = 0.f;
    }
    __syncthreads();
    for (int c = c_begin; c < c_end; ++c) {
      const int oc = c * kChunkCols + lane;
      float wv[TI][TJ], acc[TI][TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int pos = i0 + pw + i, o = oc + 32 * j;
          const bool in = pos < d && o < O;
          const size_t at = (size_t)pos * O + o;
          wv[i][j] = in ? widen1(w[at]) : 0.f;   // zero: both masks 0
          acc[i][j] = in && r0 > 0 ? dw[at] : 0.f;
        }
      }
      for (int b = 0; b < nr; ++b) {
        const size_t row = (size_t)(r0 + b) * O;
        float tu[TJ], tv[TJ], gu[TJ], gv[TJ];
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int o = oc + 32 * j;
          float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
          float gy = 0.f;   // past O: no gradient
          if (o < O) {
            l = __ldg(lv + row + o);
            gy = __ldg(g + row + o);
          }
          tu[j] = threshold(l.x);
          tv[j] = threshold(l.y);
          gu[j] = gy * l.z;
          gv[j] = gy * l.w;
        }
        const float4 xa = *reinterpret_cast<const float4*>(&xs[b][pw]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[b][pw + 4]);
        const float xv[TI] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        float dxc[TI];
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          dxc[i] = 0.f;
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const float u = xv[i] + wv[i][j], v = xv[i] - wv[i][j];
            const float cu = with_sign_of(gu[j], u);
            const float cv = with_sign_of(gv[j], v);
            if (fabsf(u) > tu[j]) {
              dxc[i] += cu;
              acc[i][j] += cu;
            }
            if (fabsf(v) > tv[j]) {
              dxc[i] -= cv;
              acc[i][j] += cv;
            }
          }
        }
        // lane 4 k holds position k's sum over the chunk's 128 columns
        const float s = warp_transpose_reduce<TI>(dxc, lane, Add());
        if ((lane & 3) == 0) dxs[b][pw + (lane >> 2)] += s;
      }
#pragma unroll
      for (int i = 0; i < TI; ++i) {
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int pos = i0 + pw + i, o = oc + 32 * j;
          if (pos < d && o < O) dw[(size_t)pos * O + o] = acc[i][j];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < nr * kTilePositions; e += kThreads) {
      const int b = e / kTilePositions, i = e % kTilePositions;
      if (i0 + i < d) dxg[(size_t)(r0 + b) * d + i0 + i] = dxs[b][i];
    }
  }
}

// dx[e] = the groups' partials at e, added in group order
__global__ void __launch_bounds__(kThreads)
    mp_linear_dx_sum_kernel(const float* __restrict__ dxp,
                            float* __restrict__ dx, long long n, int groups) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    float s = dxp[e];
    for (int q = 1; q < groups; ++q) s += dxp[q * n + e];
    dx[e] = s;
  }
}

template <typename WT>
int grads(const float* x, const WT* w, const float* g, const float4* lv,
          float* dxp, float* dx, float* dw, int B, int d, int O, int groups,
          int chunks_per_group, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(ceil_div(d, kTilePositions)),
                  static_cast<unsigned>(groups));
  float* part = groups > 1 ? dxp : dx;
  mp_linear_grads_kernel<WT><<<grid, kThreads, 0, s>>>(
      x, w, g, lv, part, dw, B, d, O, chunks_per_group);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || groups == 1) return static_cast<int>(e);
  const long long n = (long long)B * d;
  const long long need = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 8LL * sm_count()
                                          ? need : 8LL * sm_count());
  mp_linear_dx_sum_kernel<<<blocks, kThreads, 0, s>>>(dxp, dx, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, d) float32, w (d, O) float32 (w_bf16 = 0) or bfloat16 (w_bf16 = 1),
// g (B, O) float32, the training forward's levels lv (B, O, 4) float32,
// row-major -> dx (B, d), dw (d, O) float32 on `stream`, in `groups`
// column groups of `chunks_per_group` chunks of 128 columns each; dxp
// (groups, B, d) float32 scratch for the groups' dx partials when groups
// > 1 (unused, may be null, when 1). Returns 0, a cudaError_t code, or -1
// for what it does not take (B, d, O >= 1; groups the count that
// chunks_per_group gives, within the grid).
extern "C" int mp_linear_bwd_launch(const void* x, const void* w,
                                    const void* g, const void* lv, void* dxp,
                                    void* dx, void* dw, int B, int d, int O,
                                    int w_bf16, int groups,
                                    int chunks_per_group, void* stream) {
  if (B < 1 || d < 1 || O < 1 || (w_bf16 != 0 && w_bf16 != 1) ||
      chunks_per_group < 1 || groups < 1 || groups > 65535 ||
      groups != ceil_div(ceil_div(O, kChunkCols), chunks_per_group) ||
      (groups > 1 && dxp == nullptr))
    return -1;
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const float4* l = static_cast<const float4*>(lv);
  float* dxpf = static_cast<float*>(dxp);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return grads<uint16_t>(xf, static_cast<const uint16_t*>(w), gf, l, dxpf,
                           dxf, dwf, B, d, O, groups, chunks_per_group, s);
  return grads<float>(xf, static_cast<const float*>(w), gf, l, dxpf, dxf,
                      dwf, B, d, O, groups, chunks_per_group, s);
}
