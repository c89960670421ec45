// One octave of the float session step: the stateful MP FIR stream kernel.
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_stream_octave (the Pallas
// kernel _fir_mp_stream_kernel). Plain PyTorch version:
// repro_torch/kernels/ref.py, fir_mp_stream_octave.
//
// What it computes, per slot s (S slots, one chunk row each):
//   * for each block of LB positions (LB = accumulate_block_len(L)), in
//     ascending block order: splice the slot's delay line in front of the
//     block, solve the M-tap MP window of every band-pass filter f
//     (mpabs(w + x) - mpabs(w - x), monotone Newton or bisection), apply
//     HWR masked at the slot's valid count, and add the block's
//     adjacent-pair tree_sum to that filter's partial;
//   * solve only the kept low-pass positions at the slot's ÷2 phase
//     (window start + 2j + k) and write them as the next octave's signal;
//   * slide the delay line by the block's valid count, update the running
//     amax over |block| (octave 0);
//   * at the end write acc + part * 2^o, the delay line and amax.
//
// What bounds it on an H100: operations. At S = 256 slots and 160-sample
// packets the whole signal is under 200 KB, while every (position, filter)
// costs a few thousand f32 instructions (12 Newton steps over 2 x 16
// operands, for u and for v). The Pallas grid (slot_block, chunk_block,
// filter) ran in sequence so that VMEM scratch could carry state; on
// Hopper nothing carries between blocks, so here one CTA owns one slot
// and loops over its chunk blocks, holding the delay line, the F partials
// and amax in shared memory. Threads take positions within a block, each
// solving its window for every filter from registers. S = 256 gives 256
// CTAs for 132 SMs.
//
// Float contract: the adds follow the reference's DAG exactly — the MP
// sums are adjacent-pair trees over the (zero-padded) operand lanes, the
// per-block HWR sum is an adjacent-pair tree over LB positions (warp
// shuffles at offsets 1, 2, 4, ... then the same tree over warp sums), and
// blocks add to the partial in ascending order. The build uses -fmad=false
// and no fast math (Newton divides; IEEE division is required).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNewtonIters = 12;   // core/mp.py DEFAULT_NEWTON_ITERS
constexpr int kBisectIters = 26;   // core/mp.py DEFAULT_BISECT_ITERS
constexpr int kMaxWarps = 16;      // LB <= 512
constexpr int kLP = 8;             // low-pass operand lanes (M_lp <= 8)
constexpr unsigned kFull = 0xffffffffu;

// tree_sum: adjacent-pair tree over P lanes (P a power of 2, unused lanes
// zero): the sum of lanes [B, B + W) is tree(left half) + tree(right half),
// which is exactly the level-by-level pairing h[0::2] + h[1::2]. Written
// as a compile-time recursion: in-place level updates (t[i] = t[2i] +
// t[2i+1]) kept the lane arrays in local memory (see PERF.md).
template <int B, int W, int P>
__device__ __forceinline__ float tree_at(const float (&t)[P]) {
  if constexpr (W == 1)
    return t[B];
  else
    return tree_at<B, W / 2>(t) + tree_at<B + W / 2, W / 2>(t);
}

template <int P>
__device__ __forceinline__ float tree_sum(const float (&t)[P]) {
  return tree_at<0, P>(t);
}

// mpabs_newton: MP([u; -u], gamma) over the first M of P lanes.
template <int P>
__device__ __forceinline__ float mpabs_newton(const float (&u)[P], int M,
                                              float gamma) {
  float a[P];
  float amax = -INFINITY;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    a[k] = fabsf(u[k]);
    if (k < M) amax = fmaxf(amax, a[k]);
  }
  float z = amax - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < kNewtonIters; ++it) {
    float tp[P], tn[P];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < M) {
        tp[k] = fmaxf(a[k] - z, 0.f);
        tn[k] = fmaxf(-a[k] - z, 0.f);
        cnt += (a[k] > z) + (-a[k] > z);
      } else {
        tp[k] = 0.f;
        tn[k] = 0.f;
      }
    }
    const float s = tree_sum(tp) + tree_sum(tn);
    z = z + (s - gamma) / fmaxf(static_cast<float>(cnt), 1.f);
  }
  return z;
}

// mpabs (bisection): MP([u; -u], gamma) on [max|u| - gamma, max|u|].
template <int P>
__device__ __forceinline__ float mpabs_bisect(const float (&u)[P], int M,
                                              float gamma) {
  float hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k < M) hi = fmaxf(hi, fabsf(u[k]));
  float lo = hi - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = (lo + hi) * 0.5f;
    float tp[P], tn[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      tp[k] = k < M ? fmaxf(u[k] - mid, 0.f) : 0.f;
      tn[k] = k < M ? fmaxf(-u[k] - mid, 0.f) : 0.f;
    }
    const bool too_low = (tree_sum(tp) + tree_sum(tn)) > gamma;
    lo = too_low ? mid : lo;
    hi = too_low ? hi : mid;
  }
  return (lo + hi) * 0.5f;
}

// _mp_dot_fast: mpabs(w + x) - mpabs(w - x); solver 0 Newton, 1 bisect.
template <int P>
__device__ __forceinline__ float mp_dot_fast(const float (&x)[P],
                                             const float (&w)[P], int M,
                                             float gamma, int solver) {
  float u[P], v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    u[k] = w[k] + x[k];
    v[k] = w[k] - x[k];
  }
  if (solver == 0)
    return mpabs_newton(u, M, gamma) - mpabs_newton(v, M, gamma);
  return mpabs_bisect(u, M, gamma) - mpabs_bisect(v, M, gamma);
}

template <int PB>
__global__ void __launch_bounds__(512)  // <= 128 registers at LB = 512
fir_mp_stream_octave_kernel(
    const float* __restrict__ x, const int* __restrict__ n,
    const int* __restrict__ start, const float* __restrict__ delay,
    const float* __restrict__ acc, const float* __restrict__ amax,
    const float* __restrict__ H, const float* __restrict__ lp,
    float* __restrict__ acc_out, float* __restrict__ delay_out,
    float* __restrict__ amax_out, float* __restrict__ y_next, int L, int LB,
    int F, int M, int T1, int M_lp, float gamma, float scale, int solver,
    int emit_next, int update_amax) {
  extern __shared__ float smem[];
  float* buf = smem;                 // T1 + LB: [delay line | block]
  float* hs = buf + T1 + LB;         // F x M band-pass taps, each reversed
  float* ls = hs + F * M;            // M_lp low-pass taps, reversed
  float* wsum = ls + M_lp;           // F x kMaxWarps warp partials
  float* wmax = wsum + F * kMaxWarps;  // kMaxWarps warp maxima
  float* part = wmax + kMaxWarps;    // F running partials

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int NB = (L + LB - 1) / LB;
  const int nw = (LB + 31) / 32;     // warps holding positions
  const int half = LB / 2;
  const int nv = n[s];
  const int st = start[s];

  for (int i = tid; i < T1; i += nthreads) buf[i] = delay[(size_t)s * T1 + i];
  for (int i = tid; i < F * M; i += nthreads) {
    const int f = i / M, k = i % M;
    hs[i] = H[f * M + (M - 1 - k)];  // conv tap order: w = h[::-1]
  }
  for (int i = tid; i < M_lp; i += nthreads) ls[i] = lp[M_lp - 1 - i];
  for (int i = tid; i < F; i += nthreads) part[i] = 0.f;
  float am = amax[s];

  for (int b = 0; b < NB; ++b) {
    const int p = b * LB + tid;      // chunk position of this thread
    if (tid < LB) buf[T1 + tid] = p < L ? x[(size_t)s * L + p] : 0.f;
    __syncthreads();

    if (update_amax) {               // max is exact in any order
      float m = tid < LB ? fabsf(buf[T1 + tid]) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      if (lane == 0) wmax[warp] = m;
      __syncthreads();
      float mm = 0.f;
      for (int w = 0; w < nthreads / 32; ++w) mm = fmaxf(mm, wmax[w]);
      am = fmaxf(am, mm);
    }

    // band-pass: window p covers buf[T1 - (M-1) + p .. + M-1]
    float xw[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k)
      xw[k] = (tid < LB && k < M) ? buf[T1 - (M - 1) + tid + k] : 0.f;
    for (int f = 0; f < F; ++f) {
      float h = 0.f;
      if (tid < LB) {
        float w[PB];
#pragma unroll
        for (int k = 0; k < PB; ++k) w[k] = k < M ? hs[f * M + k] : 0.f;
        const float y = mp_dot_fast(xw, w, M, gamma, solver);
        h = p < nv ? fmaxf(y, 0.f) : 0.f;
      }
      // adjacent-pair tree inside the warp: lane 0 ends with the sum of
      // the aligned subtree of its 32 (or LB) positions
      for (int off = 1; off < 32 && off < LB; off <<= 1)
        h = h + __shfl_down_sync(kFull, h, off);
      if (lane == 0 && warp < nw) wsum[f * kMaxWarps + warp] = h;
    }

    // low-pass + ÷2: only the kept positions, at this slot's phase
    if (emit_next && tid < half) {
      float xl[kLP], wl[kLP];
#pragma unroll
      for (int k = 0; k < kLP; ++k) {
        xl[k] = k < M_lp ? buf[T1 - (M_lp - 1) + st + 2 * tid + k] : 0.f;
        wl[k] = k < M_lp ? ls[k] : 0.f;
      }
      y_next[(size_t)s * NB * half + b * half + tid] =
          mp_dot_fast(xl, wl, M_lp, gamma, solver);
    }
    __syncthreads();

    if (tid < F) {                   // the tree continues over warp sums
      float t[kMaxWarps];
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w)
        t[w] = w < nw ? wsum[tid * kMaxWarps + w] : 0.f;
      part[tid] = part[tid] + tree_sum(t);
    }

    // slide the delay line by this block's valid count; a slot with no
    // valid samples keeps its registers bit for bit
    const int v = min(max(nv - b * LB, 0), LB);
    const float d = tid < T1 ? buf[v + tid] : 0.f;
    __syncthreads();
    if (tid < T1) buf[tid] = d;
    __syncthreads();
  }

  if (tid < F)
    acc_out[(size_t)s * F + tid] = acc[(size_t)s * F + tid] + part[tid] * scale;
  if (tid < T1) delay_out[(size_t)s * T1 + tid] = buf[tid];
  if (tid == 0) amax_out[s] = am;
}

template <int PB>
int launch(const float* x, const int* n, const int* start, const float* delay,
           const float* acc, const float* amax, const float* H,
           const float* lp, float* acc_out, float* delay_out, float* amax_out,
           float* y_next, int S, int L, int LB, int F, int M, int T1,
           int M_lp, float gamma, float scale, int solver, int emit_next,
           int update_amax, cudaStream_t stream) {
  const int threads = LB < 32 ? 32 : ((LB + 31) / 32) * 32;
  const size_t floats = (size_t)T1 + LB + F * M + M_lp + F * kMaxWarps +
                        kMaxWarps + F;
  fir_mp_stream_octave_kernel<PB><<<S, threads, floats * sizeof(float),
                                    stream>>>(
      x, n, start, delay, acc, amax, H, lp, acc_out, delay_out, amax_out,
      y_next, L, LB, F, M, T1, M_lp, gamma, scale, solver, emit_next,
      update_amax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, a cudaError_t code if the launch failed, or -1 if
// the shapes are outside what this kernel takes (M <= 16, M_lp <= 8,
// M - 1 <= T1 and M_lp - 1 <= T1, T1 < 32, F <= 32, even LB <= 512,
// solver 0 or 1). Only the 16-lane body is built: every configuration in
// the repo has 16 band-pass taps.
extern "C" int fir_mp_stream_octave_launch(
    const void* x, const void* n, const void* start, const void* delay,
    const void* acc, const void* amax, const void* H, const void* lp,
    void* acc_out, void* delay_out, void* amax_out, void* y_next, int S,
    int L, int LB, int F, int M, int T1, int M_lp, float gamma, float scale,
    int solver, int emit_next, int update_amax, void* stream) {
  if (S < 1 || L < 1 || LB < 2 || LB > 512 || (LB & (LB - 1)) || F < 1 ||
      F > 32 || M < 1 || M > 16 || M_lp < 1 || M_lp > kLP || T1 > 31 ||
      M - 1 > T1 || M_lp - 1 > T1 || (solver != 0 && solver != 1))
    return -1;
  return launch<16>(
      static_cast<const float*>(x), static_cast<const int*>(n),
      static_cast<const int*>(start), static_cast<const float*>(delay),
      static_cast<const float*>(acc), static_cast<const float*>(amax),
      static_cast<const float*>(H), static_cast<const float*>(lp),
      static_cast<float*>(acc_out), static_cast<float*>(delay_out),
      static_cast<float*>(amax_out), static_cast<float*>(y_next), S, L, LB, F,
      M, T1, M_lp, gamma, scale, solver, emit_next, update_amax,
      static_cast<cudaStream_t>(stream));
}
