// One octave of the integer session step: the fixed-point twin of
// fir_mp_stream.cu.
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_stream_octave_q (the
// Pallas kernel _fir_mp_stream_q_kernel). Plain PyTorch version:
// repro_torch/kernels/ref.py, fir_mp_stream_octave_q.
//
// What it computes, per slot s (one chunk row of int32 register codes):
//   * for each block of LB positions (LB = accumulate_block_len(L)), in
//     order: splice the slot's delay line in front of the block; for every
//     position p and band-pass filter f, rescale the window codes by
//     sig_shift and solve fxp_mp_dot (operands clamped onto the band
//     spec, integer bisection with gamma_bp / iters_bp); add max(y, 0) of
//     the valid positions (p < n) to that filter's partial sum;
//   * solve only the kept low-pass positions at the slot's ÷2 phase
//     (window start + 2j + k, rescaled by lp_sig_shift, lp spec, gamma_lp
//     / iters_lp) and write clamp(rescale(kept, lp_out_shift), next_qmin,
//     next_qmax): the next octave's register codes;
//   * slide the delay line by the block's valid count, and (octave 0)
//     raise the running amax to the block's max |code|;
//   * at the end write acc + (part << acc_shift), the delay line, amax.
// A slot with n = 0 comes back bit for bit: its delay slides by 0 and its
// partials stay 0.
//
// What bounds it on an H100: operations. At S = 256 slots and 160-sample
// packets the codes are a few hundred KB, while every (position, filter)
// costs ~1.6k int32 instructions. The Pallas grid (slot_block,
// chunk_block, filter) ran in order so VMEM scratch could carry state; on
// Hopper nothing carries between CTAs, so one CTA owns one slot and loops
// over its chunk blocks with the delay line, the partials and amax in
// shared memory; threads take positions and solve every filter from
// registers. The stage's constants and tap codes ride in the parameter
// space (__grid_constant__).
//
// Integer addition and max are associative, so the partial sums and the
// amax reduce in any order and still give the reference's bits: warp
// __reduce_add_sync / __reduce_max_sync, then shared-memory atomics. None
// of the float kernel's adjacent-pair tree ordering is needed. Sums wrap
// in unsigned arithmetic, like the reference's int32 (the reference's
// interval proof keeps every register far from 2**31 for sessions up to
// 4,202,512 samples).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

#include "fixed_point.cuh"

namespace {

constexpr int kMaxBP = 512;   // F * M band-pass tap codes
constexpr int kLP = 8;        // low-pass lanes (M_lp <= 8)
constexpr int kP = 16;        // band-pass lanes (M <= 16)
constexpr unsigned kFull = 0xffffffffu;

// The compiled OctaveStage, flattened (core/fixed.py OctaveStage).
struct Stage {
  int bp[kMaxBP];   // (F, M) taps, each row reversed (conv order w = h[::-1])
  int lp[kLP];      // low-pass taps, reversed
  int F, M, M_lp, T1;
  int sig_shift, lp_sig_shift, lp_out_shift, acc_shift;
  int gamma_bp, iters_bp, gamma_lp, iters_lp;
  int band_qmin, band_qmax, lp_qmin, lp_qmax, next_qmin, next_qmax;
};
constexpr int kScalars = 18;  // F .. next_qmax, in this order
static_assert(offsetof(Stage, next_qmax) - offsetof(Stage, F) ==
                  (kScalars - 1) * sizeof(int),
              "the scalars of Stage must be contiguous ints");

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(512)
fir_mp_stream_q_kernel(const int* __restrict__ x, const int* __restrict__ n,
                       const int* __restrict__ start,
                       const int* __restrict__ delay,
                       const int* __restrict__ acc,
                       const int* __restrict__ amax,
                       const __grid_constant__ Stage st,
                       int* __restrict__ acc_out, int* __restrict__ delay_out,
                       int* __restrict__ amax_out, int* __restrict__ y_next,
                       int L, int LB, int emit_next, int update_amax) {
  extern __shared__ int smem[];
  int* buf = smem;                                     // T1 + LB codes
  unsigned* part = reinterpret_cast<unsigned*>(buf + st.T1 + LB);  // F
  int* am_s = reinterpret_cast<int*>(part + st.F);     // running amax

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int T1 = st.T1, M = st.M, M_lp = st.M_lp;
  const int NB = (L + LB - 1) / LB;
  const int half = LB / 2;
  const int l_next = (L + 1) / 2;
  const int nv = n[s];
  const int ph = start[s];

  for (int i = tid; i < T1; i += nthreads) buf[i] = delay[(size_t)s * T1 + i];
  for (int i = tid; i < st.F; i += nthreads) part[i] = 0u;
  if (tid == 0) *am_s = amax[s];

  for (int b = 0; b < NB; ++b) {
    const int p = b * LB + tid;      // chunk position of this thread
    if (tid < LB) buf[T1 + tid] = p < L ? x[(size_t)s * L + p] : 0;
    __syncthreads();

    if (update_amax) {               // integer max: any order
      const int m = __reduce_max_sync(kFull, tid < LB ? abs(buf[T1 + tid]) : 0);
      if ((tid & 31) == 0) atomicMax(am_s, m);
    }

    // band-pass: window p covers buf[T1 - (M-1) + p .. + M-1]
    int xw[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k)
      xw[k] = (tid < LB && k < M)
                  ? fxp::rescale(buf[T1 - (M - 1) + tid + k], st.sig_shift)
                  : 0;
    for (int f = 0; f < st.F; ++f) {
      int u[kP], v[kP];
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const int w = k < M ? st.bp[f * M + k] : 0;
        u[k] = fxp::clamp(wadd(w, xw[k]), st.band_qmin, st.band_qmax);
        v[k] = fxp::clamp(wsub(w, xw[k]), st.band_qmin, st.band_qmax);
      }
      const int y = fxp::mp_dot_q(u, v, M, st.gamma_bp, st.iters_bp);
      const unsigned h =
          (tid < LB && p < nv) ? static_cast<unsigned>(max(y, 0)) : 0u;
      const unsigned wsum = __reduce_add_sync(kFull, h);
      if ((tid & 31) == 0 && wsum) atomicAdd(&part[f], wsum);
    }

    // low-pass + ÷2: only the kept positions, at this slot's phase, emitted
    // on the next octave's register grid
    const int j = b * half + tid;
    if (emit_next && tid < half && j < l_next) {
      int u[kLP], v[kLP];
#pragma unroll
      for (int k = 0; k < kLP; ++k) {
        const int xl =
            k < M_lp ? fxp::rescale(buf[T1 - (M_lp - 1) + ph + 2 * tid + k],
                                    st.lp_sig_shift)
                     : 0;
        const int w = k < M_lp ? st.lp[k] : 0;
        u[k] = fxp::clamp(wadd(w, xl), st.lp_qmin, st.lp_qmax);
        v[k] = fxp::clamp(wsub(w, xl), st.lp_qmin, st.lp_qmax);
      }
      const int kept = fxp::mp_dot_q(u, v, M_lp, st.gamma_lp, st.iters_lp);
      y_next[(size_t)s * l_next + j] = fxp::clamp(
          fxp::rescale(kept, st.lp_out_shift), st.next_qmin, st.next_qmax);
    }
    __syncthreads();

    // slide the delay line by this block's valid count; a slot with no
    // valid samples keeps its registers bit for bit
    const int vb = min(max(nv - b * LB, 0), LB);
    const int d = tid < T1 ? buf[vb + tid] : 0;
    __syncthreads();
    if (tid < T1) buf[tid] = d;
    __syncthreads();
  }

  if (tid < st.F)
    acc_out[(size_t)s * st.F + tid] =
        wadd(acc[(size_t)s * st.F + tid],
             fxp::shl(static_cast<int>(part[tid]), st.acc_shift));
  for (int i = tid; i < T1; i += nthreads) delay_out[(size_t)s * T1 + i] = buf[i];
  if (tid == 0) amax_out[s] = *am_s;
}

}  // namespace

// One octave for S slots. x (S, L), n (S,), start (S,), delay (S, T1), acc
// (S, F), amax (S,) int32 on the card; y_next (S, (L + 1) / 2) int32 (may
// be null without emit_next). bp_host (F, M) and lp_host (M_lp,) int32 tap
// codes and `scalars` (the 18 ints F, M, M_lp, T1, sig_shift, lp_sig_shift,
// lp_out_shift, acc_shift, gamma_bp, iters_bp, gamma_lp, iters_lp,
// band_qmin, band_qmax, lp_qmin, lp_qmax, next_qmin, next_qmax) are host
// memory. Returns 0, a cudaError_t code, or -1 for shapes outside what it
// takes (1 <= M <= 16, 1 <= M_lp <= 8, M - 1 <= T1, M_lp - 1 <= T1,
// T1 <= 31, 1 <= F <= 32, L >= 1, even LB in [2, 512], iters >= 0).
extern "C" int fir_mp_stream_q_launch(
    const void* x, const void* n, const void* start, const void* delay,
    const void* acc, const void* amax, const void* bp_host,
    const void* lp_host, const void* scalars, void* acc_out,
    void* delay_out, void* amax_out, void* y_next, int S, int L, int LB,
    int emit_next, int update_amax, void* stream) {
  Stage st;
  memcpy(&st.F, scalars, sizeof(int) * kScalars);
  if (S < 1 || L < 1 || LB < 2 || LB > 512 || (LB & (LB - 1)) || st.F < 1 ||
      st.F > 32 || st.M < 1 || st.M > kP || st.M_lp < 1 || st.M_lp > kLP ||
      st.T1 > 31 || st.M - 1 > st.T1 || st.M_lp - 1 > st.T1 ||
      st.iters_bp < 0 || st.iters_lp < 0 || (emit_next && !y_next))
    return -1;
  const int* bp = static_cast<const int*>(bp_host);
  const int* lp = static_cast<const int*>(lp_host);
  for (int f = 0; f < st.F; ++f)
    for (int k = 0; k < st.M; ++k)
      st.bp[f * st.M + k] = bp[f * st.M + (st.M - 1 - k)];
  for (int k = 0; k < st.M_lp; ++k) st.lp[k] = lp[st.M_lp - 1 - k];
  const int threads = LB < 32 ? 32 : ((LB + 31) / 32) * 32;
  const size_t bytes = sizeof(int) * ((size_t)st.T1 + LB + st.F + 1);
  fir_mp_stream_q_kernel<<<S, threads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(n),
      static_cast<const int*>(start), static_cast<const int*>(delay),
      static_cast<const int*>(acc), static_cast<const int*>(amax), st,
      static_cast<int*>(acc_out), static_cast<int*>(delay_out),
      static_cast<int*>(amax_out), static_cast<int*>(y_next), L, LB,
      emit_next, update_amax);
  return static_cast<int>(cudaGetLastError());
}
