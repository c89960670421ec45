// The integer session step: the fixed-point twin of fir_mp_stream.cu, for
// one octave or for the whole octave cascade of a served wave in one
// launch, on int32 codes (the hardware twin) or on integer codes carried
// in float32 (the fake-quant twin; one instance of each body per carrier).
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_stream_octave_q (the
// Pallas kernel _fir_mp_stream_q_kernel), and the per-octave loop around
// it in src/repro/kernels/ops.py, fir_mp_stream_q. Plain PyTorch
// versions: repro_torch/kernels/ref.py, fir_mp_stream_octave_q and
// fir_mp_stream_q.
//
// What it computes, per slot s (one chunk row of int32 register codes) and
// octave o in order:
//   * for each block of LB positions (LB = accumulate_block_len(L_o)), in
//     order: splice the octave's delay line in front of the block; for
//     every valid position p and band-pass filter f, rescale the window
//     codes by sig_shift and solve fxp_mp_dot (operands clamped onto the
//     band spec, integer bisection with gamma_bp / iters_bp); add max(y, 0)
//     to that filter's partial sum;
//   * solve the kept low-pass positions at the slot's ÷2 phase (window
//     start + 2j + k, rescaled by lp_sig_shift, lp spec, gamma_lp /
//     iters_lp) and write clamp(rescale(kept, lp_out_shift), next_qmin,
//     next_qmax): the next octave's register codes;
//   * slide the delay line by the block's valid count, and (octave 0)
//     raise the running amax to the block's max |code|;
//   * at the end of the octave write acc + (part << acc_shift) into its
//     accumulator columns, the delay line and consumed + n; the next
//     octave runs on the kept codes with n' = max(n - phase + 1, 0) >> 1.
// A slot with n = 0 comes back bit for bit: its delay slides by 0 and its
// partials stay 0. The one-octave entry runs one stage and writes every
// kept position j < (L + 1) / 2, the full y_next.
//
// What bounds it on an H100: integer operations. The layout is the float
// kernel's (one launch per wave, one CTA walking one slot through the
// octaves, the kept codes in a per-slot scratch row read back after a
// barrier; work items are one branch of one (valid position, filter) pair
// or of one kept low-pass position, the two branches in adjacent lanes).
// The bisection step runs in its cheapest exact form (fxp::mpabs_q_mag:
// one max and one add per lane). The compiled program's stage constants and
// tap codes (about 2.2 KB per octave) sit in one device table that the
// wrapper packs once per program; each CTA copies its octave's record
// into shared memory.
//
// Integer addition and max are associative, so on int32 the partial sums
// and the amax reduce in any order and still give the reference's bits.
// Sums wrap in unsigned arithmetic, like the reference's int32 (the
// reference's interval proof keeps every register far from 2**31 for
// sessions up to 4,202,512 samples). On the float carrier every sum runs in
// a fixed order (each lane's positions in turn, a fixed butterfly across
// the warp, the blocks in turn), so a wave gives the same bits on every run
// where sums pass 2**24; the amax, a max of codes >= 0, is an int max on
// their bits, exact in any order. The accumulators take one f32 add per
// wave, acc + (part << acc_shift), as the plain version's. The kernel
// computes in f32 throughout, as the reference's kernel on this carrier:
// nothing is converted to int32 on the way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace {

constexpr int kMaxOctaves = 8;
constexpr int kMaxThreads = 256;
constexpr int kMaxLB = 512;   // filterbank.STREAM_BLOCK
constexpr int kMaxF = 32;
constexpr int kP = 16;        // band-pass lanes (M <= 16)
constexpr int kLP = 8;        // low-pass lanes (M_lp <= 8)
constexpr int kHead = 32;     // stage header words
constexpr int kMaxBP = 512;   // F * M band-pass tap codes
constexpr int kStageWords = kHead + kMaxBP + kLP;
constexpr unsigned kFull = 0xffffffffu;

// The stage header, in the order kernels/fir_mp.py (STAGE_FIELDS) packs
// it; then F x M band-pass codes at kHead (each row reversed: conv order
// w = h[::-1]) and M_lp low-pass codes at kHead + kMaxBP (reversed).
enum { hF, hM, hM_lp, hT1, hSigShift, hLpSigShift, hLpOutShift, hAccShift,
       hGammaBp, hItersBp, hGammaLp, hItersLp, hBandQmin, hBandQmax,
       hLpQmin, hLpQmax, hNextQmin, hNextQmax, hEmit, kHeadFields };
static_assert(kHeadFields <= kHead, "the stage header must fit kHead");

struct Octave {
  const void* delay_in;  // (S, T1) codes, on the kernel's carrier
  void* delay_out;       // (S, T1)
  const int* phase_in;   // cascade: consumed (S,); one octave: start (S,)
  int* consumed_out;     // (S,), cascade only
  int col;               // first accumulator column
};

struct Table {
  Octave oct[kMaxOctaves];
};

__host__ __device__ inline int block_len(int n) {  // accumulate_block_len
  int b = 2;
  while (b < n && b < kMaxLB) b <<= 1;
  return b;
}

// The shared words below (kernels/fir_mp.py, stream_plan(integer=True)).
__host__ inline long smem_words(int L, int F, int M, int T1) {
  const int LB = block_len(L);
  return (long)T1 + LB + kHead + (long)F * M + kLP + (long)F * LB + F + 1;
}

// One branch of fxp_mp_dot over the window xs (codes, rescaled by `shift`)
// and the reversed taps ws: mpabs(clamp(w + x)) (br 0) or mpabs(clamp(w -
// x)) (br 1), operands clamped onto [qmin, qmax] and solved from their
// magnitudes.
template <int P, int MC, typename T>
__device__ __forceinline__ T mpabs_branch(const T* xs, const T* ws, int M,
                                          int br, int shift, int qmin,
                                          int qmax, int gamma, int iters) {
  const int m = MC ? MC : M;
  T a[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const T x = k < m ? fxp::rescale(xs[k], shift) : T(0);
    const T w = k < m ? ws[k] : T(0);
    a[k] = fxp::mag(fxp::clamp(br ? fxp::wsub(w, x) : fxp::wadd(w, x),
                               static_cast<T>(qmin), static_cast<T>(qmax)));
  }
  return fxp::mpabs_q_mag<P, MC>(a, M, gamma, iters);
}

// T: the carrier, int (int32 codes) or float (f32-carried codes)
template <typename T>
struct Args {
  const T* x;            // (S, L) chunk codes (octave 0)
  const int* n;          // (S,) valid counts (octave 0)
  const T* acc;          // (S, P) accumulators in
  const T* amax;         // (S,) running max |code| in
  T* acc_out;            // (S, P)
  T* amax_out;           // (S,)
  T* y;                  // (S, ystride): y_next (one octave) or scratch
  const int* stages;     // (num_octaves, kStageWords) device table
  int L, P, ystride, num_octaves, M, M_lp, T1, F_max, update_amax, cascade;
};

template <typename T, int MB, int ML>
__global__ void __launch_bounds__(kMaxThreads)
fir_mp_stream_q_kernel(const Args<T> a, const __grid_constant__ Table t) {
  using S_t = typename fxp::SumOf<T>::type;
  extern __shared__ int smem[];
  const int T1 = a.T1, M = MB ? MB : a.M, M_lp = ML ? ML : a.M_lp;
  const int LB0 = block_len(a.L);
  T* buf = reinterpret_cast<T*>(smem);   // T1 + LB0: [delay line | block]
  int* hd = smem + T1 + LB0;             // stage header
  T* hs = reinterpret_cast<T*>(hd + kHead);  // F x M band-pass codes
  T* ls = hs + a.F_max * M;              // M_lp low-pass codes
  S_t* hv = reinterpret_cast<S_t*>(ls + kLP);            // F x LB HWR
  S_t* part = hv + a.F_max * LB0;                        // F partials
  int* am_s = reinterpret_cast<int*>(part + a.F_max);    // running amax

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;

  const T* src = a.x + (size_t)s * a.L;
  T* yrow = a.y ? a.y + (size_t)s * a.ystride : nullptr;
  int Lo = a.L;
  int nv = a.n[s];
  if (tid == 0) *am_s = fxp::max_bits(a.amax[s]);

  for (int o = 0; o < a.num_octaves; ++o) {
    const Octave& oc = t.oct[o];
    const int* rec = a.stages + (size_t)o * kStageWords;
    const int F = rec[hF];
    for (int i = tid; i < kHead; i += nthreads) hd[i] = rec[i];
    // the tap codes onto the carrier, as the reference casts H_q
    for (int i = tid; i < F * M; i += nthreads)
      hs[i] = static_cast<T>(rec[kHead + i]);
    for (int i = tid; i < M_lp; i += nthreads)
      ls[i] = static_cast<T>(rec[kHead + kMaxBP + i]);
    for (int i = tid; i < F; i += nthreads) part[i] = S_t(0);
    __syncthreads();
    const int emit = hd[hEmit];
    const int LB = block_len(Lo);
    const int NB = (Lo + LB - 1) / LB;
    const int half = LB / 2;
    const int ph = a.cascade ? (oc.phase_in[s] & 1) : oc.phase_in[s];
    const int n_next = max(nv - ph + 1, 0) >> 1;
    const int kept = !emit ? 0 : (a.cascade ? n_next : a.ystride);
    const bool reread = a.cascade && o > 0;  // src is the scratch row

    const T* delay_in = static_cast<const T*>(oc.delay_in);
    for (int i = tid; i < T1; i += nthreads)
      buf[i] = delay_in[(size_t)s * T1 + i];

    for (int b = 0; b < NB; ++b) {
      const int v = min(max(nv - b * LB, 0), LB);
      const int kb = min(max(kept - b * half, 0), half);
      T m = 0;
      for (int i = tid; i < LB; i += nthreads) {
        const int p = b * LB + i;
        // past the valid prefix the scratch row holds nothing written
        const bool in = reread ? p < nv : p < Lo;
        const T xv = in ? (reread ? __ldcg(src + p) : src[p]) : T(0);
        buf[T1 + i] = xv;
        m = fxp::vmax(m, fxp::mag(xv));
      }
      if (a.update_amax && o == 0) {   // a max of codes >= 0: any order
        const int mb = __reduce_max_sync(kFull, fxp::max_bits(m));
        if (lane == 0) atomicMax(am_s, mb);
      }
      __syncthreads();

      // work items: 2 branches x (v x F band-pass pairs, then kb low-pass)
      const int nbp = v * F;
      const int items = 2 * (nbp + kb);
      for (int base = warp * 32; base < items; base += nthreads) {
        const int i = base + lane;
        const int q = i >> 1, br = i & 1;
        const bool act = i < items;
        const bool is_bp = q < nbp;
        int f = 0, p = 0;
        T z = 0;
        if (act) {
          if (is_bp) {
            f = q / v;
            p = q - f * v;
            z = mpabs_branch<kP, MB>(buf + T1 - (M - 1) + p, hs + f * M, M,
                                     br, hd[hSigShift], hd[hBandQmin],
                                     hd[hBandQmax], hd[hGammaBp],
                                     hd[hItersBp]);
          } else {
            p = q - nbp;                 // kept position within the block
            z = mpabs_branch<kLP, ML>(buf + T1 - (M_lp - 1) + ph + 2 * p, ls,
                                      M_lp, br, hd[hLpSigShift],
                                      hd[hLpQmin], hd[hLpQmax],
                                      hd[hGammaLp], hd[hItersLp]);
          }
        }
        const T other = __shfl_xor_sync(kFull, z, 1);
        if (act && br == 0) {
          const T y = z - other;         // mpabs(u) - mpabs(v)
          if (is_bp)
            hv[f * LB + p] = fxp::hwr_term(y);
          else
            yrow[b * half + p] = fxp::clamp(
                fxp::rescale(y, hd[hLpOutShift]),
                static_cast<T>(hd[hNextQmin]), static_cast<T>(hd[hNextQmax]));
        }
      }
      __syncthreads();

      // each filter's valid HWR values: each lane's positions in turn,
      // then across the warp (int32: any order; float: fxp::warp_sum's)
      for (int f = warp; f < F; f += nwarps) {
        S_t sum = S_t(0);
        for (int p = lane; p < v; p += 32) sum += hv[f * LB + p];
        sum = fxp::warp_sum(sum);
        if (lane == 0) part[f] += sum;
      }

      // slide the delay line by this block's valid count; a slot with no
      // valid samples keeps its registers bit for bit
      const T d = tid < T1 ? buf[v + tid] : T(0);
      __syncthreads();
      if (tid < T1) buf[tid] = d;
      __syncthreads();
    }

    for (int f = tid; f < F; f += nthreads) {
      const size_t c = (size_t)s * a.P + oc.col + f;
      a.acc_out[c] = fxp::wadd(
          a.acc[c], fxp::shl(fxp::from_sum(part[f]), hd[hAccShift]));
    }
    T* delay_out = static_cast<T*>(oc.delay_out);
    for (int i = tid; i < T1; i += nthreads)
      delay_out[(size_t)s * T1 + i] = buf[i];
    if (oc.consumed_out && tid == 0)
      oc.consumed_out[s] = fxp::wadd(oc.phase_in[s], nv);
    // the next octave: the kept codes, read back after the barrier
    src = yrow;
    nv = n_next;
    Lo = (Lo + 1) / 2;
    __syncthreads();
  }
  if (tid == 0) a.amax_out[s] = fxp::from_max_bits<T>(*am_s);
}

// Fields of one host table row, as int64 (kernels/fir_mp.py packs them).
enum { kDelayIn, kDelayOut, kPhaseIn, kConsumedOut, kCol, kOctFields };

template <typename T, int MB, int ML>
int launch(const Args<T>& args, const Table& t, int S, int threads,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = fir_mp_stream_q_kernel<T, MB, ML>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<S, threads, smem_bytes, stream>>>(args, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* n, const void* acc, const void* amax,
        void* acc_out, void* amax_out, void* y, const void* stages,
        const Table& t, int num_octaves, int S, int L, int P, int ystride,
        int F_max, int M, int M_lp, int T1, int update_amax, int cascade,
        int threads, int smem_bytes, cudaStream_t st) {
  Args<T> args;
  args.x = static_cast<const T*>(x);
  args.n = static_cast<const int*>(n);
  args.acc = static_cast<const T*>(acc);
  args.amax = static_cast<const T*>(amax);
  args.acc_out = static_cast<T*>(acc_out);
  args.amax_out = static_cast<T*>(amax_out);
  args.y = static_cast<T*>(y);
  args.stages = static_cast<const int*>(stages);
  args.L = L;
  args.P = P;
  args.ystride = ystride;
  args.num_octaves = num_octaves;
  args.M = M;
  args.M_lp = M_lp;
  args.T1 = T1;
  args.F_max = F_max;
  args.update_amax = update_amax;
  args.cascade = cascade;
  if (M == 16 && M_lp == 6)
    return launch<T, 16, 6>(args, t, S, threads, smem_bytes, st);
  return launch<T, 0, 0>(args, t, S, threads, smem_bytes, st);
}

}  // namespace

// The integer stream kernel for S slots over `num_octaves` stages. x (S,
// L), acc / acc_out (S, P), amax / amax_out (S,) and y codes on the card,
// int32 or, under `float_carrier`, float32 (all on one carrier); n (S,)
// and the phase / consumed counters int32; y (S, ystride): the one-octave
// entry's y_next (ystride = (L + 1) / 2) or the cascade's scratch row
// (ystride >= (L + 1) / 2), null when no stage emits. `stages` is the
// device table (num_octaves x 552 int32, kernels/fir_mp.py pack_stages),
// read onto the carrier; `octs` (num_octaves x kOctFields int64) is host
// memory, copied into the launch's parameters; `F_max`, M, M_lp and T1
// must be the table's. `threads` and `smem_bytes` come from the launch
// plan; a plan that does not cover this kernel's need is refused. Returns
// 0, a cudaError_t code, or -1 for shapes outside what it takes (1 <= M <=
// 16, 1 <= M_lp <= 8, M - 1 <= T1, M_lp - 1 <= T1, T1 <= 31, 1 <= F <=
// 32, 1 <= num_octaves <= 8, threads a multiple of 32 in [32, 256]).
extern "C" int fir_mp_stream_q_launch(
    const void* x, const void* n, const void* acc, const void* amax,
    void* acc_out, void* amax_out, void* y, const void* stages,
    const int64_t* octs, int num_octaves, int S, int L, int P, int ystride,
    int F_max, int M, int M_lp, int T1, int update_amax, int cascade,
    int float_carrier, int threads, int smem_bytes, void* stream) {
  if (S < 1 || L < 1 || num_octaves < 1 || num_octaves > kMaxOctaves ||
      F_max < 1 || F_max > kMaxF || F_max * M > kMaxBP || M < 1 || M > kP ||
      M_lp < 1 || M_lp > kLP || T1 > 31 || M - 1 > T1 || M_lp - 1 > T1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 || !stages ||
      !amax_out || (cascade ? (num_octaves > 1 && ystride < (L + 1) / 2)
                            : (num_octaves != 1 ||
                               (y && ystride != (L + 1) / 2))))
    return -1;
  Table t = {};
  for (int o = 0; o < num_octaves; ++o) {
    const int64_t* r = octs + (size_t)o * kOctFields;
    Octave& oc = t.oct[o];
    oc.delay_in = reinterpret_cast<const void*>(r[kDelayIn]);
    oc.delay_out = reinterpret_cast<void*>(r[kDelayOut]);
    oc.phase_in = reinterpret_cast<const int*>(r[kPhaseIn]);
    oc.consumed_out = reinterpret_cast<int*>(r[kConsumedOut]);
    oc.col = static_cast<int>(r[kCol]);
    if (oc.col < 0 || oc.col + 1 > P || !oc.delay_in || !oc.delay_out ||
        !oc.phase_in || (cascade && !oc.consumed_out))
      return -1;
  }
  if ((cascade && num_octaves > 1) && !y) return -1;
  const long need = smem_words(L, F_max, M, T1) * (long)sizeof(int);
  if (smem_bytes < need || smem_bytes > 227 * 1024) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (float_carrier ? run<float> : run<int>)(
      x, n, acc, amax, acc_out, amax_out, y, stages, t, num_octaves, S, L,
      P, ystride, F_max, M, M_lp, T1, update_amax, cascade, threads,
      smem_bytes, st);
}
