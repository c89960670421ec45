// The float session step: the stateful MP FIR stream kernel, for one
// octave or for the whole octave cascade of a served wave in one launch.
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_stream_octave (the Pallas
// kernel _fir_mp_stream_kernel), and the per-octave loop around it in
// src/repro/kernels/ops.py, fir_mp_stream. Plain PyTorch versions:
// repro_torch/kernels/ref.py, fir_mp_stream_octave and fir_mp_stream.
//
// What it computes, per slot s (S slots, one chunk row each) and octave o
// in order:
//   * for each block of LB positions (LB = accumulate_block_len(L_o)), in
//     ascending block order: splice the octave's delay line in front of
//     the block, solve the M-tap MP window of every band-pass filter f at
//     every valid position (mpabs(w + x) - mpabs(w - x), monotone Newton
//     or bisection), HWR, and add the block's adjacent-pair tree over its
//     LB positions (invalid ones +0.0) to that filter's partial;
//   * solve the kept low-pass positions at the slot's ÷2 phase (window
//     start + 2j + k): the next octave's signal;
//   * slide the delay line by the block's valid count; raise the running
//     amax over |block| (octave 0, under update_amax);
//   * at the end of the octave write acc + part * 2^o into the octave's
//     accumulator columns, the delay line, consumed + n; then the next
//     octave runs on the kept signal with n' = max(n - phase + 1, 0) >> 1.
// The one-octave entry (the counterpart of the Pallas function) runs one
// table row and writes every kept low-pass position, the full y_next.
//
// What bounds it on an H100: operations. Each (valid position, filter)
// costs two Newton solves of 12 steps over 16 lanes; a served wave (256
// slots x 160 samples) is ~1 G f32 operations against under 1 MB of
// state. The layout follows from that:
//   * one launch per wave: one CTA owns one slot and walks it through all
//     octaves, so the deep octaves (20, 10, 5 valid samples) neither pay a
//     launch nor a round trip of host glue; the kept signal goes to a
//     per-slot scratch row (L2-resident) that the same CTA reads back
//     after a barrier, so any L works;
//   * threads take work items, not positions: one item is one branch
//     (u = w + x or v = w - x) of one (valid position, filter) pair, or of
//     one kept low-pass position; the two branches of a pair sit in
//     adjacent lanes and meet by one shuffle. No thread solves a position
//     past its octave's valid count: such a position adds exactly +0.0 to
//     the HWR tree, and nothing downstream reads its low-pass output;
//   * the window length is a compile-time constant in the body every
//     configuration runs (16 band-pass taps, 6 low-pass), so the operand
//     lanes unroll without a branch each (a generic body takes M <= 16,
//     M_lp <= 8);
//   * each Newton step runs in the cheapest form its sign of z allows
//     (mpabs_newton), with the same bits as the reference's step.
//
// Float contract (bit for bit the plain version): the MP sums are
// adjacent-pair trees over the operand lanes; each block's HWR sum is an
// adjacent-pair tree over LB positions (warp shuffles in width-min(32, LB)
// groups, then the same tree over the group sums); blocks add to the
// partial in ascending order, then acc + part * scale. Built with
// -fmad=false and no fast math (Newton divides; IEEE division is
// required).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNewtonIters = 12;   // core/mp.py DEFAULT_NEWTON_ITERS
constexpr int kBisectIters = 26;   // core/mp.py DEFAULT_BISECT_ITERS
constexpr int kMaxOctaves = 8;
constexpr int kMaxThreads = 256;   // two CTAs per SM (<= 128 registers)
constexpr int kMaxLB = 512;        // filterbank.STREAM_BLOCK
constexpr int kMaxF = 32;
constexpr int kP = 16;             // band-pass operand lanes (M <= 16)
constexpr int kLP = 8;             // low-pass operand lanes (M_lp <= 8)
constexpr int kHead = 32;          // table header words (the int kernel's)
constexpr int kSeg = 16;           // group sums per filter (kMaxLB / 32)
constexpr unsigned kFull = 0xffffffffu;

// One octave's registers and constants; the host packs these (see
// kernels/fir_mp.py, STREAM_OCTAVE_FIELDS, for the field order).
struct Octave {
  const float* delay_in;   // (S, T1)
  float* delay_out;        // (S, T1)
  const int* phase_in;     // cascade: consumed (S,); one octave: start (S,)
  int* consumed_out;       // (S,), cascade only
  const float* bp;         // (F, M) band-pass taps
  const float* lp;         // (M_lp,) low-pass taps (emit only)
  int F, col, emit;        // filters, first accumulator column, has LP
  float scale;             // 2^o
};

struct Table {
  Octave oct[kMaxOctaves];
};

__host__ __device__ inline int block_len(int n) {  // accumulate_block_len
  int b = 2;
  while (b < n && b < kMaxLB) b <<= 1;
  return b;
}

// Shared words the kernel needs: the launch plan (kernels/fir_mp.py,
// stream_plan) computes the same number.
__host__ inline long smem_words(int L, int F, int M, int T1) {
  const int LB = block_len(L);
  return (long)T1 + LB + kHead + (long)F * M + kLP + (long)F * LB +
         (long)F * kSeg + F + kMaxThreads / 32;
}

// tree_sum: adjacent-pair tree over P lanes (P a power of 2, unused lanes
// zero): the sum of lanes [B, B + W) is tree(left half) + tree(right
// half), exactly the level-by-level pairing h[0::2] + h[1::2]. Written as
// a compile-time recursion so the lanes stay in registers.
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

// The same pairing for the integer count (any order would do; the tree
// keeps the dependency chain log-deep).
template <int B, int W, int P>
__device__ __forceinline__ int itree_at(const int (&t)[P]) {
  if constexpr (W == 1)
    return t[B];
  else
    return itree_at<B, W / 2>(t) + itree_at<B + W / 2, W / 2>(t);
}

// mpabs_newton: MP([u; -u], gamma) over the first m of P lanes; MC is the
// lane count when known at compile time (0: the runtime M). Each step is
// the reference's (core/mp.py mpabs_newton): z += (s - gamma) / max(cnt,
// 1), s = tree(tp) + tree(tn), tp = max(a - z, 0), tn = max(-a - z, 0),
// cnt = #(a > z) + #(-a > z), a = |u| >= 0; the kernel drops what the
// sign of z makes known, and the step keeps its bits:
//   * z < 0: a - z > 0 on every lane, so tp = a - z itself and a > z;
//   * z >= 0 (or NaN): -a - z <= 0, so tree(tn) is +-0, which changes s
//     only when s is +-0, and then s - gamma = -gamma either way; no
//     -a > z.
// The lanes of a warp solve neighbouring windows, which mostly agree on
// the sign; where they do not, the warp runs both forms.
template <int P, int MC>
__device__ __forceinline__ float mpabs_newton(const float (&u)[P], int M,
                                              float gamma) {
  const int m = MC ? MC : M;
  float a[P];
  float amax = -INFINITY;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    a[k] = fabsf(u[k]);
    if (k < m) amax = fmaxf(amax, a[k]);
  }
  float z = amax - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < kNewtonIters; ++it) {
    float tp[P], s;
    int c[P], cnt;
    if (z < 0.f) {
      float tn[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        tp[k] = k < m ? a[k] - z : 0.f;
        tn[k] = k < m ? fmaxf(-a[k] - z, 0.f) : 0.f;
        c[k] = k < m ? -a[k] > z : 0;
      }
      s = tree_sum(tp) + tree_sum(tn);
      cnt = m + itree_at<0, P>(c);
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        tp[k] = k < m ? fmaxf(a[k] - z, 0.f) : 0.f;
        c[k] = k < m ? a[k] > z : 0;
      }
      s = tree_sum(tp);
      cnt = itree_at<0, P>(c);
    }
    // a zero step is +-0 / c = itself: skip the divide, whose zero
    // numerator takes the IEEE divide's slow path (PERF.md §6)
    const float num = s - gamma;
    z = z + (num == 0.f ? num : num / fmaxf(static_cast<float>(cnt), 1.f));
  }
  return z;
}

// mpabs (bisection): MP([u; -u], gamma) on [max|u| - gamma, max|u|].
template <int P, int MC>
__device__ __forceinline__ float mpabs_bisect(const float (&u)[P], int M,
                                              float gamma) {
  const int m = MC ? MC : M;
  float hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k < m) hi = fmaxf(hi, fabsf(u[k]));
  float lo = hi - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = (lo + hi) * 0.5f;
    float tp[P], tn[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      tp[k] = k < m ? fmaxf(u[k] - mid, 0.f) : 0.f;
      tn[k] = k < m ? fmaxf(-u[k] - mid, 0.f) : 0.f;
    }
    const bool too_low = (tree_sum(tp) + tree_sum(tn)) > gamma;
    lo = too_low ? mid : lo;
    hi = too_low ? hi : mid;
  }
  return (lo + hi) * 0.5f;
}

// One branch of _mp_dot_fast's window: mpabs(w + x) (br 0) or mpabs(w - x)
// (br 1) over the window xs[0 .. M) and the reversed taps ws[0 .. M).
template <int P, int MC>
__device__ __forceinline__ float mpabs_branch(const float* xs, const float* ws,
                                              int M, int br, float gamma,
                                              int solver) {
  const int m = MC ? MC : M;
  float u[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float x = k < m ? xs[k] : 0.f;
    const float w = k < m ? ws[k] : 0.f;
    u[k] = br ? w - x : w + x;
  }
  return solver == 0 ? mpabs_newton<P, MC>(u, M, gamma)
                     : mpabs_bisect<P, MC>(u, M, gamma);
}

struct Args {
  const float* x;        // (S, L) chunk (octave 0)
  const int* n;          // (S,) valid counts (octave 0)
  const float* acc;      // (S, P) accumulators in
  const float* amax;     // (S,) running amax in
  float* acc_out;        // (S, P)
  float* amax_out;       // (S,), may be null (cascade without update_amax)
  float* y;              // (S, ystride): y_next (one octave) or scratch
  int L, P, ystride, num_octaves, M, M_lp, T1, F_max, solver, update_amax,
      cascade;
  float gamma;
};

// MB, ML: the band-pass and low-pass window lengths when compiled in (16,
// 6: every configuration of the repo), or 0 for the runtime M, M_lp.
template <int MB, int ML>
__global__ void __launch_bounds__(kMaxThreads, 2)
fir_mp_stream_kernel(const Args a, const __grid_constant__ Table t) {
  extern __shared__ float smem[];
  const int T1 = a.T1, M = MB ? MB : a.M, M_lp = ML ? ML : a.M_lp;
  const int LB0 = block_len(a.L);
  float* buf = smem;                     // T1 + LB0: [delay line | block]
  float* hs = buf + T1 + LB0 + kHead;    // F x M band-pass taps, reversed
  float* ls = hs + a.F_max * M;          // M_lp low-pass taps, reversed
  float* hv = ls + kLP;                  // F x LB: HWR of each position
  float* seg = hv + a.F_max * LB0;       // F x kSeg group sums
  float* part = seg + a.F_max * kSeg;    // F running partials
  float* wmax = part + a.F_max;          // per-warp block maxima

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;

  const float* src = a.x + (size_t)s * a.L;  // this octave's signal row
  float* yrow = a.y ? a.y + (size_t)s * a.ystride : nullptr;
  int Lo = a.L;
  int nv = a.n[s];
  float am = a.amax[s];

  for (int o = 0; o < a.num_octaves; ++o) {
    const Octave& oc = t.oct[o];
    const int F = oc.F;
    const int LB = block_len(Lo);
    const int NB = (Lo + LB - 1) / LB;
    const int half = LB / 2;
    const int ph = a.cascade ? (oc.phase_in[s] & 1) : oc.phase_in[s];
    const int n_next = max(nv - ph + 1, 0) >> 1;
    // kept low-pass positions written: the next octave's valid prefix
    // (cascade) or every kept position of every block (one octave)
    const int kept = !oc.emit ? 0 : (a.cascade ? n_next : a.ystride);
    const bool reread = a.cascade && o > 0;  // src is the scratch row

    for (int i = tid; i < T1; i += nthreads)
      buf[i] = oc.delay_in[(size_t)s * T1 + i];
    for (int i = tid; i < F * M; i += nthreads) {
      const int f = i / M, k = i - f * M;
      hs[i] = oc.bp[f * M + (M - 1 - k)];  // conv tap order: w = h[::-1]
    }
    if (oc.emit)
      for (int i = tid; i < M_lp; i += nthreads) ls[i] = oc.lp[M_lp - 1 - i];
    for (int i = tid; i < F; i += nthreads) part[i] = 0.f;

    for (int b = 0; b < NB; ++b) {
      const int v = min(max(nv - b * LB, 0), LB);
      const int kb = min(max(kept - b * half, 0), half);
      float m = 0.f;
      for (int i = tid; i < LB; i += nthreads) {
        const int p = b * LB + i;
        // past the valid prefix the scratch row holds nothing written
        const bool in = reread ? p < nv : p < Lo;
        const float xv = in ? (reread ? __ldcg(src + p) : src[p]) : 0.f;
        buf[T1 + i] = xv;
        m = fmaxf(m, fabsf(xv));
      }
      for (int i = tid; i < F * LB; i += nthreads)
        if ((i & (LB - 1)) >= v) hv[i] = 0.f;  // skipped: exactly +0.0
      const bool amax_here = a.update_amax && o == 0;
      if (amax_here) {                 // max is exact in any order
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        if (lane == 0) wmax[warp] = m;
      }
      __syncthreads();
      if (amax_here && tid == 0)
        for (int w = 0; w < nwarps; ++w) am = fmaxf(am, wmax[w]);

      // work items: 2 branches x (v x F band-pass pairs, then kb low-pass)
      const int nbp = v * F;
      const int items = 2 * (nbp + kb);
      for (int base = warp * 32; base < items; base += nthreads) {
        const int i = base + lane;
        const int q = i >> 1, br = i & 1;
        const bool act = i < items;
        const bool is_bp = q < nbp;
        int f = 0, p = 0;
        float z = 0.f;
        if (act) {
          if (is_bp) {
            f = q / v;
            p = q - f * v;
            z = mpabs_branch<kP, MB>(buf + T1 - (M - 1) + p, hs + f * M, M,
                                     br, a.gamma, a.solver);
          } else {
            p = q - nbp;                 // kept position within the block
            z = mpabs_branch<kLP, ML>(buf + T1 - (M_lp - 1) + ph + 2 * p,
                                      ls, M_lp, br, a.gamma, a.solver);
          }
        }
        const float other = __shfl_xor_sync(kFull, z, 1);
        if (act && br == 0) {
          const float y = z - other;     // mpabs(w + x) - mpabs(w - x)
          if (is_bp)
            hv[f * LB + p] = fmaxf(y, 0.f);
          else
            yrow[b * half + p] = y;
        }
      }
      __syncthreads();

      // adjacent-pair tree of each filter's LB values: groups of
      // G = min(32, LB) lanes by shuffles, then the group sums in order
      const int G = LB < 32 ? LB : 32;
      const int ngroups = LB / G;
      for (int base = warp * 32; base < F * LB; base += nthreads) {
        const int i = base + lane;
        float h = i < F * LB ? hv[i] : 0.f;
        for (int off = 1; off < G; off <<= 1)
          h = h + __shfl_down_sync(kFull, h, off, G);
        if (i < F * LB && (i & (G - 1)) == 0)
          seg[(i / LB) * kSeg + (i & (LB - 1)) / G] = h;
      }
      __syncthreads();
      if (tid < F) {
        float* g = seg + tid * kSeg;
        for (int w = ngroups; w > 1; w >>= 1)
          for (int j = 0; j < w / 2; ++j) g[j] = g[2 * j] + g[2 * j + 1];
        part[tid] = part[tid] + g[0];
      }

      // slide the delay line by this block's valid count; a slot with no
      // valid samples keeps its registers bit for bit
      const float d = tid < T1 ? buf[v + tid] : 0.f;
      __syncthreads();
      if (tid < T1) buf[tid] = d;
      __syncthreads();
    }

    for (int f = tid; f < F; f += nthreads) {
      const size_t c = (size_t)s * a.P + oc.col + f;
      a.acc_out[c] = a.acc[c] + part[f] * oc.scale;
    }
    for (int i = tid; i < T1; i += nthreads)
      oc.delay_out[(size_t)s * T1 + i] = buf[i];
    if (oc.consumed_out && tid == 0)   // int32 wraps, as torch's add
      oc.consumed_out[s] = static_cast<int>(
          static_cast<unsigned>(oc.phase_in[s]) + static_cast<unsigned>(nv));
    // the next octave: the kept signal, read back after the barrier
    src = yrow;
    nv = n_next;
    Lo = (Lo + 1) / 2;
    __syncthreads();
  }
  if (a.amax_out && tid == 0) a.amax_out[s] = am;
}

// Fields of one host table row, as int64 (kernels/fir_mp.py packs them).
enum { kDelayIn, kDelayOut, kPhaseIn, kConsumedOut, kBp, kLp, kF, kCol,
       kEmit, kOctFields };

template <int MB, int ML>
int launch(const Args& args, const Table& t, int S, int threads,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = fir_mp_stream_kernel<MB, ML>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<S, threads, smem_bytes, stream>>>(args, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float stream kernel for S slots over `num_octaves` table rows.
// x (S, L) f32, n (S,) int32, acc / acc_out (S, P) f32, amax (S,) f32,
// amax_out (S,) f32 or null, y (S, ystride) f32: the one-octave entry's
// y_next (ystride = NB * LB / 2) or the cascade's scratch row (ystride >=
// (L + 1) / 2). `octs` (num_octaves x kOctFields int64) and `scales`
// (num_octaves f32) are host memory, copied into the launch's parameters.
// `threads` and `smem_bytes` come from the launch plan; a plan that does
// not cover this kernel's need is refused. Returns 0, a cudaError_t code,
// or -1 for shapes outside what it takes (1 <= M <= 16, 1 <= M_lp <= 8,
// M - 1 <= T1, M_lp - 1 <= T1, T1 <= 31, 1 <= F <= 32, 1 <= num_octaves
// <= 8, threads a multiple of 32 in [32, 256], solver 0 or 1).
extern "C" int fir_mp_stream_launch(
    const void* x, const void* n, const void* acc, const void* amax,
    void* acc_out, void* amax_out, void* y, const int64_t* octs,
    const float* scales, int num_octaves, int S, int L, int P, int ystride,
    int M, int M_lp, int T1, float gamma, int solver, int update_amax,
    int cascade, int threads, int smem_bytes, void* stream) {
  if (S < 1 || L < 1 || num_octaves < 1 || num_octaves > kMaxOctaves ||
      M < 1 || M > kP || M_lp < 1 || M_lp > kLP || T1 > 31 || M - 1 > T1 ||
      M_lp - 1 > T1 || (solver != 0 && solver != 1) || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return -1;
  Table t = {};
  int F_max = 0, Lo = L;
  for (int o = 0; o < num_octaves; ++o) {
    const int64_t* r = octs + (size_t)o * kOctFields;
    Octave& oc = t.oct[o];
    oc.delay_in = reinterpret_cast<const float*>(r[kDelayIn]);
    oc.delay_out = reinterpret_cast<float*>(r[kDelayOut]);
    oc.phase_in = reinterpret_cast<const int*>(r[kPhaseIn]);
    oc.consumed_out = reinterpret_cast<int*>(r[kConsumedOut]);
    oc.bp = reinterpret_cast<const float*>(r[kBp]);
    oc.lp = reinterpret_cast<const float*>(r[kLp]);
    oc.F = static_cast<int>(r[kF]);
    oc.col = static_cast<int>(r[kCol]);
    oc.emit = static_cast<int>(r[kEmit]);
    oc.scale = scales[o];
    if (oc.F < 1 || oc.F > kMaxF || oc.col < 0 || oc.col + oc.F > P ||
        !oc.delay_in || !oc.delay_out || !oc.phase_in || !oc.bp ||
        (oc.emit && !oc.lp) || (cascade && !oc.consumed_out))
      return -1;
    // every octave but the last hands its kept signal on (cascade)
    if (cascade && (oc.emit != 0) != (o < num_octaves - 1)) return -1;
    F_max = oc.F > F_max ? oc.F : F_max;
    const int LB = block_len(Lo);
    if (!cascade && oc.emit && ystride != (Lo + LB - 1) / LB * (LB / 2))
      return -1;
    Lo = (Lo + 1) / 2;
  }
  if (cascade ? (num_octaves > 1 && ystride < (L + 1) / 2)
              : (num_octaves != 1))
    return -1;
  if ((t.oct[0].emit || (cascade && num_octaves > 1)) && !y) return -1;
  const long need = smem_words(L, F_max, M, T1) * (long)sizeof(float);
  if (smem_bytes < need || smem_bytes > 227 * 1024) return -1;
  Args args;
  args.x = static_cast<const float*>(x);
  args.n = static_cast<const int*>(n);
  args.acc = static_cast<const float*>(acc);
  args.amax = static_cast<const float*>(amax);
  args.acc_out = static_cast<float*>(acc_out);
  args.amax_out = static_cast<float*>(amax_out);
  args.y = static_cast<float*>(y);
  args.L = L;
  args.P = P;
  args.ystride = ystride;
  args.num_octaves = num_octaves;
  args.M = M;
  args.M_lp = M_lp;
  args.T1 = T1;
  args.F_max = F_max;
  args.solver = solver;
  args.update_amax = update_amax;
  args.cascade = cascade;
  args.gamma = gamma;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 16 && M_lp == 6)
    return launch<16, 6>(args, t, S, threads, smem_bytes, st);
  return launch<0, 0>(args, t, S, threads, smem_bytes, st);
}
