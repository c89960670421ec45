// The MP product's kernel, its tile plan and its launch (mp_linear.cu),
// and the helpers the backward's grads pass shares (mp_linear_bwd.cu).
// What it computes and why it is laid out so: the head of mp_linear.cu.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory per CTA for two CTAs on an SM, and for one (with
// the static buffers and the 1 KB per CTA the system keeps, within the
// SM's 228 KB).
constexpr int kTileBytes = 110 * 1024;
constexpr int kTileBytesOne = 220 * 1024;

// N 32-bit words, loaded from shared memory as one (N <= 4) or two vectors
template <int N>
struct alignas(N >= 4 ? 16 : 4 * N) Words {
  uint32_t v[N];
};

struct Plan {
  int BB, TO;       // batch rows, columns
  int dl;           // positions per CTA (resident: padded to kThreads)
  long long ctas;
  int res;          // 1: tiles in shared memory; 0: read every pass
};

// TO columns of one position, widened to f32 (bf16: the bits << 16, exact)
template <typename WT, int TO>
__device__ __forceinline__ void widen(const Words<TO * sizeof(WT) / 4>& q,
                                      float (&wv)[TO]) {
  if constexpr (sizeof(WT) == 4) {
#pragma unroll
    for (int o = 0; o < TO; ++o) wv[o] = __uint_as_float(q.v[o]);
  } else {
#pragma unroll
    for (int j = 0; j < TO / 2; ++j) {
      wv[2 * j] = __uint_as_float(q.v[j] << 16);
      wv[2 * j + 1] = __uint_as_float(q.v[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Transposed reduction of a[0..NV) over the warp. Each halving level keeps
// half of the H values a lane holds and adds the partner lane's copy of
// them (the partner sends the other half); the levels recurse at compile
// time, so every index is a constant and a[] stays in registers. After
// log2 NV levels butterflies finish: lane l returns the total of element
// l >> (5 - log2 NV).
template <int NV, int H, typename Op>
__device__ __forceinline__ void halve(float (&a)[NV], int lane, Op op) {
  if constexpr (H > 1) {
    constexpr int half = H / 2, off = half * 32 / NV;
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float keep = up ? a[j + half] : a[j];
      const float send = up ? a[j] : a[j + half];
      a[j] = op(keep, __shfl_xor_sync(kFull, send, off));
    }
    halve<NV, half>(a, lane, op);
  }
}

template <int NV, typename Op>
__device__ __forceinline__ float warp_transpose_reduce(float (&a)[NV],
                                                       int lane, Op op) {
  halve<NV, NV>(a, lane, op);
  float v = a[0];
#pragma unroll
  for (int off = 16 / NV; off > 0; off >>= 1)
    v = op(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Position i's x values (BB rows) and w values (TO columns), widened to
// f32: from the shared tiles (RES) or from device memory.
template <typename WT, int BB, int TO, bool RES>
__device__ __forceinline__ void load_position(
    const float* __restrict__ x, const WT* __restrict__ w, const float* xt,
    const WT* wt, int i, int dl, int b0, int o0, int B, int d, int O,
    float (&xv)[BB], float (&wv)[TO]) {
  if constexpr (RES) {
#pragma unroll
    for (int b = 0; b < BB; ++b) xv[b] = xt[b * dl + i];
    constexpr int WW = TO * static_cast<int>(sizeof(WT)) / 4;
    widen<WT, TO>(reinterpret_cast<const Words<WW>*>(wt)[i], wv);
  } else {
#pragma unroll
    for (int b = 0; b < BB; ++b)
      xv[b] = __ldg(x + (size_t)min(b0 + b, B - 1) * d + i);
#pragma unroll
    for (int o = 0; o < TO; ++o)
      wv[o] = widen1(__ldg(w + (size_t)i * O + min(o0 + o, O - 1)));
  }
}

// One step's exchange: the warp's NV sums reduced (lane k << spread holds
// sum k) into red[p][warp], the step's one barrier, then lane k < NV of
// every warp adds the warp sums of element k in one order, warp by warp.
template <int NV, typename Op>
__device__ __forceinline__ float exchange(float (&acc)[NV], float* red, int p,
                                          Op op) {
  constexpr int SPREAD = 5 - (NV == 4 ? 2 : NV == 8 ? 3 : NV == 16 ? 4 : 5);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float v = warp_transpose_reduce<NV>(acc, lane, op);
  if ((lane & ((1 << SPREAD) - 1)) == 0)
    red[(p * kWarps + warp) * NV + (lane >> SPREAD)] = v;
  __syncthreads();
  float s = 0.f;
  if (lane < NV) {
    const float* r = red + p * kWarps * NV + lane;
    s = r[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s = op(s, r[q * NV]);
  }
  return s;
}

// The threshold tau of a level z on |t|: of an operand pair (t, -t),
// exactly one member (the one of t's sign) is above z where |t| > tau, and
// elsewhere none (z >= 0) or both (z < 0). For z >= 0, tau = z; for z < 0
// one member is above z where |t| >= -z, which for floats is |t| > the
// float below -z.
__device__ __forceinline__ float threshold(float z) {
  return z >= 0.f ? z : __int_as_float(__float_as_int(-z) - 1);
}

// Per thread, over its positions i < d: for each pair k with threshold
// tk[k], the count (COUNT, into cnt) of t in [t; -t] with |t| > tk[k] and
// (SUM, into sum) their |t|, t = u or v. That sum is the sum of the
// operands of [t; -t] above the level, in the same order: a pair with
// both members above it adds t + (-t) = 0 exactly. The count of operands
// above it is cnt for z >= 0 and 2 d - cnt for z < 0 (above_count).
// Padded positions (>= d) are left out.
template <typename WT, int BB, int TO, bool RES, bool COUNT, bool SUM>
__device__ __forceinline__ void tally_above(
    const float* __restrict__ x, const WT* __restrict__ w, const float* xt,
    const WT* wt, int dl, int b0, int o0, int B, int d, int O,
    const float (&tk)[2 * BB * TO], float (&cnt)[2 * BB * TO],
    float (&sum)[2 * BB * TO]) {
#pragma unroll
  for (int k = 0; k < 2 * BB * TO; ++k) {
    if constexpr (COUNT) cnt[k] = 0.f;
    if constexpr (SUM) sum[k] = 0.f;
  }
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float xv[BB], wv[TO];
    load_position<WT, BB, TO, RES>(x, w, xt, wt, i, dl, b0, o0, B, d, O, xv,
                                   wv);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
#pragma unroll
      for (int o = 0; o < TO; ++o) {
        const int ku = b * TO + o, kv = (BB + b) * TO + o;
        const float au = fabsf(xv[b] + wv[o]), av = fabsf(xv[b] - wv[o]);
        if (au > tk[ku]) {
          if constexpr (SUM) sum[ku] += au;
          if constexpr (COUNT) cnt[ku] += 1.f;
        }
        if (av > tk[kv]) {
          if constexpr (SUM) sum[kv] += av;
          if constexpr (COUNT) cnt[kv] += 1.f;
        }
      }
    }
  }
}

// #{operands of [t; -t] above z} from tally_above's count over d positions
__device__ __forceinline__ float above_count(float z, float cnt,
                                             float two_d) {
  return z >= 0.f ? cnt : two_d - cnt;
}

// Rounds of the exact solve after the bisection (LEVELS). Each round from
// the left of the root passes at least one distinct operand value, and 26
// bisection steps leave the bracket within gamma / 2^26 of the root, so
// one round is the rule; a level within an ulp of an operand can swap two
// supports until the cap.
constexpr int kExactRounds = 16;

// BB batch rows x TO output columns over all of d. RES: w and x tiles
// resident in shared memory ([dl][TO] w in WT, [BB][dl] x in f32);
// otherwise read from device memory every pass. LEVELS (the forward of a
// training step): after y, which it stores as the forward alone does, the
// exact water levels of both branches for the backward, solved from the
// bracket the steps leave, with the tiles still resident,
// lv[b, o] = {z_u, z_v, 1 / k_u, 1 / k_v}.
template <typename WT, int BB, int TO, bool RES, bool LEVELS>
__global__ void __launch_bounds__(kThreads, 2)
    mp_linear_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                     float* __restrict__ y, int B, int d, int dl, int O,
                     float gamma, int iters, float4* __restrict__ lv) {
  // accumulator k = (s * BB + b) * TO + o; s = 0: u = x + w, s = 1: x - w
  constexpr int NV = 2 * BB * TO;
  static_assert(NV <= 32 && TO * sizeof(WT) >= 4, "tile too wide or narrow");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kWarps][NV];   // warp sums, by the step's parity
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = static_cast<int>(blockIdx.x) * TO;
  const int b0 = blockIdx.y * BB;

  WT* wt = reinterpret_cast<WT*>(smem);
  float* xt = reinterpret_cast<float*>(smem + (size_t)dl * TO * sizeof(WT));
  if constexpr (RES) {
    // Asynchronous copies (cp.async, zero-filled past d) where the tile's
    // rows are whole and aligned: w one vector per position (TO columns of
    // WT, WW words), x four positions per copy; all in flight at once.
    constexpr int WW = TO * static_cast<int>(sizeof(WT)) / 4;
    constexpr int CH = WW * 4 > 16 ? 16 : WW * 4;   // bytes per copy
    if (o0 + TO <= O && (O * sizeof(WT)) % CH == 0 &&
        reinterpret_cast<uintptr_t>(w) % CH == 0) {
      for (int i = tid; i < dl; i += kThreads) {
        const bool in = i < d;
        const char* src = reinterpret_cast<const char*>(
            w + (size_t)(in ? i : 0) * O + o0);
        char* dst = reinterpret_cast<char*>(wt) + (size_t)i * WW * 4;
#pragma unroll
        for (int c = 0; c < WW * 4 / CH; ++c)
          __pipeline_memcpy_async(dst + c * CH, src + c * CH, CH,
                                  in ? 0 : CH);
      }
    } else {
      for (int e = tid; e < dl * TO; e += kThreads) {
        const int dd = e / TO, c = min(o0 + e % TO, O - 1);
        wt[e] = dd < d ? w[(size_t)dd * O + c] : WT(0);
      }
    }
    const bool x4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float* xr = x + (size_t)min(b0 + b, B - 1) * d;
      float* xs = xt + (size_t)b * dl;
      if (x4) {
        for (int i = 4 * tid; i < dl; i += 4 * kThreads) {
          const bool in = i < d;
          __pipeline_memcpy_async(xs + i, xr + (in ? i : 0), 16, in ? 0 : 16);
        }
      } else {
        for (int i = tid; i < dl; i += kThreads)
          xs[i] = i < d ? xr[i] : 0.f;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  const int n_pos = RES ? dl : d;   // resident: the same count per thread

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  // hi = max_i |u_i| and max_i |v_i|
#pragma unroll 2
  for (int i = tid; i < n_pos; i += kThreads) {
    float xv[BB], wv[TO];
    load_position<WT, BB, TO, RES>(x, w, xt, wt, i, dl, b0, o0, B, d, O, xv,
                                   wv);
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
  // lane k < NV holds bracket k
  float hi = exchange<NV>(acc, &red[0][0][0], 0, Max());
  float lo = hi - gamma;
  const float two_d = 2.0f * static_cast<float>(d);

  for (int it = 0; it < iters; ++it) {
    const float mid = (lo + hi) * 0.5f, amid = fabsf(mid);
    float am[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      am[k] = __shfl_sync(kFull, amid, k);
      acc[k] = 0.f;
    }
#pragma unroll(TO <= 4 ? 4 : 2)
    for (int i = tid; i < n_pos; i += kThreads) {
      float xv[BB], wv[TO];
      load_position<WT, BB, TO, RES>(x, w, xt, wt, i, dl, b0, o0, B, d, O,
                                     xv, wv);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
#pragma unroll
        for (int o = 0; o < TO; ++o) {
          const int ku = b * TO + o, kv = (BB + b) * TO + o;
          acc[ku] += fmaxf(fabsf(xv[b] + wv[o]) - am[ku], 0.f);
          acc[kv] += fmaxf(fabsf(xv[b] - wv[o]) - am[kv], 0.f);
        }
      }
    }
    float h = exchange<NV>(acc, &red[0][0][0], (it + 1) & 1, Add());
    if (mid < 0.f) h += two_d * amid;
    if (h > gamma) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  if (warp == 0) {
    const float z = (lo + hi) * 0.5f;
    const float zv = __shfl_sync(kFull, z, (lane + BB * TO) & 31);
    if (lane < BB * TO) {
      const int b = lane / TO, o = lane % TO;
      if (b0 + b < B && o0 + o < O)
        y[(size_t)(b0 + b) * O + o0 + o] = z - zv;
    }
  }
  if constexpr (LEVELS) {
    // The exact level of each pair, as the sort-based closed form defines
    // it: z = (sum of the n operands above z - gamma) / n. From zc = lo
    // (left of the root), n = #{L > zc} and their sum s, in one pass, give
    // z = (s - gamma) / n; when #{L > z} is n again, z is that support's
    // level, else z becomes zc with its count and the sum is taken there
    // (monotone Newton from the left). Both tallies compare |t| with one
    // threshold per level (tally_above). Every reduction is uniform over
    // the CTA, so the vote is too.
    float tk[NV], cnt[NV];
    int p = iters + 1;   // the exchanges' parity runs on from the steps
#pragma unroll
    for (int k = 0; k < NV; ++k) tk[k] = __shfl_sync(kFull, threshold(lo), k);
    tally_above<WT, BB, TO, RES, true, true>(x, w, xt, wt, dl, b0, o0, B, d,
                                             O, tk, cnt, acc);
    float s = exchange<NV>(acc, &red[0][0][0], (p++) & 1, Add());
    float n = above_count(
        lo, exchange<NV>(cnt, &red[0][0][0], (p++) & 1, Add()), two_d);
    float z, kk;
    for (int r = 1;; ++r) {
      z = (s - gamma) / fmaxf(n, 1.f);
      kk = n;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        tk[k] = __shfl_sync(kFull, threshold(z), k);
      tally_above<WT, BB, TO, RES, true, false>(x, w, xt, wt, dl, b0, o0, B,
                                                d, O, tk, cnt, acc);
      const float n2 = above_count(
          z, exchange<NV>(cnt, &red[0][0][0], (p++) & 1, Add()), two_d);
      if (!__syncthreads_or(lane < NV && n2 != n) || r == kExactRounds)
        break;
      n = n2;
      tally_above<WT, BB, TO, RES, false, true>(x, w, xt, wt, dl, b0, o0, B,
                                                d, O, tk, cnt, acc);
      s = exchange<NV>(acc, &red[0][0][0], (p++) & 1, Add());
    }
    if (warp == 0) {
      const int src = (lane + BB * TO) & 31;
      const float zv = __shfl_sync(kFull, z, src);
      const float kv = __shfl_sync(kFull, kk, src);
      if (lane < BB * TO) {
        const int b = lane / TO, o = lane % TO;
        if (b0 + b < B && o0 + o < O)
          lv[(size_t)(b0 + b) * O + o0 + o] =
              make_float4(z, zv, 1.f / fmaxf(kk, 1.f), 1.f / fmaxf(kv, 1.f));
      }
    }
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tile for (B, d, O): BB from B; then tiles of which two fit an SM and
// then tiles of which one does, at column widths 8, 4, 2 in that order,
// the first whose shared tiles fit and that gives every SM a CTA (to
// within 1/32). If none does, the fitting tile with the most CTAs; if none
// fits, the non-resident kernel. Wide tiles first: a CTA's staging, max
// pass and 27 barriers cost about the same whatever TO is, and per
// (b, o, i) the wider tile issues fewer loads. PERF.md has each width's
// time at the decode shapes (chip_smoke.py's tile sweep), the narrower,
// whole-wave tiles of k/v and down included. to != 0 asks for a resident
// tile TO = to instead (none, BB = 0, where it does not fit).
Plan plan_for(int B, int d, int O, int wbytes, int to_asked) {
  const int BB = B == 1 ? 1 : B == 2 ? 2 : 4;
  const long long nb = ceil_div(B, BB);
  const long long want = (sm_count() * 31LL + 31) / 32;
  const int dl = ceil_div(d, kThreads) * kThreads;
  Plan best{BB, 0, 0, 0, 0};
  for (const int budget : {kTileBytes, kTileBytesOne}) {
    for (int to = 8; to >= 2; to /= 2) {
      if (2 * BB * to > 32 || (to_asked && to != to_asked)) continue;
      if ((long long)dl * (to * wbytes + BB * 4) > budget) continue;
      const Plan c{BB, to, dl, ceil_div(O, to) * nb, 1};
      if (to_asked || c.ctas >= want) return c;
      if (c.ctas > best.ctas) best = c;
    }
  }
  if (to_asked) return Plan{0, 0, 0, 0, 0};
  if (best.ctas > 0) return best;
  const int to = BB == 4 ? 4 : 8;
  return Plan{BB, to, d, ceil_div(O, to) * nb, 0};
}

// Launches the plan's kernel or, with per_sm, writes how many of its CTAs
// an SM holds at once instead.
template <bool LEVELS, typename WT, int BB, int TO, bool RES>
int launch(const Plan& p, const float* x, const WT* w, float* y, int B,
           int d, int O, float gamma, int iters, cudaStream_t stream,
           int* per_sm, float4* lv) {
  auto kern = mp_linear_kernel<WT, BB, TO, RES, LEVELS>;
  size_t smem = 0;
  if constexpr (RES) {
    smem = (size_t)p.dl * (TO * sizeof(WT) + BB * sizeof(float));
    static const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytesOne);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  if (per_sm)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kern, kThreads, smem));
  const dim3 grid(static_cast<unsigned>(ceil_div(O, TO)),
                  static_cast<unsigned>(ceil_div(B, BB)));
  kern<<<grid, kThreads, smem, stream>>>(x, w, y, B, d, p.dl, O, gamma,
                                         iters, lv);
  return static_cast<int>(cudaGetLastError());
}

#define MP_LINEAR_ARGS \
  p, x, w, y, B, d, O, gamma, iters, stream, per_sm, lv

template <bool LEVELS, typename WT, int BB>
int by_tile(const Plan& p, const float* x, const WT* w, float* y, int B,
            int d, int O, float gamma, int iters, cudaStream_t stream,
            int* per_sm, float4* lv) {
  if (!p.res)
    return launch<LEVELS, WT, BB, (BB == 4 ? 4 : 8), false>(MP_LINEAR_ARGS);
  switch (p.TO) {
    case 8:
      if constexpr (BB <= 2)
        return launch<LEVELS, WT, BB, 8, true>(MP_LINEAR_ARGS);
      break;
    case 4: return launch<LEVELS, WT, BB, 4, true>(MP_LINEAR_ARGS);
    case 2: return launch<LEVELS, WT, BB, 2, true>(MP_LINEAR_ARGS);
  }
  return -1;
}

template <bool LEVELS, typename WT>
int by_batch(const Plan& p, const float* x, const WT* w, float* y, int B,
             int d, int O, float gamma, int iters, cudaStream_t stream,
             int* per_sm, float4* lv) {
  switch (p.BB) {
    case 1: return by_tile<LEVELS, WT, 1>(MP_LINEAR_ARGS);
    case 2: return by_tile<LEVELS, WT, 2>(MP_LINEAR_ARGS);
    case 4: return by_tile<LEVELS, WT, 4>(MP_LINEAR_ARGS);
  }
  return -1;
}

#undef MP_LINEAR_ARGS

bool takes(int B, int d, int O, int w_bf16, int to, int iters) {
  return B >= 1 && d >= 1 && O >= 1 && iters >= 0 && (w_bf16 == 0 ||
         w_bf16 == 1) && (to == 0 || to == 2 || to == 4 || to == 8) &&
         ceil_div(B, 4) <= 65535 && d <= (1 << 22);
}

template <bool LEVELS>
int dispatch(const Plan& p, const void* x, const void* w, void* y, int B,
             int d, int O, int w_bf16, float gamma, int iters, void* stream,
             int* per_sm, float4* lv = nullptr) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return by_batch<LEVELS, uint16_t>(p, xf, static_cast<const uint16_t*>(w),
                                      yf, B, d, O, gamma, iters, s, per_sm,
                                      lv);
  return by_batch<LEVELS, float>(p, xf, static_cast<const float*>(w), yf, B,
                                 d, O, gamma, iters, s, per_sm, lv);
}

}  // namespace
