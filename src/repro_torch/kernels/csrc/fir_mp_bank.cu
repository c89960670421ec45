// The one-shot float MP FIR bank: the whole multirate cascade of one
// `apply` in one launch, and the one-stage bank and single-filter entries
// on the same device code.
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_bank_pallas (Pallas body
// _fir_mp_bank_kernel / _fir_mp_body) and fir_mp_pallas (_fir_mp_kernel),
// and the per-octave loop around them in src/repro/core/filterbank.py,
// multirate_accumulate. Plain PyTorch versions: repro_torch/kernels/ref.py,
// fir_mp_oneshot_cascade, fir_mp_bank(_accumulate), fir_mp(_accumulate).
//
// What it computes: for row b, filter f and position n of a signal x_o,
//   u_k = x_o[b, n - k] + h_f[k],  v_k = x_o[b, n - k] - h_f[k]   (k < M,
//   zero left fill), both bisected together for `iters` steps on
//   [max|.| - gamma, max|.|] with the constraint sum accumulated
//   sequentially over k, y = (lo_u + hi_u) / 2 - (lo_v + hi_v) / 2.
// Work comes in items of 256 outputs (ref.BANK_TILE), of three kinds:
//   * keep: octave o's low-pass at the kept positions 2j only, written
//     packed as the next octave's signal x_{o+1}[b, j], j < ceil(N_o / 2)
//     (the odd positions the reference solves and drops are not solved);
//   * band: one (row, filter, tile of 256 positions) of octave o's
//     band-pass; the tile's HWR values go through an adjacent-pair tree
//     (warp shuffles, then the same tree over the 8 warp sums) into its
//     partial, and the last tile of a (row, filter) to finish adds the
//     partials in ascending tile order and writes sum * 2^o into column
//     o F + f. Which CTA adds does not change the order: no float atomics;
//   * out: the one-stage output mode, y[b, f, n] at every position.
//
// What bounds it on an H100: operations. A (position, filter) costs about
// 5.3k f32 operations (26 bisection steps over 2 x 16 operands) against 4
// bytes of signal; 8 one-second clips at 16 kHz are ~6.7 G operations.
// So the design is about keeping every SM issuing:
//   * one persistent grid (occupancy x SMs CTAs of 256 threads) takes
//     items from a queue counter in the plan's order (kernels/fir_mp.py,
//     oneshot_plan). The deep octaves' small band-pass rounds (80 items
//     at octave 5) join one pool instead of running as a launch of their
//     own, and there is no launch, copy or host glue per octave;
//   * an item that reads x_o (o >= 1) waits, on its thread 0, until every
//     keep item that writes row b of x_o has released it (a per-row
//     counter). Items are taken in queue order and an item waits only for
//     items earlier in it, which CTAs that are running hold: no wait can
//     deadlock, whatever the occupancy, and no cooperative launch is
//     needed. The plan puts each low-pass stage where the CTAs that ran
//     the stage before it take their next items, band-pass items between,
//     so the low-pass chain runs beside the band-pass work without CTAs
//     waiting on it;
//   * u and v are formed once per window, not once per bisection step;
//     the configuration's windows (16 band-pass taps, 6 low-pass) unroll
//     at their exact width with no dead lane (a generic body takes
//     M <= 16 behind a guard per lane).
//
// Float contract (bit for bit the plain version): the reference's
// arithmetic in its order, built with -fmad=false; a position past N adds
// +0.0 to its tile's tree; each sum's partials add in ascending tile
// order; * 2^o is exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;          // outputs per item (ref.BANK_TILE)
constexpr int kP = 16;              // operand lanes of the generic body
constexpr int kPad = kP;            // shared words in front of a window
constexpr int kMaxOctaves = 8;
constexpr int kMaxSegments = 32;
constexpr unsigned kFull = 0xffffffffu;

enum { kKeep, kBand, kOut };        // item kinds (fir_mp.ONESHOT_KINDS)

// One octave of the cascade, from one int64 host table row (field order:
// kernels/fir_mp.py, ONESHOT_OCTAVE_FIELDS).
struct Octave {
  const float* src;        // x_o (B, n)
  const float* bp;         // (F, M) band-pass taps
  const float* fir;        // taps of this octave's keep or out items
  float* dst;              // keep: x_{o+1} (B, out_len); out: y (B, F, n)
  float* partial;          // (B, F, tiles) band partials
  unsigned* ready_in;      // (B,) keep items done on x_o's rows, or null
  unsigned* ready_out;     // (B,) ... on x_{o+1}'s rows
  unsigned* done;          // (B, F) band tiles done
  int n, tiles, fir_F, fir_tiles, out_len, stride, ready_target, col;
  float scale;             // 2^o
};

// queue items [start, start + count) are items [offset, offset + count)
// of one kind of one octave
struct Segment {
  int kind, octave, start, count, offset;
};

struct Table {
  Octave oct[kMaxOctaves];
  Segment seg[kMaxSegments];
  int num_segments;
};

// `reserved` is never read. It keeps every field at the offset the kernel
// is tested and timed with: each int pair 8-byte aligned, no tail
// padding. Without it nvcc built a generic instantiation that faulted
// (illegal address on every call) and a slower 16 / 6 one (PERF.md §6).
struct Args {
  float* out;              // (B, P) band sums
  unsigned* head;          // the queue counter
  int reserved;
  int items;               // queue items
  int F, P, M, M_fir, iters;
  float gamma;
};
static_assert(offsetof(Args, F) % 8 == 0 &&
                  sizeof(Args) == offsetof(Args, gamma) + sizeof(float),
              "Args: keep the tested layout (see above)");

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every thread of the CTA returns once *c >= target (no wait for null).
__device__ __forceinline__ void wait_ready(const unsigned* c,
                                           unsigned target) {
  if (c && threadIdx.x == 0)
    while (ld_acquire(c) < target) __nanosleep(64);
  __syncthreads();
}

// xt[kPad + i] = row[start + i] for i < count, zero outside [0, n). Read
// through L2: rows of x_{o+1} are written during the launch.
__device__ __forceinline__ void load_window(const float* row, int n,
                                            int start, int count,
                                            float* xt) {
  for (int i = threadIdx.x; i < count; i += kTile) {
    const int src = start + i;
    xt[kPad + i] = (src >= 0 && src < n) ? __ldcg(row + src) : 0.f;
  }
}

// The bisection of one window: xn[-k] = x[n - k] in shared memory, h the
// M taps. PM operand lanes; EXACT when M == PM, else lanes k >= M are off.
template <int PM, bool EXACT>
__device__ __forceinline__ float solve(const float* xn,
                                       const float* __restrict__ h, int M,
                                       float gamma, int iters) {
  float u[PM], v[PM];
  float hi_u = -INFINITY, hi_v = -INFINITY;
#pragma unroll
  for (int k = 0; k < PM; ++k) {
    const bool on = EXACT || k < M;
    const float xk = on ? xn[-k] : 0.f;
    const float hk = on ? __ldg(h + k) : 0.f;
    u[k] = xk + hk;
    v[k] = xk - hk;
    if (on) {
      hi_u = fmaxf(hi_u, fabsf(u[k]));
      hi_v = fmaxf(hi_v, fabsf(v[k]));
    }
  }
  float lo_u = hi_u - gamma, lo_v = hi_v - gamma;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float mid_u = (lo_u + hi_u) * 0.5f;
    const float mid_v = (lo_v + hi_v) * 0.5f;
    float hu = 0.f, hv = 0.f;
#pragma unroll
    for (int k = 0; k < PM; ++k) {
      if (EXACT || k < M) {
        hu = hu + fmaxf(u[k] - mid_u, 0.f) + fmaxf(-u[k] - mid_u, 0.f);
        hv = hv + fmaxf(v[k] - mid_v, 0.f) + fmaxf(-v[k] - mid_v, 0.f);
      }
    }
    const bool tu = hu > gamma, tv = hv > gamma;
    lo_u = tu ? mid_u : lo_u;
    hi_u = tu ? hi_u : mid_u;
    lo_v = tv ? mid_v : lo_v;
    hi_v = tv ? hi_v : mid_v;
  }
  return (lo_u + hi_u) * 0.5f - (lo_v + hi_v) * 0.5f;
}

// A keep or out item: 256 outputs j of one (row, filter), each the window
// ending at position j * stride of x_o.
template <int PM, bool EXACT>
__device__ void fir_item(const Octave& oc, const Args& a, int kind, int i,
                         float* xt) {
  const int t = threadIdx.x;
  const int Fw = oc.fir_F, per_row = oc.fir_tiles * Fw;
  const int b = i / per_row, r = i - b * per_row;
  const int tile = r / Fw, f = r - tile * Fw;
  const int M = EXACT ? PM : a.M_fir, s = oc.stride;
  wait_ready(oc.ready_in ? oc.ready_in + b : nullptr, oc.ready_target);
  const int j0 = tile * kTile;
  load_window(oc.src + (size_t)b * oc.n, oc.n, j0 * s - (M - 1),
              (kTile - 1) * s + M, xt);
  __syncthreads();
  const int j = j0 + t;
  if (j < oc.out_len)
    oc.dst[((size_t)b * Fw + f) * oc.out_len + j] = solve<PM, EXACT>(
        xt + kPad + M - 1 + t * s, oc.fir + f * M, M, a.gamma, a.iters);
  if (kind == kKeep) {
    __syncthreads();                      // every output of the item ...
    if (t == 0) {
      __threadfence();                    // ... ordered before the release
      atomicAdd(oc.ready_out + b, 1u);
    }
  }
}

// A band item: one tile of one (row, filter); the last of its tiles adds
// the (row, filter)'s partials.
template <int PM, bool EXACT>
__device__ void band_item(const Octave& oc, const Args& a, int i, float* xt,
                          float* wsum, int* last) {
  const int t = threadIdx.x;
  const int per_row = oc.tiles * a.F;
  const int b = i / per_row, r = i - b * per_row;
  const int tile = r / a.F, f = r - tile * a.F;
  const int M = EXACT ? PM : a.M;
  wait_ready(oc.ready_in ? oc.ready_in + b : nullptr, oc.ready_target);
  const int n0 = tile * kTile;
  load_window(oc.src + (size_t)b * oc.n, oc.n, n0 - (M - 1), kTile + M - 1,
              xt);
  __syncthreads();
  float h = 0.f;
  if (n0 + t < oc.n)
    h = fmaxf(solve<PM, EXACT>(xt + kPad + M - 1 + t, oc.bp + f * M, M,
                               a.gamma, a.iters),
              0.f);
  for (int off = 1; off < 32; off <<= 1)
    h = h + __shfl_down_sync(kFull, h, off);
  if ((t & 31) == 0) wsum[t >> 5] = h;
  __syncthreads();
  float* part = oc.partial + ((size_t)b * a.F + f) * oc.tiles;
  if (t == 0) {
    float w[kTile / 32];
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) w[k] = wsum[k];
#pragma unroll
    for (int width = kTile / 32; width > 1; width >>= 1) {
#pragma unroll
      for (int k = 0; k < width / 2; ++k) w[k] = w[2 * k] + w[2 * k + 1];
    }
    part[tile] = w[0];
    __threadfence();
    *last = atomicAdd(oc.done + b * a.F + f, 1u) == (unsigned)oc.tiles - 1;
    if (*last) __threadfence();
  }
  __syncthreads();
  if (!*last) return;
  // ascending tile order: all threads load, thread 0 adds
  float sum = 0.f;
  for (int c0 = 0; c0 < oc.tiles; c0 += kTile) {
    const int cn = min(kTile, oc.tiles - c0);
    if (t < cn) xt[t] = __ldcg(part + c0 + t);
    __syncthreads();
    if (t == 0)
      for (int k = 0; k < cn; ++k) sum = (c0 + k == 0) ? xt[0] : sum + xt[k];
    __syncthreads();
  }
  if (t == 0) a.out[(size_t)b * a.P + oc.col + f] = sum * oc.scale;
}

// MW, MB: the keep/out items' and the band items' tap counts, or 0 for the
// generic body (M <= 16 behind a guard).
template <int MW, int MB>
__global__ void __launch_bounds__(kTile, 4)
fir_mp_oneshot_kernel(const __grid_constant__ Table tab, const Args a) {
  constexpr int PW = MW ? MW : kP, PB = MB ? MB : kP;
  __shared__ float xt[kPad + 2 * kTile + kP];
  __shared__ float wsum[kTile / 32];
  __shared__ int item, last;
  for (;;) {
    if (threadIdx.x == 0) item = (int)atomicAdd(a.head, 1u);
    __syncthreads();
    const int q = item;
    if (q >= a.items) return;
    int s = 0;
    while (s + 1 < tab.num_segments && tab.seg[s + 1].start <= q) ++s;
    const Segment& sg = tab.seg[s];
    const Octave& oc = tab.oct[sg.octave];
    const int i = sg.offset + q - sg.start;
    if (sg.kind == kBand)
      band_item<PB, MB != 0>(oc, a, i, xt, wsum, &last);
    else
      fir_item<PW, MW != 0>(oc, a, sg.kind, i, xt);
    __syncthreads();   // xt, item and last are rewritten by the next item
  }
}

// Fields of one host table row, as int64 (kernels/fir_mp.py packs them).
enum { kSrc, kBp, kFir, kDst, kPartial, kReadyIn, kReadyOut, kDone, kN,
       kTiles, kFirF, kFirTiles, kOutLen, kStride, kReadyTarget, kCol,
       kScaleExp, kOctFields };

// CTAs the card holds at once for this instantiation (cached per device).
template <int MW, int MB>
int resident_ctas() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cache[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fir_mp_oneshot_kernel<MW, MB>, kTile, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

template <int MW, int MB>
int run(const Table& t, const Args& a, cudaStream_t stream) {
  const int ctas = resident_ctas<MW, MB>();
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = a.items < ctas ? a.items : ctas;
  fir_mp_oneshot_kernel<MW, MB><<<grid, kTile, 0, stream>>>(t, a);
  return static_cast<int>(cudaGetLastError());
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Runs a plan's queue in one launch. `octs` (num_octaves x kOctFields
// int64) and `segs` (num_segments x 5 int32: kind, octave, start, count,
// offset, in queue order; each kind of each octave covered once, in
// order) are host memory, copied into the launch's parameters. out (B, P)
// f32 takes the band sums; `counters` (uint32, zeroed) holds the queue
// head first, then the table's ready and done counters. Returns 0, a
// cudaError_t code, or -1 for a table this kernel does not take (1 <= M,
// M_fir <= 16; items sized as the plan sizes them; segments covering the
// queue in order; every item after the keep items it waits for, so that
// the launch cannot hang).
extern "C" int fir_mp_oneshot_launch(void* out, void* counters,
                                     const int64_t* octs, int num_octaves,
                                     const int32_t* segs, int num_segments,
                                     int B, int F, int P, int M, int M_fir,
                                     float gamma, int iters, void* stream) {
  if (B < 1 || F < 1 || M < 1 || M > kP || M_fir < 1 || M_fir > kP ||
      iters < 0 || num_octaves < 1 || num_octaves > kMaxOctaves ||
      num_segments < 1 || num_segments > kMaxSegments || !counters)
    return -1;
  Table t = {};
  t.num_segments = num_segments;
  for (int o = 0; o < num_octaves; ++o) {
    const int64_t* r = octs + (size_t)o * kOctFields;
    Octave& oc = t.oct[o];
    oc.src = reinterpret_cast<const float*>(r[kSrc]);
    oc.bp = reinterpret_cast<const float*>(r[kBp]);
    oc.fir = reinterpret_cast<const float*>(r[kFir]);
    oc.dst = reinterpret_cast<float*>(r[kDst]);
    oc.partial = reinterpret_cast<float*>(r[kPartial]);
    oc.ready_in = reinterpret_cast<unsigned*>(r[kReadyIn]);
    oc.ready_out = reinterpret_cast<unsigned*>(r[kReadyOut]);
    oc.done = reinterpret_cast<unsigned*>(r[kDone]);
    oc.n = static_cast<int>(r[kN]);
    oc.tiles = static_cast<int>(r[kTiles]);
    oc.fir_F = static_cast<int>(r[kFirF]);
    oc.fir_tiles = static_cast<int>(r[kFirTiles]);
    oc.out_len = static_cast<int>(r[kOutLen]);
    oc.stride = static_cast<int>(r[kStride]);
    oc.ready_target = static_cast<int>(r[kReadyTarget]);
    oc.col = static_cast<int>(r[kCol]);
    const int e = static_cast<int>(r[kScaleExp]);
    if (!oc.src || oc.n < 1 || e < 0 || e >= kMaxOctaves) return -1;
    oc.scale = ldexpf(1.f, e);
    // octave o >= 1 reads what octave o - 1's keep items write and waits
    // for all of them; octave 0 reads the input and waits for nothing
    if (o == 0 ? oc.ready_in != nullptr
               : (!oc.ready_in || oc.ready_in != t.oct[o - 1].ready_out ||
                  oc.src != t.oct[o - 1].dst ||
                  oc.n != t.oct[o - 1].out_len ||
                  oc.ready_target != t.oct[o - 1].fir_tiles))
      return -1;
  }
  bool has_band = false, has_fir = false;
  int next = 0, covered[3][kMaxOctaves] = {}, total[3][kMaxOctaves] = {};
  for (int s = 0; s < num_segments; ++s) {
    Segment& sg = t.seg[s];
    sg.kind = segs[5 * s];
    sg.octave = segs[5 * s + 1];
    sg.start = segs[5 * s + 2];
    sg.count = segs[5 * s + 3];
    sg.offset = segs[5 * s + 4];
    if (sg.kind < kKeep || sg.kind > kOut || sg.octave < 0 ||
        sg.octave >= num_octaves || sg.start != next || sg.count < 1 ||
        sg.offset != covered[sg.kind][sg.octave])
      return -1;
    // every keep item an item waits for comes before it in the queue
    if (sg.octave > 0 && covered[kKeep][sg.octave - 1] !=
                             B * t.oct[sg.octave - 1].fir_tiles)
      return -1;
    next += sg.count;
    covered[sg.kind][sg.octave] += sg.count;
    const Octave& oc = t.oct[sg.octave];
    if (sg.kind == kBand) {
      has_band = true;
      if (!oc.bp || !oc.partial || !oc.done || !out ||
          oc.tiles != ceil_div(oc.n, kTile) || oc.col < 0 || oc.col + F > P)
        return -1;
      total[kBand][sg.octave] = B * F * oc.tiles;
    } else {
      has_fir = true;
      const bool keep = sg.kind == kKeep;
      const int Fw = keep ? 1 : F;
      const int len = keep ? (oc.n + 1) / 2 : oc.n;
      if (!oc.fir || !oc.dst || (keep && !oc.ready_out) ||
          oc.fir_F != Fw || oc.stride != (keep ? 2 : 1) ||
          oc.out_len != len || oc.fir_tiles != ceil_div(len, kTile))
        return -1;
      total[sg.kind][sg.octave] = B * Fw * oc.fir_tiles;
    }
  }
  for (int k = 0; k < 3; ++k)
    for (int o = 0; o < num_octaves; ++o)
      if (covered[k][o] != total[k][o]) return -1;
  Args a = {};
  a.out = static_cast<float*>(out);
  a.head = static_cast<unsigned*>(counters);
  a.items = next;
  a.F = F;
  a.P = P;
  a.M = M;
  a.M_fir = M_fir;
  a.iters = iters;
  a.gamma = gamma;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((!has_band || M == 16) && (!has_fir || M_fir == 6))
    return run<6, 16>(t, a, st);
  return run<0, 0>(t, a, st);
}

// CTAs the card holds at once for the configuration's instantiation (16
// band-pass and 6 low-pass taps), or for the generic one: the grid a
// launch of at least that many items takes. 0 if the runtime says no.
extern "C" int fir_mp_oneshot_ctas(int generic) {
  return generic ? resident_ctas<0, 0>() : resident_ctas<6, 16>();
}
