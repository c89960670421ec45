// The one-shot integer MP FIR bank: the whole multirate cascade of one
// fixed-point `apply` in one launch, and the one-stage bank (both modes)
// on the same device code. The fixed-point twin of fir_mp_bank.cu, on
// int32 codes (the hardware twin) or on integer codes carried in float32
// (the fake-quant twin): each body has an instance per carrier.
//
// Replaces: src/repro/kernels/fir_mp.py, fir_mp_bank_q_pallas (Pallas body
// _fir_mp_bank_q_kernel / _fxp_fir_mp_body / _fxp_mpabs_ops), and the
// per-octave loop around it in src/repro/core/fixed.py, bank_accumulate_q.
// Plain PyTorch versions: repro_torch/kernels/ref.py,
// fir_mp_oneshot_cascade_q and fir_mp_bank_q(_accumulate).
//
// What it computes, octave o by its compiled stage (core/fixed.py
// OctaveStage, one record of the device stage table that
// kernels/fir_mp.py pack_stages packs; x_0 the ADC codes): for row b and
// an output at position p of x_o, the window x_o[p - M + 1 .. p] (zero
// left fill) rescaled by the stage's shift, operands clamp(w_k + x_k)
// and clamp(w_k - x_k) with the reversed taps w, and y = mpabs(u) -
// mpabs(v), each by `iters` steps of integer bisection. Work comes in
// items of 256 outputs, of three kinds:
//   * keep: octave o's low-pass (lp_sig_shift, lp spec, gamma_lp /
//     iters_lp) at the kept positions p = 2j only, written as
//     clamp(rescale(y, lp_out_shift), next_qmin, next_qmax) = x_{o+1}[b,
//     j], j < ceil(N_o / 2). The reference solves every position and
//     drops the odd ones; they are not solved here;
//   * band: one (row, filter, tile of 256 positions) of octave o's
//     band-pass (sig_shift, band spec, gamma_bp / iters_bp). On int32 the
//     tile's max(y, 0) add up in unsigned arithmetic (wrapping like the
//     reference's int32 sum) and one atomicAdd lands shl(tile sum,
//     acc_shift) in column col_o + f of the zeroed accumulators. A left
//     shift distributes over wrapping sums and integer addition is
//     associative, so the total is the reference's shift_left(sum,
//     acc_shift) bit for bit, in any order: no ordered partials, no
//     "done" counters. On the float carrier a sum that passes 2**24
//     rounds, and then its order decides its bits: the tile sums in a
//     fixed order (a butterfly per warp, the 8 warps in turn) into a
//     partial per tile, and the item that completes a (row, filter) (a
//     done counter per accumulator column) adds its tiles in ascending
//     order and writes shl(total, acc_shift). Every run gives the same
//     bits; below 2**24 they are the int32 carrier's codes;
//   * out: the one-stage output mode, y[b, f, p] at every position, with
//     the band constants.
//
// What bounds it on an H100: integer instructions. A (position, filter)
// costs ~900 issued int32 instructions (12 bisection steps of both
// branches over 16 lanes) against 4 bytes of codes. So, as in
// fir_mp_bank.cu, the design keeps every SM issuing:
//   * one persistent grid (occupancy x SMs CTAs of 256 threads) takes
//     items from a queue counter in the plan's order (kernels/fir_mp.py,
//     oneshot_plan(integer=True)): each low-pass stage where the CTAs
//     that ran the stage before it take their next items, band-pass
//     items between, then every band item left, pooled across octaves.
//     No launch, copy or host glue per octave;
//   * an item that reads x_o (o >= 1) waits, on its thread 0, until every
//     keep item that writes row b of x_o has released it (a per-row
//     counter). Items wait only on items earlier in the queue, which
//     running CTAs hold: no wait can deadlock, whatever the occupancy;
//   * the step is the cheapest exact form (fxp::mp_dot_q_mag: one max
//     per lane on the operands' magnitudes, their sum against m * mid),
//     u's and v's chains interleaved; the window's codes are rescaled
//     once as they are staged in shared memory, and the configuration's
//     widths (16 band-pass taps, 6 low-pass) unroll exactly (a generic
//     body takes M <= 16, M_lp <= 8 behind a guard per lane).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "fixed_point.cuh"

namespace {

constexpr int kTile = 256;          // outputs per item (ref.BANK_TILE)
constexpr int kP = 16;              // band-pass lanes (M <= 16)
constexpr int kLP = 8;              // low-pass lanes (M_lp <= 8)
constexpr int kMaxOctaves = 8;
constexpr int kMaxSegments = 32;
constexpr int kHead = 32;           // stage header words
constexpr int kMaxBP = 512;         // F * M band-pass codes
constexpr int kStageWords = kHead + kMaxBP + kLP;

enum { kKeep, kBand, kOut };        // item kinds (fir_mp.ONESHOT_KINDS)

// The stage header, in the order kernels/fir_mp.py (STAGE_FIELDS) packs
// it; then F x M band-pass codes at kHead (rows reversed) and M_lp
// low-pass codes at kHead + kMaxBP (reversed). T1 is not read here.
enum { hF, hM, hM_lp, hT1, hSigShift, hLpSigShift, hLpOutShift, hAccShift,
       hGammaBp, hItersBp, hGammaLp, hItersLp, hBandQmin, hBandQmax,
       hLpQmin, hLpQmax, hNextQmin, hNextQmax, hEmit, kHeadFields };
static_assert(kHeadFields <= kHead, "the stage header must fit kHead");

// One octave of the cascade, from one int64 host table row (field order:
// kernels/fir_mp.py, ONESHOT_Q_OCTAVE_FIELDS); codes on the carrier.
struct Octave {
  const void* src;         // x_o (B, n) codes
  void* dst;               // keep: x_{o+1} (B, out_len); out: y (B, F, n)
  unsigned* ready_in;      // (B,) keep items done on x_o's rows, or null
  unsigned* ready_out;     // (B,) ... on x_{o+1}'s rows
  float* partial;          // float carrier: (B, F, tiles) tile sums
  int n, tiles, fir_F, fir_tiles, out_len, stride, ready_target, col;
};

// queue items [start, start + count) are items [offset, offset + count)
// of one kind of one octave
struct Segment {
  int kind, octave, start, count, offset;
};

struct Table {
  Octave oct[kMaxOctaves];
  Segment seg[kMaxSegments];
};

// Pointers first, then an even number of ints: no padding anywhere, a
// layout held by the assert (fir_mp_bank.cu's Args moved its speed and
// its correctness with its field offsets, PERF.md §6).
struct Args {
  void* out;               // (B, P) accumulators: int32 zeroed, or float
  unsigned* head;          // the queue counter, zeroed
  const int* stages;       // (octaves, kStageWords) stage table
  unsigned* done;          // float carrier: (B, P) tiles done, zeroed
  int items, num_segments, F, P, M, M_lp;
};
static_assert(offsetof(Args, items) == 4 * sizeof(void*) &&
                  offsetof(Args, F) % 8 == 0 &&
                  sizeof(Args) == offsetof(Args, M_lp) + sizeof(int),
              "Args: pointers, then ints, no padding");

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

// xt[i] = rescale(row[start + i], shift) for i < count, zero outside
// [0, n). Read through L2: rows of x_{o+1} are written during the launch.
template <typename T>
__device__ __forceinline__ void load_window(const T* row, int n, int start,
                                            int count, int shift, T* xt) {
  for (int i = threadIdx.x; i < count; i += kTile) {
    const int src = start + i;
    xt[i] = (src >= 0 && src < n) ? fxp::rescale(__ldcg(row + src), shift)
                                  : T(0);
  }
}

// mpabs(clamp(w + x)) - mpabs(clamp(w - x)) over the window xs (rescaled
// codes, oldest first) and the reversed taps ws (int32 codes, read onto
// the carrier as the reference casts H_q): P operand lanes, MC the tap
// count at compile time (0: the runtime M, lanes k >= M off). The clamp
// bounds hold qmin > INT_MIN and qmax >= 0 (fxp::clamp_mag).
template <int P, int MC, typename T>
__device__ __forceinline__ T solve(const T* xs, const int* __restrict__ ws,
                                   int M, int qmin, int qmax, int gamma,
                                   int iters) {
  const int m = MC ? MC : M;
  const T lo = static_cast<T>(qmin), hi = static_cast<T>(qmax);
  T au[P], av[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const T x = k < m ? xs[k] : T(0);
    const T w = k < m ? static_cast<T>(__ldg(ws + k)) : T(0);
    au[k] = fxp::clamp_mag(fxp::wadd(w, x), lo, hi);
    av[k] = fxp::clamp_mag(fxp::wsub(w, x), lo, hi);
  }
  return fxp::mp_dot_q_mag<P, MC>(au, av, M, gamma, iters);
}

// A keep or out item: 256 outputs j of one (row, filter), each the window
// ending at position j * stride of x_o.
template <typename T, int P, int MC, bool KEEP>
__device__ void fir_item(const Octave& oc, const Args& a, const int* rec,
                         int i, T* xt) {
  const int t = threadIdx.x;
  const int Fw = oc.fir_F, per_row = oc.fir_tiles * Fw;
  const int b = i / per_row, r = i - b * per_row;
  const int tile = r / Fw, f = r - tile * Fw;
  const int M = MC ? MC : (KEEP ? a.M_lp : a.M), s = oc.stride;
  wait_ready(oc.ready_in ? oc.ready_in + b : nullptr, oc.ready_target);
  const int j0 = tile * kTile;
  load_window(static_cast<const T*>(oc.src) + (size_t)b * oc.n, oc.n,
              j0 * s - (M - 1), (kTile - 1) * s + M,
              __ldg(rec + (KEEP ? hLpSigShift : hSigShift)), xt);
  __syncthreads();
  const int j = j0 + t;
  if (j < oc.out_len) {
    const T y = KEEP
        ? solve<P, MC>(xt + t * s, rec + kHead + kMaxBP, M,
                       __ldg(rec + hLpQmin), __ldg(rec + hLpQmax),
                       __ldg(rec + hGammaLp), __ldg(rec + hItersLp))
        : solve<P, MC>(xt + t * s, rec + kHead + f * M, M,
                       __ldg(rec + hBandQmin), __ldg(rec + hBandQmax),
                       __ldg(rec + hGammaBp), __ldg(rec + hItersBp));
    static_cast<T*>(oc.dst)[((size_t)b * Fw + f) * oc.out_len + j] =
        KEEP ? fxp::clamp(fxp::rescale(y, __ldg(rec + hLpOutShift)),
                          static_cast<T>(__ldg(rec + hNextQmin)),
                          static_cast<T>(__ldg(rec + hNextQmax)))
             : y;
  }
  if (KEEP) {
    __syncthreads();                      // every output of the item ...
    if (t == 0) {
      __threadfence();                    // ... ordered before the release
      atomicAdd(oc.ready_out + b, 1u);
    }
  }
}

// A band item: one tile of one (row, filter), its HWR sum added into the
// accumulators: int32 by an atomicAdd, in any order; float through the
// tile partials in ascending order (the header's "band").
template <typename T, int P, int MC>
__device__ void band_item(const Octave& oc, const Args& a, const int* rec,
                          int i, T* xt, typename fxp::SumOf<T>::type* wsum) {
  using S_t = typename fxp::SumOf<T>::type;
  const int t = threadIdx.x;
  const int per_row = oc.tiles * a.F;
  const int b = i / per_row, r = i - b * per_row;
  const int tile = r / a.F, f = r - tile * a.F;
  const int M = MC ? MC : a.M;
  wait_ready(oc.ready_in ? oc.ready_in + b : nullptr, oc.ready_target);
  const int n0 = tile * kTile;
  load_window(static_cast<const T*>(oc.src) + (size_t)b * oc.n, oc.n,
              n0 - (M - 1), kTile + M - 1, __ldg(rec + hSigShift), xt);
  __syncthreads();
  S_t h = S_t(0);
  if (n0 + t < oc.n)
    h = fxp::hwr_term(solve<P, MC>(
        xt + t, rec + kHead + f * M, M, __ldg(rec + hBandQmin),
        __ldg(rec + hBandQmax), __ldg(rec + hGammaBp),
        __ldg(rec + hItersBp)));
  h = fxp::warp_sum(h);
  if ((t & 31) == 0) wsum[t >> 5] = h;
  __syncthreads();
  if (t != 0) return;
  S_t sum = wsum[0];
#pragma unroll
  for (int k = 1; k < kTile / 32; ++k) sum += wsum[k];
  const size_t c = (size_t)b * a.P + oc.col + f;
  const int shift = __ldg(rec + hAccShift);
  if constexpr (std::is_same<T, int>::value) {
    atomicAdd(static_cast<unsigned*>(a.out) + c,
              static_cast<unsigned>(fxp::shl(static_cast<int>(sum), shift)));
  } else {
    float* part = oc.partial + ((size_t)b * a.F + f) * oc.tiles;
    __stcg(part + tile, sum);
    __threadfence();                      // the partial before the count
    if (atomicAdd(a.done + c, 1u) == static_cast<unsigned>(oc.tiles - 1)) {
      __threadfence();                    // every partial is visible
      float total = 0.0f;
      for (int k = 0; k < oc.tiles; ++k) total += __ldcg(part + k);
      static_cast<float*>(a.out)[c] = fxp::shl(total, shift);
    }
  }
}

// T the carrier; MB, ML: the band-pass (band and out items) and low-pass
// (keep items) tap counts, or 0 for the generic body.
template <typename T, int MB, int ML>
__global__ void __launch_bounds__(kTile, 4)
fir_mp_oneshot_q_kernel(const __grid_constant__ Table tab, const Args a) {
  __shared__ T xt[2 * kTile + kP];
  __shared__ typename fxp::SumOf<T>::type wsum[kTile / 32];
  __shared__ int item;
  for (;;) {
    if (threadIdx.x == 0) item = (int)atomicAdd(a.head, 1u);
    __syncthreads();
    const int q = item;
    if (q >= a.items) return;
    int s = 0;
    while (s + 1 < a.num_segments && tab.seg[s + 1].start <= q) ++s;
    const Segment& sg = tab.seg[s];
    const Octave& oc = tab.oct[sg.octave];
    const int* rec = a.stages + (size_t)sg.octave * kStageWords;
    const int i = sg.offset + q - sg.start;
    if (sg.kind == kBand)
      band_item<T, kP, MB>(oc, a, rec, i, xt, wsum);
    else if (sg.kind == kKeep)
      fir_item<T, kLP, ML, true>(oc, a, rec, i, xt);
    else
      fir_item<T, kP, MB, false>(oc, a, rec, i, xt);
    __syncthreads();   // xt, wsum and item are rewritten by the next item
  }
}

// Fields of one host table row, as int64 (kernels/fir_mp.py packs them).
enum { kSrc, kDst, kReadyIn, kReadyOut, kN, kTiles, kFirF, kFirTiles,
       kOutLen, kStride, kReadyTarget, kCol, kOctFields };

// CTAs the card holds at once for this instantiation (cached per device).
template <typename T, int MB, int ML>
int resident_ctas() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cache[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fir_mp_oneshot_q_kernel<T, MB, ML>, kTile, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

template <typename T, int MB, int ML>
int run(const Table& t, const Args& a, cudaStream_t stream) {
  const int ctas = resident_ctas<T, MB, ML>();
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = a.items < ctas ? a.items : ctas;
  fir_mp_oneshot_q_kernel<T, MB, ML><<<grid, kTile, 0, stream>>>(t, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_carrier(const Table& t, const Args& a, bool uses_m, bool uses_m_lp,
                cudaStream_t stream) {
  if ((!uses_m || a.M == 16) && (!uses_m_lp || a.M_lp == 6))
    return run<T, 16, 6>(t, a, stream);
  return run<T, 0, 0>(t, a, stream);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Runs a plan's queue in one launch. `stages` is the device stage table
// (one kStageWords record per octave, int32); `octs` (num_octaves x
// kOctFields int64) and `segs` (num_segments x 5 int32: kind, octave,
// start, count, offset, in queue order; each kind of each octave covered
// once, in order) are host memory, copied into the launch's parameters.
// The codes (x, the scratch signals, y) are int32, or float32 under
// `float_carrier`. out (B, P) takes the band sums: int32, zeroed; float32
// (written once per column) with `partials` (B F sum(tiles) float32:
// octave o's (B, F, tiles_o) after the octaves before it) and `done` (B P
// uint32, zeroed). `counters` (uint32) holds the queue head first, then
// the table's ready counters, all zeroed. The stage table's F, M and M_lp
// are the caller's F, M and M_lp. Returns 0, a cudaError_t code, or -1 for
// a table this kernel does not take (1 <= M <= 16, 1 <= M_lp <= 8, F M <=
// 512; items sized as the plan sizes them; segments covering the queue in
// order; every item after the keep items it waits for, so that the launch
// cannot hang; on the float carrier, band items need partials and done).
extern "C" int fir_mp_oneshot_q_launch(void* out, void* counters,
                                       const void* stages,
                                       const int64_t* octs, int num_octaves,
                                       const int32_t* segs, int num_segments,
                                       int B, int F, int P, int M, int M_lp,
                                       int float_carrier, void* partials,
                                       void* done, void* stream) {
  if (B < 1 || F < 1 || M < 1 || M > kP || M_lp < 1 || M_lp > kLP ||
      F * M > kMaxBP || num_octaves < 1 || num_octaves > kMaxOctaves ||
      num_segments < 1 || num_segments > kMaxSegments || !counters ||
      !stages)
    return -1;
  Table t = {};
  size_t part_off = 0;
  for (int o = 0; o < num_octaves; ++o) {
    const int64_t* r = octs + (size_t)o * kOctFields;
    Octave& oc = t.oct[o];
    oc.src = reinterpret_cast<const void*>(r[kSrc]);
    oc.dst = reinterpret_cast<void*>(r[kDst]);
    oc.ready_in = reinterpret_cast<unsigned*>(r[kReadyIn]);
    oc.ready_out = reinterpret_cast<unsigned*>(r[kReadyOut]);
    oc.n = static_cast<int>(r[kN]);
    oc.tiles = static_cast<int>(r[kTiles]);
    oc.fir_F = static_cast<int>(r[kFirF]);
    oc.fir_tiles = static_cast<int>(r[kFirTiles]);
    oc.out_len = static_cast<int>(r[kOutLen]);
    oc.stride = static_cast<int>(r[kStride]);
    oc.ready_target = static_cast<int>(r[kReadyTarget]);
    oc.col = static_cast<int>(r[kCol]);
    if (float_carrier && partials) {
      oc.partial = static_cast<float*>(partials) + part_off;
      part_off += (size_t)B * F * oc.tiles;
    }
    if (!oc.src || oc.n < 1) return -1;
    // octave o >= 1 reads what octave o - 1's keep items write and waits
    // for all of them; octave 0 reads the input and waits for nothing
    if (o == 0 ? oc.ready_in != nullptr
               : (!oc.ready_in || oc.ready_in != t.oct[o - 1].ready_out ||
                  oc.src != t.oct[o - 1].dst ||
                  oc.n != t.oct[o - 1].out_len ||
                  oc.ready_target != t.oct[o - 1].fir_tiles))
      return -1;
  }
  bool uses_m = false, uses_m_lp = false;
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
      uses_m = true;
      if (!out || oc.tiles != ceil_div(oc.n, kTile) || oc.col < 0 ||
          oc.col + F > P || (float_carrier && (!partials || !done)))
        return -1;
      total[kBand][sg.octave] = B * F * oc.tiles;
    } else {
      const bool keep = sg.kind == kKeep;
      (keep ? uses_m_lp : uses_m) = true;
      const int Fw = keep ? 1 : F;
      const int len = keep ? (oc.n + 1) / 2 : oc.n;
      if (!oc.dst || (keep && !oc.ready_out) || oc.fir_F != Fw ||
          oc.stride != (keep ? 2 : 1) || oc.out_len != len ||
          oc.fir_tiles != ceil_div(len, kTile))
        return -1;
      total[sg.kind][sg.octave] = B * Fw * oc.fir_tiles;
    }
  }
  for (int k = 0; k < 3; ++k)
    for (int o = 0; o < num_octaves; ++o)
      if (covered[k][o] != total[k][o]) return -1;
  Args a = {};
  a.out = out;
  a.head = static_cast<unsigned*>(counters);
  a.stages = static_cast<const int*>(stages);
  a.done = static_cast<unsigned*>(done);
  a.items = next;
  a.num_segments = num_segments;
  a.F = F;
  a.P = P;
  a.M = M;
  a.M_lp = M_lp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return float_carrier ? run_carrier<float>(t, a, uses_m, uses_m_lp, st)
                       : run_carrier<int>(t, a, uses_m, uses_m_lp, st);
}

// CTAs the card holds at once for the configuration's int32 instantiation
// (16 band-pass and 6 low-pass taps), or for the generic one: the grid a
// launch of at least that many items takes. 0 if the runtime says no.
extern "C" int fir_mp_oneshot_q_ctas(int generic) {
  return generic ? resident_ctas<int, 0, 0>() : resident_ctas<int, 16, 6>();
}
