// The integer datapath shared by the two fixed-point kernels
// (fir_mp_bank_q.cu, fir_mp_stream_q.cu), on either carrier of the codes:
// shifts with the reference's semantics for any count, saturating clamps,
// adds, and the integer MP solve in its cheapest exact form (one branch
// alone, or both branches of a dot interleaved).
//
// int32 (the hardware twin). The reference (src/repro/core/fixed.py)
// shifts int32 with XLA's rules: a left shift by 32 or more gives 0, an
// arithmetic right shift by 32 or more gives the sign (0 or -1). In C++
// such a shift of an int is undefined, so every shift here whose count is
// not known to be under 32 is guarded. Left shifts go through unsigned (a
// shifted-out bit wraps, as in XLA, instead of being undefined); right
// shifts of a signed int are arithmetic under nvcc, which floors negative
// codes as the reference's shift_right does. Adds wrap like int32.
//
// float32 carrying integer codes (the fake-quant twin). The reference's
// float carrier: a right shift is floor(ldexp(q, -k)), a left shift the
// exact ldexp(q, k), adds round as f32 adds do (no wrap). So a right shift
// by 32 or more of a negative code is -1 and of another code 0, a left
// shift by 32 or more scales. This needs denormals: floor of a negative
// denormal is -1, of the -0 that flush-to-zero would make of it -0. The
// build (kernels/_build.py) keeps them: no fast math, no -ftz=true. Below
// 2**24 every value and sum is an exact integer and both carriers give the
// same codes.

#pragma once

namespace fxp {

// -- int32 -------------------------------------------------------------------

__device__ __forceinline__ int shl(int q, int k) {
  return k >= 32 ? 0 : static_cast<int>(static_cast<unsigned>(q) << k);
}

__device__ __forceinline__ int shr(int q, int k) {
  return q >> (k >= 32 ? 31 : k);
}

__device__ __forceinline__ int half(int q) { return q >> 1; }   // shr(q, 1)

__device__ __forceinline__ int mag(int q) { return abs(q); }

__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }

// a + b and a - b wrapping like the reference's int32 (signed overflow
// would be undefined in C++)
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// -- float32 carrying integer codes ---------------------------------------

__device__ __forceinline__ float shl(float q, int k) { return ldexpf(q, k); }

__device__ __forceinline__ float shr(float q, int k) {
  return floorf(ldexpf(q, -k));
}

// shr(q, 1): halving an integer-valued float is exact (no denormal arises)
__device__ __forceinline__ float half(float q) { return floorf(q * 0.5f); }

__device__ __forceinline__ float mag(float q) { return fabsf(q); }

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }

__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }

__device__ __forceinline__ float wadd(float a, float b) { return a + b; }

__device__ __forceinline__ float wsub(float a, float b) { return a - b; }

// -- either carrier ---------------------------------------------------------

// q * 2**k: left shift for k >= 0, floor right shift for k < 0
template <typename T>
__device__ __forceinline__ T rescale(T q, int k) {
  return k >= 0 ? shl(q, k) : shr(q, -k);
}

template <typename T>
__device__ __forceinline__ T clamp(T q, T lo, T hi) {
  return vmin(vmax(q, lo), hi);
}

// |clamp(t, qmin, qmax)| for qmin > INT_MIN and qmax >= 0, written without
// an abs: with t' = max(t, qmin), max(min(t', qmax), min(-t', -qmin)).
// Given abs(clamp(...)), ptxas keeps the clamped value in a register and
// recomputes the abs in every bisection step that reads the magnitude (an
// IABS per lane per step, PERF.md §6); this form it keeps as it is.
template <typename T>
__device__ __forceinline__ T clamp_mag(T t, T qmin, T qmax) {
  const T lo = vmax(t, qmin);
  return vmax(vmin(lo, qmax), vmin(-lo, -qmin));
}

// mpabs(t) alone, over the first m of P lanes (MC: m at compile time, 0
// for the runtime M), in the cheapest exact form of a bisection step. A
// lane's two hinges are symmetric in t, so with a = |t|:
//   relu(t - mid) + relu(-t - mid) = max(a, |mid|) - mid
// (mid >= 0: the second hinge is 0 and relu(a - mid) = max(a, mid) - mid;
// mid < 0: a - mid > 0 and adding relu(-a - mid) gives max(-2 mid, a -
// mid)). So each step sums max(a_k, |mid|) over the lanes and subtracts
// m * mid: the same integer as fxp_mpabs's constraint, so the same
// compare and the same bits (on the float carrier too: codes are 10-bit,
// every term and sum an exact integer far below 2**24). The caller passes
// the magnitudes a = |t|: given t, ptxas recomputes |t| in every step (one
// IABS per lane per step, PERF.md §6).
template <int P, int MC, typename T>
__device__ __forceinline__ T mpabs_q_mag(const T (&a)[P], int M, int gamma,
                                         int iters) {
  const int m = MC ? MC : M;
  const T g = static_cast<T>(gamma);
  T hi = 0;
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k < m) hi = vmax(hi, a[k]);
  T lo = hi - g;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < iters; ++it) {
    const T mid = half(lo + hi);
    const T am = mag(mid);
    T s = static_cast<T>(-m) * mid;
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < m) s += vmax(a[k], am);
    const bool too_low = s > g;
    lo = too_low ? mid : lo;
    hi = too_low ? hi : mid;
  }
  return hi;
}

// mpabs(u) - mpabs(v) from the magnitudes au = |u|, av = |v| over the
// first m of P lanes (MC as in mpabs_q_mag): the two bisections of
// mpabs_q_mag's form, interleaved in one loop (both take `iters` steps).
template <int P, int MC, typename T>
__device__ __forceinline__ T mp_dot_q_mag(const T (&au)[P], const T (&av)[P],
                                          int M, int gamma, int iters) {
  const int m = MC ? MC : M;
  const T g = static_cast<T>(gamma);
  T hu = 0, hv = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < m) {
      hu = vmax(hu, au[k]);
      hv = vmax(hv, av[k]);
    }
  }
  T lu = hu - g, lv = hv - g;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < iters; ++it) {
    const T mu = half(lu + hu);
    const T mv = half(lv + hv);
    const T amu = mag(mu), amv = mag(mv);
    T su = static_cast<T>(-m) * mu, sv = static_cast<T>(-m) * mv;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < m) {
        su += vmax(au[k], amu);
        sv += vmax(av[k], amv);
      }
    }
    const bool tu = su > g, tv = sv > g;
    lu = tu ? mu : lu;
    hu = tu ? hu : mu;
    lv = tv ? mv : lv;
    hv = tv ? hv : mv;
  }
  return hu - hv;
}

// The sum of v over a warp's 32 lanes, in every lane. int32 sums wrap, and
// wrapping adds are associative: the hardware reduction, in any order.
// Float sums round once past 2**24: a butterfly, whose order is fixed, so a
// run gives the same bits every time.
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// A filter's HWR partial sums: unsigned (wrapping) on the int32 carrier,
// float on the float one.
template <typename T> struct SumOf;
template <> struct SumOf<int> { using type = unsigned; };
template <> struct SumOf<float> { using type = float; };

// max(y, 0) as a partial-sum term, and a partial sum back as a code
__device__ __forceinline__ unsigned hwr_term(int y) {
  return static_cast<unsigned>(max(y, 0));
}

__device__ __forceinline__ float hwr_term(float y) { return fmaxf(y, 0.0f); }

__device__ __forceinline__ int from_sum(unsigned s) {
  return static_cast<int>(s);
}

__device__ __forceinline__ float from_sum(float s) { return s; }

// A nonnegative code as int bits whose order is the code's (a float >= +0
// orders as its bits do), for an int max across threads, and back.
__device__ __forceinline__ int max_bits(int q) { return q; }

__device__ __forceinline__ int max_bits(float q) { return __float_as_int(q); }

template <typename T>
__device__ __forceinline__ T from_max_bits(int b);

template <>
__device__ __forceinline__ int from_max_bits<int>(int b) { return b; }

template <>
__device__ __forceinline__ float from_max_bits<float>(int b) {
  return __int_as_float(b);
}

}  // namespace fxp
