// The integer datapath shared by the two fixed-point kernels
// (fir_mp_bank_q.cu, fir_mp_stream_q.cu): shifts with the reference's
// semantics for any count, saturating clamps, wrapping adds, and the
// integer MP solve in its cheapest exact form (one branch alone, or both
// branches of a dot interleaved).
//
// The reference (src/repro/core/fixed.py) shifts int32 with XLA's rules:
// a left shift by 32 or more gives 0, an arithmetic right shift by 32 or
// more gives the sign (0 or -1). In C++ such a shift of an int is
// undefined, so every shift here whose count is not known to be under 32
// is guarded. Left shifts go through unsigned (a shifted-out bit wraps, as
// in XLA, instead of being undefined); right shifts of a signed int are
// arithmetic under nvcc, which floors negative codes as the reference's
// shift_right does.

#pragma once

namespace fxp {

__device__ __forceinline__ int shl(int q, int k) {
  return k >= 32 ? 0 : static_cast<int>(static_cast<unsigned>(q) << k);
}

__device__ __forceinline__ int shr(int q, int k) {
  return q >> (k >= 32 ? 31 : k);
}

// q * 2**k: left shift for k >= 0, floor right shift for k < 0
__device__ __forceinline__ int rescale(int q, int k) {
  return k >= 0 ? shl(q, k) : shr(q, -k);
}

__device__ __forceinline__ int clamp(int q, int lo, int hi) {
  return min(max(q, lo), hi);
}

// |clamp(t, qmin, qmax)| for qmin > INT_MIN and qmax >= 0, written without
// an abs: with t' = max(t, qmin), max(min(t', qmax), min(-t', -qmin)).
// Given abs(clamp(...)), ptxas keeps the clamped value in a register and
// recomputes the abs in every bisection step that reads the magnitude (an
// IABS per lane per step, PERF.md §6); this form it keeps as it is.
__device__ __forceinline__ int clamp_mag(int t, int qmin, int qmax) {
  const int lo = max(t, qmin);
  return max(min(lo, qmax), min(-lo, -qmin));
}

// a + b and a - b wrapping like the reference's int32 (signed overflow
// would be undefined in C++)
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// mpabs(t) alone, over the first m of P lanes (MC: m at compile time, 0
// for the runtime M), in the cheapest exact form of a bisection step. A
// lane's two hinges are symmetric in t, so with a = |t|:
//   relu(t - mid) + relu(-t - mid) = max(a, |mid|) - mid
// (mid >= 0: the second hinge is 0 and relu(a - mid) = max(a, mid) - mid;
// mid < 0: a - mid > 0 and adding relu(-a - mid) gives max(-2 mid, a -
// mid)). So each step sums max(a_k, |mid|) over the lanes and subtracts
// m * mid: the same integer as fxp_mpabs's constraint, so the same
// compare and the same bits. Codes are 10-bit, far from overflow. The
// caller passes the magnitudes a = |t|: given t, ptxas recomputes |t| in
// every step (one IABS per lane per step, PERF.md §6).
template <int P, int MC>
__device__ __forceinline__ int mpabs_q_mag(const int (&a)[P], int M,
                                           int gamma, int iters) {
  const int m = MC ? MC : M;
  int hi = 0;
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k < m) hi = max(hi, a[k]);
  int lo = hi - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < iters; ++it) {
    const int mid = (lo + hi) >> 1;
    const int am = abs(mid);
    int s = -m * mid;
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < m) s += max(a[k], am);
    const bool too_low = s > gamma;
    lo = too_low ? mid : lo;
    hi = too_low ? hi : mid;
  }
  return hi;
}

// mpabs(u) - mpabs(v) from the magnitudes au = |u|, av = |v| over the
// first m of P lanes (MC as in mpabs_q_mag): the two bisections of
// mpabs_q_mag's form, interleaved in one loop (both take `iters` steps).
template <int P, int MC>
__device__ __forceinline__ int mp_dot_q_mag(const int (&au)[P],
                                            const int (&av)[P], int M,
                                            int gamma, int iters) {
  const int m = MC ? MC : M;
  int hu = 0, hv = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < m) {
      hu = max(hu, au[k]);
      hv = max(hv, av[k]);
    }
  }
  int lu = hu - gamma, lv = hv - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < iters; ++it) {
    const int mu = (lu + hu) >> 1;
    const int mv = (lv + hv) >> 1;
    const int amu = abs(mu), amv = abs(mv);
    int su = -m * mu, sv = -m * mv;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < m) {
        su += max(au[k], amu);
        sv += max(av[k], amv);
      }
    }
    const bool tu = su > gamma, tv = sv > gamma;
    lu = tu ? mu : lu;
    hu = tu ? hu : mu;
    lv = tv ? mv : lv;
    hv = tv ? hv : mv;
  }
  return hu - hv;
}

}  // namespace fxp
