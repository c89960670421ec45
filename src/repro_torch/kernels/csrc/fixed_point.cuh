// The integer datapath shared by the two fixed-point kernels
// (fir_mp_bank_q.cu, fir_mp_stream_q.cu): shifts with the reference's
// semantics for any count, saturating clamps, and the integer MP solve.
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

// mpabs(u) - mpabs(v) by integer bisection over the first M of P lanes:
// for each of u and v, hi = max |lane|, lo = hi - gamma, then `iters`
// steps of mid = (lo + hi) >> 1, too_low = sum relu(t - mid) +
// relu(-t - mid) > gamma; the answer is hi (core/fixed.py fxp_mpabs). The
// two chains are independent and run interleaved. Operands are clamped
// codes of the 10-bit internal path, so no sum here comes near 2**31.
template <int P>
__device__ __forceinline__ int mp_dot_q(const int (&u)[P], const int (&v)[P],
                                        int M, int gamma, int iters) {
  int hu = 0, hv = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < M) {
      hu = max(hu, abs(u[k]));
      hv = max(hv, abs(v[k]));
    }
  }
  int lu = hu - gamma, lv = hv - gamma;
#pragma unroll 1  // keep code size down; lanes unroll
  for (int it = 0; it < iters; ++it) {
    const int mu = (lu + hu) >> 1;
    const int mv = (lv + hv) >> 1;
    int su = 0, sv = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < M) {
        su += max(u[k] - mu, 0) + max(-u[k] - mu, 0);
        sv += max(v[k] - mv, 0) + max(-v[k] - mv, 0);
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
