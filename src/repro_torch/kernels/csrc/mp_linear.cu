// Fused multiplierless MP matrix product (paper eq. 9).
//
// Replaces: src/repro/kernels/mp_linear.py, mp_linear_pallas (Pallas body
// _mp_linear_kernel). Plain PyTorch version: repro_torch/kernels/ref.py,
// mp_linear.
//
// What it computes: x (B, d) f32, w (d, O) f32 or bf16 -> y (B, O) f32 with,
// for each (b, o), u_i = x[b, i] + w[i, o] and v_i = x[b, i] - w[i, o], both
// water-fillings over [u; -u] and [v; -v] bisected together in f32:
// hi = max_i |.|, lo = hi - gamma, then `iters` steps of mid = (lo + hi) / 2
// and h = sum_i max(t_i - mid, 0) + max(-t_i - mid, 0), the root above mid
// when h > gamma; y = (lo_u + hi_u) / 2 - (lo_v + hi_v) / 2.
//
// The step's form. A hinge pair equals max(|t| - |mid|, 0), plus 2 |mid|
// when mid < 0, so h = sum_i max(|t_i| - |mid|, 0) + (mid < 0 ? 2 d |mid|
// : 0). Per (b, o, i) and branch the kernel issues the add x +- w, one add
// |t| - |mid| (abs is an operand modifier), one max with 0 and the
// accumulate: 8 f32 instructions for u and v. (sum_i max(|t_i|, |mid|) -
// d |mid| would be as cheap but cancels: d |mid| >> gamma at d = 12,288.)
//
// What bounds it on an H100: operations, ~212 f32 instructions per
// (b, o, i) against 2 bytes of bf16 w that serve all B rows. So a CTA owns
// BB batch rows x TO output columns over all of d, copies its w slice (as
// bf16 when w is, laid out [position][TO] so one vector load brings a
// position's TO columns, widened in registers by a shift) and its x rows
// ([BB][position], f32) into shared memory once, by asynchronous copies
// (cp.async) all in flight at once, and runs all 27 passes from there.
// Its 256 threads split the positions; each keeps NV = 2 BB TO partial
// sums. A step ends in a transposed warp reduction (lane k ends with sum
// k, NV - 1 shuffles plus 5 - log2 NV), the warp sums go to a shared
// buffer chosen by the step's parity, and after the step's one barrier
// every warp adds the 8 warp sums in the same order, so all warps hold
// the same bits, move the NV brackets in registers (lane k, bracket k)
// and broadcast the new |mid| by shuffles. Tiles are sized
// per shape (see plan_for): the widest tile of which two CTAs fit an SM,
// else one, that still gives every SM a CTA. A d too wide for any tile in
// shared memory (about 18,700 positions at B = 2 and bf16 w) reads w and
// x from device memory in every pass (correct, slow).
//
// The TPU kernel streamed d in chunks of 512 (a VMEM limit) and needed d to
// be a multiple of it, and padded O to 128 columns; here any d and O go:
// ragged column and batch tiles are clamped on load and masked on store,
// and the d range is zero-padded to a multiple of the thread count (a zero
// position adds exactly 0 to every sum and max). The sums run in another
// order than the reference's, so a comparison right at gamma can go the
// other way; bisection still brackets the root within the sums' rounding.
//
// The forward of a training step (a non-null lv) runs the same kernel
// with LEVELS: after the same steps and the same store of y, it solves the
// exact water level of both branches of every (b, o) from the bracket it
// holds, on its resident tiles (Newton from the bracket's left end: one
// pass counts and sums the operands above it, each round recounts at the
// new level), and writes lv[b, o] = {z_u, z_v, 1 / k_u, 1 / k_v} (k the
// count of operands above the level, at least 1) for the backward's grads
// pass (mp_linear_bwd.cu). y keeps its bits: the tail runs after it.

#include "mp_linear.cuh"

// x (B, d) float32, w (d, O) float32 (w_bf16 = 0) or bfloat16 (w_bf16 = 1),
// row-major -> y (B, O) float32 and, where lv is not null, the levels
// lv (B, O, 4) float32, in the tile plan_for picks (to = 0) or in a
// resident tile of to = 2, 4 or 8 columns. Returns 0, a cudaError_t code,
// or -1 for what it does not take (B, d, O >= 1, iters >= 0, d <= 2^22; a
// tile to that does not fit).
extern "C" int mp_linear_launch(const void* x, const void* w, void* y,
                                void* lv, int B, int d, int O, int w_bf16,
                                int to, float gamma, int iters,
                                void* stream) {
  if (!takes(B, d, O, w_bf16, to, iters)) return -1;
  const Plan p = plan_for(B, d, O, w_bf16 ? 2 : 4, to);
  if (p.BB == 0) return -1;
  if (lv)
    return dispatch<true>(p, x, w, y, B, d, O, w_bf16, gamma, iters, stream,
                          nullptr, static_cast<float4*>(lv));
  return dispatch<false>(p, x, w, y, B, d, O, w_bf16, gamma, iters,
                         stream, nullptr);
}

// The tile mp_linear_launch takes for these arguments on the current
// device: out = {BB, TO, positions per CTA, CTAs, resident, CTAs an SM
// holds at once}, all 0 where the tile asked for does not fit. Returns 0,
// a cudaError_t code, or -1 for shapes it does not take.
extern "C" int mp_linear_plan(int B, int d, int O, int w_bf16, int to,
                              int* out) {
  if (!takes(B, d, O, w_bf16, to, 0)) return -1;
  const Plan p = plan_for(B, d, O, w_bf16 ? 2 : 4, to);
  int per_sm = 0;
  if (p.BB != 0) {
    const int code = dispatch<false>(p, nullptr, nullptr, nullptr, B, d, O,
                                     w_bf16, 1.f, 0, nullptr, &per_sm);
    if (code != 0) return code;
  }
  const int vals[6] = {p.BB, p.TO, p.dl, static_cast<int>(p.ctas), p.res,
                       per_sm};
  for (int k = 0; k < 6; ++k) out[k] = vals[k];
  return 0;
}
