"""Wrappers of the hand-written CUDA kernels for the MP FIR.

* ``fir_mp_stream_octave`` — ``csrc/fir_mp_stream.cu``, one octave of the
  float session step (replaces the reference's Pallas
  ``fir_mp_stream_octave``);
* ``fir_mp_bank_kernel`` — ``csrc/fir_mp_bank.cu``, the one-shot bank
  (replaces ``fir_mp_bank_pallas``);
* ``fir_mp_kernel`` — the same source with one filter (replaces
  ``fir_mp_pallas``);
* ``fir_mp_stream_octave_q`` — ``csrc/fir_mp_stream_q.cu``, one octave of
  the integer session step (replaces ``fir_mp_stream_octave_q``);
* ``fir_mp_bank_q_kernel`` — ``csrc/fir_mp_bank_q.cu``, the one-shot
  integer bank, both modes (replaces ``fir_mp_bank_q_pallas``).

A CUDA tensor launches the kernel on ``torch.cuda.current_stream()``; a CPU
tensor runs the plain PyTorch version in ``kernels.ref``; any other device
raises. There is no fallback from one to the other. Outputs are allocated
here with ``torch.empty``; a refused launch raises at once. The integer
kernels take int32 codes (the hardware path); their plain versions also
take codes carried in float32, which on the card raise (ROADMAP.md §2,
"f32-carried codes through the CUDA int kernels").

Each launch is counted in ``kernels._wrap.LAUNCHES``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.filterbank import accumulate_block_len
from repro_torch.kernels import ref
from repro_torch.kernels._wrap import (LAUNCHES, _check, _expect, _f32,
                                       _on_cuda, _stream)

__all__ = ["fir_mp_stream_octave", "fir_mp_bank_kernel", "fir_mp_kernel",
           "fir_mp_stream_octave_q", "fir_mp_bank_q_kernel"]

_SOLVERS = {"newton": 0, "bisect": 1}


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _codes(t: torch.Tensor, name: str, kernel: str) -> torch.Tensor:
    """int32 codes for an integer kernel; float-carried codes raise."""
    if t.dtype != torch.int32:
        raise ValueError(
            f"{kernel}: {name} must be int32 codes on the card, got "
            f"{t.dtype} (float-carried codes run only in the plain version; "
            "ROADMAP.md §2, 'f32-carried codes through the CUDA int "
            "kernels')")
    return t.contiguous()


def _host_codes(a) -> np.ndarray:
    """Program constants (tap codes) as a contiguous int32 host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def fir_mp_stream_octave(x, n, start, delay, acc, amax, H, lp, gamma, *,
                         scale: float = 1.0, solver: str = "newton",
                         emit_next: bool = True, update_amax: bool = False):
    """One octave of the stateful session step.

    x (S, L) this octave's chunk (octave 0: invalid tails zeroed); n (S,)
    valid counts; start (S,) ÷2 phase; delay (S, T1) delay line; acc
    (S, F) this octave's accumulators; amax (S,) running amax (updated only
    under ``update_amax``); H (F, M) band-pass taps; lp (M_lp,) low-pass
    taps (unused without ``emit_next``). Returns ``(acc', delay', amax',
    y_next | None)``; y_next is (S, ceil(L/LB) * LB // 2), the next
    octave's signal in its first ``(L + 1) // 2`` columns.
    """
    if solver not in _SOLVERS:
        raise ValueError(f"unknown MP solver: {solver!r}")
    if not _on_cuda(x, n, start, delay, acc, amax, H, lp):
        return ref.fir_mp_stream_octave(
            x, n, start, delay, acc, amax, H, lp, gamma, scale=scale,
            solver=solver, emit_next=emit_next, update_amax=update_amax)
    from repro_torch.kernels._build import load
    S, L = x.shape
    Fn, M = H.shape
    T1 = delay.shape[1]
    M_lp = lp.shape[0]
    for name, t, shape in (("n", n, (S,)), ("start", start, (S,)),
                           ("delay", delay, (S, T1)), ("acc", acc, (S, Fn)),
                           ("amax", amax, (S,)), ("lp", lp, (M_lp,))):
        _expect(name, t, shape)
    LB = accumulate_block_len(L)
    NB = -(-L // LB)
    x, delay, acc, amax, H, lp = (
        _f32(t, nm) for t, nm in ((x, "x"), (delay, "delay"), (acc, "acc"),
                                  (amax, "amax"), (H, "H"), (lp, "lp")))
    n, start = _i32(n), _i32(start)
    acc_o = torch.empty_like(acc)
    delay_o = torch.empty_like(delay)
    amax_o = torch.empty_like(amax)
    y_next = (torch.empty((S, NB * (LB // 2)), dtype=x.dtype, device=x.device)
              if emit_next else None)
    code = load("fir_mp_stream")(
        x.data_ptr(), n.data_ptr(), start.data_ptr(), delay.data_ptr(),
        acc.data_ptr(), amax.data_ptr(), H.data_ptr(), lp.data_ptr(),
        acc_o.data_ptr(), delay_o.data_ptr(), amax_o.data_ptr(),
        y_next.data_ptr() if emit_next else None,
        S, L, LB, Fn, M, T1, M_lp, float(gamma), float(scale),
        _SOLVERS[solver], int(emit_next), int(update_amax), _stream())
    _check(code, "fir_mp_stream_octave",
           f"S={S} L={L} F={Fn} M={M} T1={T1} M_lp={M_lp}")
    LAUNCHES["fir_mp_stream_octave"] += 1
    return acc_o, delay_o, amax_o, y_next


def _bank_launch(x, H, gamma, accumulate, iters, key):
    from repro_torch.kernels._build import load
    x, H = _f32(x, "x"), _f32(H, "H")
    if x.ndim != 2 or H.ndim != 2:
        raise ValueError(f"x must be (B, N) and H (F, M), got "
                         f"{tuple(x.shape)} and {tuple(H.shape)}")
    B, N = x.shape
    Fn, M = H.shape
    if accumulate:
        out = torch.empty((B, Fn), dtype=x.dtype, device=x.device)
        partial = torch.empty((B, Fn, -(-N // ref.BANK_TILE)),
                              dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((B, Fn, N), dtype=x.dtype, device=x.device)
        partial = None
    code = load("fir_mp_bank")(
        x.data_ptr(), H.data_ptr(), out.data_ptr(),
        partial.data_ptr() if accumulate else None,
        B, N, Fn, M, float(gamma), int(iters), int(accumulate), _stream())
    _check(code, key, f"B={B} N={N} F={Fn} M={M}")
    LAUNCHES[key] += 1
    return out


def fir_mp_bank_kernel(x, H, gamma, *, accumulate: bool = False,
                       iters: int = ref.DEFAULT_ITERS):
    """One-shot bank: x (B, N), H (F, M) -> y (B, F, N), or the HWR sums
    (B, F) under ``accumulate``."""
    if not _on_cuda(x, H):
        fn = ref.fir_mp_bank_accumulate if accumulate else ref.fir_mp_bank
        return fn(x, H, gamma, iters)
    return _bank_launch(x, H, gamma, accumulate, iters, "fir_mp_bank")


def fir_mp_kernel(x, h, gamma, *, accumulate: bool = False,
                  iters: int = ref.DEFAULT_ITERS):
    """Single filter: x (B, N), h (M,) -> y (B, N), or (B,) under
    ``accumulate`` — the bank kernel launched with ``H = h[None]``."""
    if not _on_cuda(x, h):
        fn = ref.fir_mp_accumulate if accumulate else ref.fir_mp
        return fn(x, h, gamma, iters)
    out = _bank_launch(x, h[None], gamma, accumulate, iters, "fir_mp")
    return out[:, 0]


def fir_mp_stream_octave_q(x, n, start, delay, acc, amax, *, stage,
                           next_spec=None, emit_next: bool = True,
                           update_amax: bool = False):
    """One octave of the integer session step.

    x (S, L) this octave's register codes (octave 0: invalid tails zeroed);
    n (S,) valid counts; start (S,) ÷2 phases; delay (S, T1) delay-line
    codes; acc (S, F) accumulators; amax (S,) running max |code| (updated
    only under ``update_amax``); ``stage`` the compiled
    ``core.fixed.OctaveStage`` (taps, shifts, gammas, iterations, clamp
    bounds); ``next_spec`` the next octave's register spec (required with
    ``emit_next``). Returns ``(acc', delay', amax', y_next | None)``,
    y_next (S, (L + 1) // 2) next-octave codes.
    """
    if emit_next and next_spec is None:
        raise ValueError("emit_next needs the next octave's next_spec")
    if not _on_cuda(x, n, start, delay, acc, amax):
        return ref.fir_mp_stream_octave_q(
            x, n, start, delay, acc, amax, stage=stage, next_spec=next_spec,
            emit_next=emit_next, update_amax=update_amax)
    from repro_torch.kernels._build import load
    key = "fir_mp_stream_octave_q"
    S, L = x.shape
    bp = _host_codes(stage.bp_q)
    Fn, M = bp.shape
    T1 = delay.shape[1]
    lp = (_host_codes(stage.lp_q).reshape(-1) if emit_next
          else np.zeros(1, np.int32))
    for name, t, shape in (("n", n, (S,)), ("start", start, (S,)),
                           ("delay", delay, (S, T1)), ("acc", acc, (S, Fn)),
                           ("amax", amax, (S,))):
        _expect(name, t, shape)
    x, delay, acc, amax = (_codes(t, nm, key) for t, nm in (
        (x, "x"), (delay, "delay"), (acc, "acc"), (amax, "amax")))
    n, start = _i32(n), _i32(start)
    lp_spec = stage.lp_spec if emit_next else stage.band_spec
    nxt = next_spec if emit_next else stage.band_spec
    scalars = np.asarray(
        [Fn, M, lp.shape[0], T1, stage.sig_shift, stage.lp_sig_shift,
         stage.lp_out_shift, stage.acc_shift, stage.gamma_bp, stage.iters_bp,
         stage.gamma_lp, stage.iters_lp, stage.band_spec.qmin,
         stage.band_spec.qmax, lp_spec.qmin, lp_spec.qmax, nxt.qmin,
         nxt.qmax], np.int32)
    acc_o = torch.empty_like(acc)
    delay_o = torch.empty_like(delay)
    amax_o = torch.empty_like(amax)
    y_next = (torch.empty((S, (L + 1) // 2), dtype=torch.int32,
                          device=x.device) if emit_next else None)
    code = load("fir_mp_stream_q")(
        x.data_ptr(), n.data_ptr(), start.data_ptr(), delay.data_ptr(),
        acc.data_ptr(), amax.data_ptr(), bp.ctypes.data, lp.ctypes.data,
        scalars.ctypes.data, acc_o.data_ptr(), delay_o.data_ptr(),
        amax_o.data_ptr(), y_next.data_ptr() if emit_next else None,
        S, L, accumulate_block_len(L), int(emit_next), int(update_amax),
        _stream())
    _check(code, key, f"S={S} L={L} F={Fn} M={M} T1={T1} "
                      f"M_lp={lp.shape[0]}")
    LAUNCHES[key] += 1
    return acc_o, delay_o, amax_o, y_next


def fir_mp_bank_q_kernel(xq, H_q, *, gamma_q: int, iters: int, qmin: int,
                         qmax: int, accumulate: bool = False):
    """One-shot integer bank: xq (B, N) codes on the stage grid, H_q (F, M)
    tap codes (host array or tensor) -> (B, F, N) band codes, or the
    integer HWR sums (B, F) under ``accumulate``."""
    if not _on_cuda(xq):
        fn = ref.fir_mp_bank_q_accumulate if accumulate else ref.fir_mp_bank_q
        return fn(xq, H_q, gamma_q, iters, qmin, qmax)
    from repro_torch.kernels._build import load
    key = "fir_mp_bank_q"
    xq = _codes(xq, "xq", key)
    H = _host_codes(H_q)
    if xq.ndim != 2 or H.ndim != 2:
        raise ValueError(f"xq must be (B, N) and H_q (F, M), got "
                         f"{tuple(xq.shape)} and {H.shape}")
    B, N = xq.shape
    Fn, M = H.shape
    shape = (B, Fn) if accumulate else (B, Fn, N)
    out = torch.empty(shape, dtype=torch.int32, device=xq.device)
    code = load("fir_mp_bank_q")(
        xq.data_ptr(), H.ctypes.data, out.data_ptr(), B, N, Fn, M,
        int(gamma_q), int(iters), int(qmin), int(qmax), int(accumulate),
        _stream())
    _check(code, key, f"B={B} N={N} F={Fn} M={M}")
    LAUNCHES[key] += 1
    return out
