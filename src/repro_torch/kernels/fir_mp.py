"""Wrappers of the hand-written CUDA kernels for the MP FIR.

* ``fir_mp_stream_octave`` — ``csrc/fir_mp_stream.cu``, one octave of the
  float session step (replaces the reference's Pallas
  ``fir_mp_stream_octave``);
* ``fir_mp_bank_kernel`` — ``csrc/fir_mp_bank.cu``, the one-shot bank
  (replaces ``fir_mp_bank_pallas``);
* ``fir_mp_kernel`` — the same source with one filter (replaces
  ``fir_mp_pallas``).

A CUDA tensor launches the kernel on ``torch.cuda.current_stream()``; a CPU
tensor runs the plain PyTorch version in ``kernels.ref``; any other device
raises. There is no fallback from one to the other. Outputs are allocated
here with ``torch.empty``; a refused launch raises at once.

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call that
launched its kernel), so a run can show that its path went through them.
"""

from __future__ import annotations

import torch

from repro_torch.core.filterbank import accumulate_block_len
from repro_torch.kernels import ref

__all__ = ["LAUNCHES", "reset_launches", "fir_mp_stream_octave",
           "fir_mp_bank_kernel", "fir_mp_kernel"]

LAUNCHES = {"fir_mp_stream_octave": 0, "fir_mp_bank": 0, "fir_mp": 0}

_SOLVERS = {"newton": 0, "bisect": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (all on one card), False for CPU ones; raises
    otherwise or on a mix."""
    devices = {t.device for t in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    got = sorted(map(str, devices))
    raise ValueError(f"the MP FIR kernels take all-CUDA (one card) or "
                     f"all-CPU tensors, got devices {got}")


def _expect(name: str, t: torch.Tensor, shape: tuple) -> None:
    """The kernels index by these shapes: refuse anything else before a
    pointer reaches them."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def _f32(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _check(code: int, kernel: str, shapes: str) -> None:
    if code == -1:
        raise ValueError(f"{kernel}: shapes outside what the kernel takes "
                         f"({shapes})")
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{code} ({shapes})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
