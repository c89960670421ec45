"""Public wrappers around the port's kernels: leading batch dims, layouts,
and the octave cascade of the session step.

Every function here reaches a kernel wrapper in ``kernels.fir_mp`` or
``kernels.mp_kernels``, which launches the CUDA kernel for CUDA tensors
and runs the plain PyTorch version for CPU tensors. The cascade wrappers
are exported as they are: ``fir_mp_oneshot_cascade(_q)`` (the one-shot
banks, the routes of ``core.filterbank.multirate_accumulate`` and
``core.fixed.bank_accumulate_q`` under ``use_pallas``) and the session
step's ``fir_mp_stream(_q)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fir_mp import (fir_mp_bank_kernel,
                                         fir_mp_bank_q_kernel, fir_mp_kernel,
                                         fir_mp_oneshot_cascade,
                                         fir_mp_oneshot_cascade_q,
                                         fir_mp_stream_cascade,
                                         fir_mp_stream_cascade_q)
from repro_torch.kernels.mp_kernels import (LINEAR_W_DTYPES,
                                            mp_linear_kernel,
                                            mp_waterfill_kernel)
from repro_torch.kernels.ref import DEFAULT_ITERS

__all__ = ["mp_waterfill", "mp_linear", "fir_mp", "fir_mp_accumulate",
           "fir_mp_bank", "fir_mp_bank_accumulate",
           "fir_mp_oneshot_cascade", "fir_mp_stream",
           "fir_mp_bank_q", "fir_mp_bank_q_accumulate",
           "fir_mp_oneshot_cascade_q", "fir_mp_stream_q"]


def mp_waterfill(L: torch.Tensor, gamma, *,
                 iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """z = MP(L, gamma) along the last axis; any leading batch shape."""
    z = mp_waterfill_kernel(L.reshape(-1, L.shape[-1]), gamma, iters)
    return z.reshape(L.shape[:-1])


def mp_linear(x: torch.Tensor, w: torch.Tensor, gamma, *,
              iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """Multiplierless (..., d) @ (d, O) through the fused kernel. A w of a
    dtype the kernel does not read (``LINEAR_W_DTYPES``) is widened to
    float32 first.

    Forward only: the reference's custom VJP becomes a
    ``torch.autograd.Function`` with the training slice (ROADMAP.md), so
    until then a call that autograd would have to differentiate raises
    rather than silently detaching.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "ops.mp_linear is forward only: its gradient (the reference's "
            "custom VJP) comes with the training slice (ROADMAP.md); run "
            "it under torch.no_grad() or on tensors without requires_grad")
    if w.dtype not in LINEAR_W_DTYPES:
        w = w.float()
    y = mp_linear_kernel(x.reshape(-1, x.shape[-1]), w, gamma, iters)
    return y.reshape(*x.shape[:-1], w.shape[1])


def fir_mp(x: torch.Tensor, h: torch.Tensor, gamma, *,
           iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """In-filter MP FIR: x (..., N), h (M,) -> y (..., N)."""
    x2 = x.reshape(-1, x.shape[-1])
    return fir_mp_kernel(x2, h, gamma, iters=iters).reshape(x.shape)


def fir_mp_accumulate(x: torch.Tensor, h: torch.Tensor, gamma, *,
                      iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """Fused FIR + HWR + accumulate: x (..., N), h (M,) -> s (...)."""
    x2 = x.reshape(-1, x.shape[-1])
    s = fir_mp_kernel(x2, h, gamma, accumulate=True, iters=iters)
    return s.reshape(x.shape[:-1])


def fir_mp_bank(x: torch.Tensor, H: torch.Tensor, gamma, *,
                iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """Multi-filter MP FIR: x (..., N), H (F, M) -> y (..., F, N)."""
    x2 = x.reshape(-1, x.shape[-1])
    y = fir_mp_bank_kernel(x2, H, gamma, iters=iters)
    return y.reshape(*x.shape[:-1], H.shape[0], x.shape[-1])


def fir_mp_bank_accumulate(x: torch.Tensor, H: torch.Tensor, gamma, *,
                           iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """Fused bank FIR + HWR + accumulate: x (..., N), H (F, M) -> (..., F)."""
    x2 = x.reshape(-1, x.shape[-1])
    s = fir_mp_bank_kernel(x2, H, gamma, accumulate=True, iters=iters)
    return s.reshape(*x.shape[:-1], H.shape[0])


# The multirate session step: the whole octave cascade in one launch on the
# card, the plain per-octave loop on the CPU (float: ``ref.fir_mp_stream``,
# integer: ``ref.fir_mp_stream_q``, the kernel route of
# ``core.fixed.session_step_q``). The wrappers take these calls as they are.
fir_mp_stream = fir_mp_stream_cascade
fir_mp_stream_q = fir_mp_stream_cascade_q


# ---------------------------------------------------------------------------
# integer (fixed-point) wrappers
# ---------------------------------------------------------------------------


def fir_mp_bank_q(xq: torch.Tensor, H_q, *, gamma_q: int, iters: int,
                  qmin: int, qmax: int) -> torch.Tensor:
    """Integer bank FIR: xq (..., N) codes on the stage grid, H_q (F, M)
    tap codes -> (..., F, N) band codes, bit for bit
    ``core.fixed.fxp_fir_bank(pad=True)``."""
    x2 = xq.reshape(-1, xq.shape[-1])
    y = fir_mp_bank_q_kernel(x2, H_q, gamma_q=gamma_q, iters=iters,
                             qmin=qmin, qmax=qmax)
    return y.reshape(*xq.shape[:-1], y.shape[1], xq.shape[-1])


def fir_mp_bank_q_accumulate(xq: torch.Tensor, H_q, *, gamma_q: int,
                             iters: int, qmin: int, qmax: int
                             ) -> torch.Tensor:
    """Fused integer bank FIR + HWR + accumulate: xq (..., N) -> (..., F)
    sums at the stage grid (the caller applies ``acc_shift``)."""
    x2 = xq.reshape(-1, xq.shape[-1])
    s = fir_mp_bank_q_kernel(x2, H_q, gamma_q=gamma_q, iters=iters,
                             qmin=qmin, qmax=qmax, accumulate=True)
    return s.reshape(*xq.shape[:-1], s.shape[1])
