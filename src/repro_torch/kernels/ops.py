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
                                            mp_linear_bwd_kernel,
                                            mp_linear_grads_kernel,
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


class _MPLinear(torch.autograd.Function):
    """The kernel's product with the reference's custom VJP. On the card
    the forward, when x or w needs a gradient, is the levels-writing launch
    (y with the same bits, and the exact levels kept for the backward), and
    the backward launches only the grads pass (``mp_linear_grads_kernel``).
    On the CPU the backward is the reference's sort-based rule
    (``mp_linear_bwd_kernel``'s plain version), so that the CPU tests hold
    the autograd path against the reference's VJP. gamma and iters get no
    gradient."""

    @staticmethod
    def forward(ctx, x2, w, gamma, iters):
        ctx.gamma, ctx.iters = gamma, iters
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return mp_linear_kernel(x2, w, gamma, iters)
        if x2.is_cuda:
            y, lv = mp_linear_kernel(x2, w, gamma, iters, levels=True)
            ctx.save_for_backward(x2, w, lv)
        else:
            y = mp_linear_kernel(x2, w, gamma, iters)
            ctx.save_for_backward(x2, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w, *lv = ctx.saved_tensors
        if lv:
            dx, dw = mp_linear_grads_kernel(x2, w, g.float(), lv[0])
        else:
            dx, dw = mp_linear_bwd_kernel(x2, w, g.float(), ctx.gamma,
                                          ctx.iters)
        return dx, dw.to(w.dtype), None, None


def mp_linear(x: torch.Tensor, w: torch.Tensor, gamma, *,
              iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """Multiplierless (..., d) @ (d, O) through the fused kernel,
    differentiable in x and w (the reference's custom VJP: masks of the
    exact water levels, ``_MPLinear``). A w of a dtype the
    kernel does not read (``LINEAR_W_DTYPES``) is widened to float32
    first; a bf16 w gets its gradient rounded to bf16."""
    if w.dtype not in LINEAR_W_DTYPES:
        w = w.float()
    y = _MPLinear.apply(x.reshape(-1, x.shape[-1]), w, float(gamma),
                        int(iters))
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
