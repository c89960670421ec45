"""Public wrappers around the port's kernels: leading batch dims, layouts,
and the per-octave cascade of the session step.

Every function here reaches a kernel wrapper in ``kernels.fir_mp`` or
``kernels.mp_kernels``, which launches the CUDA kernel for CUDA tensors
and runs the plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fir_mp import (fir_mp_bank_kernel,
                                         fir_mp_bank_q_kernel, fir_mp_kernel,
                                         fir_mp_stream_octave,
                                         fir_mp_stream_octave_q)
from repro_torch.kernels.mp_kernels import (LINEAR_W_DTYPES,
                                            mp_linear_kernel,
                                            mp_waterfill_kernel)
from repro_torch.kernels.ref import DEFAULT_ITERS

__all__ = ["mp_waterfill", "mp_linear", "fir_mp", "fir_mp_accumulate",
           "fir_mp_bank", "fir_mp_bank_accumulate", "fir_mp_stream",
           "fir_mp_bank_q", "fir_mp_bank_q_accumulate", "fir_mp_stream_q"]


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


def fir_mp_stream(chunk: torch.Tensor, n: torch.Tensor, delays: tuple,
                  consumed: tuple, acc: torch.Tensor, amax: torch.Tensor,
                  bp_taps: tuple, lp_taps: tuple, gamma, *,
                  solver: str = "newton", update_amax: bool = True):
    """The multirate session step through the stream kernel, one launch
    per octave.

    chunk (S, L), invalid tails zeroed (and quantized, if deployed
    quantized — then pass the already-updated running amax and
    ``update_amax=False``; otherwise the octave-0 kernel updates amax
    itself). n (S,) valid counts (0 for inert slots); ``delays`` /
    ``consumed`` per-octave registers; acc (S, P); ``bp_taps[o]`` (F, M),
    ``lp_taps[o]`` (M_lp,).

    Per octave: the decimator phase is ``consumed % 2``, the next octave's
    valid count ``max(0, (n - start + 1) // 2)`` and its signal
    ``y_next[:, :(L + 1) // 2]``. Returns ``(delays', consumed', acc',
    amax')``; a slot with n == 0 gets its registers back bit for bit.
    """
    num_octaves = len(delays)
    S, L = chunk.shape
    F = bp_taps[0].shape[0]
    x_o = chunk
    n_o = n.to(torch.int32)
    l_o = L
    new_delays, new_consumed, acc_cols = [], [], []
    amax_out = amax
    for o in range(num_octaves):
        start_o = torch.remainder(consumed[o], 2).to(torch.int32)
        emit = o < num_octaves - 1
        lp = lp_taps[o] if emit else chunk.new_zeros(1)
        acc_o = acc[:, o * F:(o + 1) * F]
        amax_in = amax if o == 0 else chunk.new_zeros(S)
        acc_new, delay_new, amax_new, y_next = fir_mp_stream_octave(
            x_o, n_o, start_o, delays[o], acc_o, amax_in, bp_taps[o], lp,
            gamma, scale=2.0 ** o, solver=solver, emit_next=emit,
            update_amax=(update_amax and o == 0))
        if o == 0 and update_amax:
            amax_out = amax_new
        new_delays.append(delay_new)
        new_consumed.append(consumed[o] + n_o)
        acc_cols.append(acc_new)
        if emit:
            l_next = (l_o + 1) // 2
            x_o = y_next[:, :l_next]
            n_o = torch.clamp_min(
                torch.div(n_o - start_o + 1, 2, rounding_mode="floor"), 0)
            l_o = l_next
    return (tuple(new_delays), tuple(new_consumed),
            torch.cat(acc_cols, dim=1), amax_out)


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


def fir_mp_stream_q(prog, chunk_q: torch.Tensor, n: torch.Tensor,
                    delays: tuple, consumed: tuple, acc: torch.Tensor,
                    amax: torch.Tensor):
    """The integer session step's octave cascade through the int stream
    kernel, one launch per octave: the kernel route of
    ``core.fixed.session_step_q``, with the same registers.

    ``prog`` is the compiled ``core.fixed.FixedPointProgram``; chunk_q
    (S, L) ADC codes with invalid tails zeroed, L >= 1 (the caller handles
    the L == 0 readout); n (S,) effective valid counts; the registers as in
    ``SessionState``. Per octave the decimator phase is ``consumed & 1``
    and the next valid count ``max(n - start + 1, 0) >> 1``. Returns
    ``(delays', consumed', acc', amax')``.
    """
    bank = prog.bank
    if bank.mode != "mp":
        raise ValueError(
            f"fir_mp_stream_q runs the MP stream kernel; it has no "
            f"{bank.mode!r}-mode variant (use fixed.session_step_q)")
    x_o = chunk_q
    n_o = n.to(torch.int32)
    new_delays, new_consumed, acc_cols = [], [], []
    amax_out = amax
    col = 0
    for o, st in enumerate(bank.octaves):
        Fn = st.bp_q.shape[0]
        emit = st.lp_q is not None
        start_o = torch.bitwise_and(consumed[o], 1).to(torch.int32)
        acc_new, delay_new, amax_new, y_next = fir_mp_stream_octave_q(
            x_o, n_o, start_o, delays[o], acc[:, col:col + Fn],
            amax if o == 0 else torch.zeros_like(amax), stage=st,
            next_spec=bank.octaves[o + 1].in_spec if emit else None,
            emit_next=emit, update_amax=(o == 0))
        if o == 0:
            amax_out = amax_new
        new_delays.append(delay_new)
        new_consumed.append(consumed[o] + n_o)
        acc_cols.append(acc_new)
        col += Fn
        if emit:
            x_o = y_next
            n_o = torch.bitwise_right_shift(
                torch.clamp_min(n_o - start_o + 1, 0), 1)
    return (tuple(new_delays), tuple(new_consumed),
            torch.cat(acc_cols, dim=1), amax_out)
