"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes from torch ops: the float
ones with the same arithmetic in the same order, the integer ones
(``*_q``) with the same integer datapath, where any order gives the same
bits. The wrappers in ``kernels.fir_mp`` run these for CPU tensors; the
tests hold them against the reference's Pallas kernels (interpret mode),
and ``chip_smoke.py`` holds each CUDA kernel against its plain version on
the card. The integer versions are carrier-generic (int32, or float32
carrying integer codes), like ``core.fixed``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fixed as fx
from repro_torch.core import mp as mp_mod
from repro_torch.core.filterbank import accumulate_block_len

__all__ = ["BANK_TILE", "DEFAULT_ITERS", "fir_mp_bank",
           "fir_mp_bank_accumulate", "fir_mp", "fir_mp_accumulate",
           "fir_mp_oneshot_cascade",
           "fir_mp_stream_octave", "fir_mp_stream", "tile_sum",
           "fir_mp_bank_q", "fir_mp_bank_q_accumulate",
           "fir_mp_oneshot_cascade_q",
           "fir_mp_stream_octave_q", "fir_mp_stream_q", "mp_waterfill",
           "mp_linear", "mp_linear_bwd", "mp_exact_masks",
           "mp_linear_with_levels", "mp_linear_levels",
           "mp_linear_bwd_from_levels",
           "mp_linear_near_level", "slot_admit"]

DEFAULT_ITERS = 26   # bisection steps of the bank and MP solve kernels
BANK_TILE = 256      # positions per CTA of the bank kernel
LINEAR_BLOCK = 1 << 25   # mp_linear: elements of one (B, O_blk, d) operand
BANK_Q_BLOCK = 1 << 25   # fir_mp_bank_q: codes of one block's windows


def tile_sum(h: torch.Tensor, tile: int = BANK_TILE) -> torch.Tensor:
    """Sum over the last axis as the bank kernel adds it: an adjacent-pair
    tree per tile of ``tile`` positions (zero-padded), then the tile sums
    in ascending order."""
    n = h.shape[-1]
    nt = -(-n // tile)
    h = F.pad(h, (0, nt * tile - n))
    s = mp_mod.tree_sum(h.reshape(*h.shape[:-1], nt, tile))
    out = s[..., 0]
    for k in range(1, nt):
        out = out + s[..., k]
    return out


def fir_mp_bank(x: torch.Tensor, H: torch.Tensor, gamma,
                iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """x (B, N), H (F, M) -> y (B, F, N): the bank kernel's bisection.

    Shift k of the row (zero left fill) pairs with tap k: u = x + h,
    v = x - h; both states bisect on [max|.| - gamma, max|.|] with the
    constraint summed sequentially over k (``hu + max(u - mid, 0) +
    max(-u - mid, 0)``), and y = (lo_u + hi_u)/2 - (lo_v + hi_v)/2.
    """
    Fn, M = H.shape
    N = x.shape[-1]
    g = torch.as_tensor(gamma, dtype=x.dtype, device=x.device)
    xp = F.pad(x, (M - 1, 0))
    xs = [xp[:, None, M - 1 - k:M - 1 - k + N] for k in range(M)]  # x[n-k]
    hk = [H[None, :, k, None] for k in range(M)]                    # (1,F,1)
    hi_u = (xs[0] + hk[0]).abs()
    hi_v = (xs[0] - hk[0]).abs()
    for k in range(1, M):
        hi_u = torch.maximum(hi_u, (xs[k] + hk[k]).abs())
        hi_v = torch.maximum(hi_v, (xs[k] - hk[k]).abs())
    lo_u, lo_v = hi_u - g, hi_v - g
    for _ in range(iters):
        mid_u = (lo_u + hi_u) * 0.5
        mid_v = (lo_v + hi_v) * 0.5
        hu = torch.zeros_like(mid_u)
        hv = torch.zeros_like(mid_v)
        for k in range(M):
            u = xs[k] + hk[k]
            v = xs[k] - hk[k]
            hu = hu + torch.clamp_min(u - mid_u, 0) + torch.clamp_min(-u - mid_u, 0)
            hv = hv + torch.clamp_min(v - mid_v, 0) + torch.clamp_min(-v - mid_v, 0)
        tu, tv = hu > g, hv > g
        lo_u = torch.where(tu, mid_u, lo_u)
        hi_u = torch.where(tu, hi_u, mid_u)
        lo_v = torch.where(tv, mid_v, lo_v)
        hi_v = torch.where(tv, hi_v, mid_v)
    return (lo_u + hi_u) * 0.5 - (lo_v + hi_v) * 0.5


def fir_mp_bank_accumulate(x: torch.Tensor, H: torch.Tensor, gamma,
                           iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """x (B, N), H (F, M) -> s (B, F) = sum_n max(y, 0) in the kernel's
    per-tile tree order."""
    return tile_sum(torch.clamp_min(fir_mp_bank(x, H, gamma, iters), 0))


def fir_mp(x: torch.Tensor, h: torch.Tensor, gamma,
           iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """x (B, N), h (M,) -> y (B, N): the bank with one filter."""
    return fir_mp_bank(x, h[None], gamma, iters)[:, 0]


def fir_mp_accumulate(x: torch.Tensor, h: torch.Tensor, gamma,
                      iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """x (B, N), h (M,) -> s (B,)."""
    return fir_mp_bank_accumulate(x, h[None], gamma, iters)[:, 0]


def fir_mp_oneshot_cascade(x: torch.Tensor, bp_taps, lp_taps, gamma,
                           iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """The float one-shot bank's multirate cascade, the plain version of the
    cascade kernel: x (B, N), ``bp_taps[o]`` (F, M) per octave,
    ``lp_taps[o]`` (M_lp,) for every octave but the last -> s (B, O F).
    Octave o adds its HWR sums times 2^o (:func:`fir_mp_bank_accumulate`)
    and hands the even positions of its low-pass (:func:`fir_mp`) on."""
    parts = []
    x_o = x
    for o, H in enumerate(bp_taps):
        parts.append(fir_mp_bank_accumulate(x_o, H, gamma, iters) * (2.0 ** o))
        if o < len(bp_taps) - 1:
            x_o = fir_mp(x_o, lp_taps[o], gamma, iters)[..., ::2]
    return torch.cat(parts, dim=-1)


def fir_mp_stream_octave(x, n, start, delay, acc, amax, H, lp, gamma, *,
                         scale: float = 1.0, solver: str = "newton",
                         emit_next: bool = True, update_amax: bool = False):
    """One octave of the stateful session step, as the stream kernel runs
    it: blocks of LB = accumulate_block_len(L) positions in ascending
    order, all slots at once.

    x (S, L) chunk; n (S,) valid counts; start (S,) ÷2 phases; delay
    (S, T1); acc (S, F); amax (S,); H (F, M); lp (M_lp,). Returns
    ``(acc', delay', amax', y_next | None)``, y_next (S, NB * LB // 2).
    """
    S, L = x.shape
    Fn, M = H.shape
    T1 = delay.shape[1]
    M_lp = lp.shape[0]
    LB = accumulate_block_len(L)
    NB = -(-L // LB)
    xp = F.pad(x, (0, NB * LB - L))
    n = n.long()
    start = start.long()
    dev = x.device
    rows = torch.arange(S, device=dev)[:, None]
    w_bp = H.flip(-1).reshape(1, Fn, 1, M)
    w_lp = lp.flip(0)
    widx = (2 * torch.arange(LB // 2, device=dev)[:, None]
            + torch.arange(M_lp, device=dev)[None, :])      # (LB/2, M_lp)
    tail = torch.arange(T1, device=dev)[None, :]
    pos_in = torch.arange(LB, device=dev)
    part = x.new_zeros(S, Fn)
    y_next = []
    for b in range(NB):
        blk = xp[:, b * LB:(b + 1) * LB]
        if update_amax:
            amax = torch.maximum(amax, blk.abs().amax(-1))
        bufv = torch.cat([delay[:, T1 - (M - 1):], blk], dim=1)
        win = bufv.unfold(-1, M, 1)[:, None]                # (S, 1, LB, M)
        y = mp_mod._mp_dot_fast(win, w_bp, gamma, solver)  # (S, F, LB)
        pos = b * LB + pos_in
        hwr = torch.where(pos < n[:, None, None], torch.clamp_min(y, 0), 0.0)
        part = part + mp_mod.tree_sum(hwr)
        if emit_next:
            bufl = torch.cat([delay[:, T1 - (M_lp - 1):], blk], dim=1)
            winl = bufl[rows[:, :, None], start[:, None, None] + widx[None]]
            y_next.append(mp_mod._mp_dot_fast(winl, w_lp, gamma, solver))
        v = torch.clamp(n - b * LB, 0, LB)
        bufd = torch.cat([delay, blk], dim=1)
        delay = bufd[rows, v[:, None] + tail]
    acc = acc + part * scale
    return acc, delay, amax, (torch.cat(y_next, dim=1) if emit_next else None)


def fir_mp_stream(chunk, n, delays, consumed, acc, amax, bp_taps, lp_taps,
                  gamma, *, solver: str = "newton", update_amax: bool = True):
    """The float session step's octave cascade, octave by octave through
    :func:`fir_mp_stream_octave`: the plain version of the cascade kernel.

    Per octave the decimator phase is ``consumed % 2``, the next octave's
    valid count ``max(0, (n - start + 1) // 2)`` and its signal
    ``y_next[:, :(L + 1) // 2]``; octave o adds its partials times 2^o to
    its accumulator columns ``acc[:, o * F:(o + 1) * F]``. Returns
    ``(delays', consumed', acc', amax')``; amax comes back as given
    without ``update_amax``; a slot with n == 0 gets its registers back
    bit for bit.
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
# integer (fixed-point) kernels
# ---------------------------------------------------------------------------


class _Bounds(NamedTuple):
    """A clamp range given directly (``core.fixed`` reads only these)."""
    qmin: int
    qmax: int


def fir_mp_bank_q(xq: torch.Tensor, H_q, gamma_q: int, iters: int,
                  qmin: int, qmax: int) -> torch.Tensor:
    """xq (B, N) codes on the stage grid, H_q (F, M) tap codes -> (B, F, N)
    band codes: position n pairs x[n - k] (zero left fill) with tap k,
    operands ``clip(h_k +- x[n - k], qmin, qmax)``, and
    ``mpabs(u) - mpabs(v)`` by integer bisection (``gamma_q``, ``iters``;
    the result is ``hi``). Solved in blocks of positions whose windows
    hold about ``BANK_Q_BLOCK`` codes (at least 1024 positions): every
    window solve is independent, so the blocks set memory and the number
    of torch calls, not values."""
    Fn, M = H_q.shape
    rows = max(1, xq.numel() // max(1, xq.shape[-1]))
    return fx.fxp_fir_bank(xq, H_q, gamma_q, iters, _Bounds(qmin, qmax),
                           chunk_n=max(1024, BANK_Q_BLOCK // (rows * Fn * M)))


def fir_mp_bank_q_accumulate(xq: torch.Tensor, H_q, gamma_q: int,
                             iters: int, qmin: int, qmax: int
                             ) -> torch.Tensor:
    """(B, F) = sum over the N positions of max(y, 0), y the
    :func:`fir_mp_bank_q` codes, in the carrier's dtype."""
    return fx.fxp_hwr_accumulate(
        fir_mp_bank_q(xq, H_q, gamma_q, iters, qmin, qmax))


def fir_mp_oneshot_cascade_q(bank, xq: torch.Tensor) -> torch.Tensor:
    """The integer one-shot bank's multirate cascade, the plain version of
    the int cascade kernel (and of ``core.fixed.bank_accumulate_q`` in MP
    mode): ``bank`` a compiled ``core.fixed.FixedBankProgram``, xq (B, N)
    ADC codes -> the accumulators (B, O F). Octave o adds
    ``shift_left(sums, acc_shift)`` of its band-pass on ``rescale(x_o,
    sig_shift)`` (:func:`fir_mp_bank_q_accumulate`) and hands on the even
    positions of ``clamp(rescale(y_lp, lp_out_shift), next in_spec)``, its
    low-pass (:func:`fir_mp_bank_q`) solved on ``rescale(x_o,
    lp_sig_shift)`` at every position."""
    octaves = bank.octaves
    parts = []
    x_o = xq
    for o, st in enumerate(octaves):
        s = fir_mp_bank_q_accumulate(
            fx.rescale(x_o, st.sig_shift), st.bp_q, st.gamma_bp, st.iters_bp,
            st.band_spec.qmin, st.band_spec.qmax)
        parts.append(fx.shift_left(s, st.acc_shift))
        if st.lp_q is not None:
            y_lp = fir_mp_bank_q(fx.rescale(x_o, st.lp_sig_shift), st.lp_q,
                                 st.gamma_lp, st.iters_lp, st.lp_spec.qmin,
                                 st.lp_spec.qmax)[:, 0]
            x_o = fx._clamp(fx.rescale(y_lp, st.lp_out_shift),
                            octaves[o + 1].in_spec)[:, ::2]
    return torch.cat(parts, dim=-1)


def fir_mp_stream_octave_q(x, n, start, delay, acc, amax, *, stage,
                           next_spec=None, emit_next: bool = True,
                           update_amax: bool = False):
    """One octave of the integer session step, as the int stream kernel
    runs it: blocks of LB = accumulate_block_len(L) positions in order,
    all slots at once.

    x (S, L) this octave's register codes; n (S,) valid counts; start (S,)
    ÷2 phases; delay (S, T1) delay-line codes; acc (S, F) accumulators;
    amax (S,) running max |code| (updated only under ``update_amax``);
    ``stage`` a compiled ``core.fixed.OctaveStage``; ``next_spec`` the next
    octave's register spec (with ``emit_next``).

    Per block: windows of [delay | block] rescaled by ``sig_shift``, one
    ``fxp_mp_dot`` per position and band, max(y, 0) of the valid positions
    added to the partials; the low-pass solved at the kept positions
    ``start + 2j`` and emitted as ``clamp(rescale(kept, lp_out_shift),
    next_qmin, next_qmax)``; the delay line slid by the block's valid
    count (so past a slot's valid count a later block's windows see that
    slot's last valid samples, as on the TPU). At the end ``acc + (part <<
    acc_shift)``. Returns ``(acc', delay', amax', y_next | None)``,
    y_next (S, (L + 1) // 2).
    """
    S, L = x.shape
    T1 = delay.shape[1]
    dev = x.device
    bp = np.asarray(stage.bp_q)
    M = bp.shape[-1]
    LB = accumulate_block_len(L)
    NB = -(-L // LB)
    xp = F.pad(x, (0, NB * LB - L))
    n = n.long()
    rows = torch.arange(S, device=dev)[:, None]
    tail = torch.arange(T1, device=dev)[None, :]
    pos_in = torch.arange(LB, device=dev)
    w_bp = fx._c(np.ascontiguousarray(bp[:, ::-1]), x)[None, :, None]
    if emit_next:
        lp = np.asarray(stage.lp_q)[0]
        M_lp = lp.shape[0]
        w_lp = fx._c(lp[::-1].copy(), x)
        widx = (2 * torch.arange(LB // 2, device=dev)[:, None]
                + torch.arange(M_lp, device=dev)[None, :])   # (LB/2, M_lp)
    part = x.new_zeros(S, bp.shape[0])
    y_next = []
    for b in range(NB):
        blk = xp[:, b * LB:(b + 1) * LB]
        if update_amax:
            amax = torch.maximum(amax, blk.abs().amax(-1))
        bufv = torch.cat([delay[:, T1 - (M - 1):], blk], dim=1)
        win = fx.rescale(bufv.unfold(-1, M, 1)[:, None], stage.sig_shift)
        y = fx.fxp_mp_dot(win, w_bp, stage.gamma_bp, stage.iters_bp,
                          stage.band_spec)                # (S, F, LB)
        part = part + fx.fxp_hwr_accumulate(y, (n - b * LB)[:, None])
        if emit_next:
            bufl = torch.cat([delay[:, T1 - (M_lp - 1):], blk], dim=1)
            winl = fx.rescale(bufl[rows[:, :, None], start.long()[:, None, None]
                                   + widx[None]], stage.lp_sig_shift)
            kept = fx.fxp_mp_dot(winl, w_lp, stage.gamma_lp, stage.iters_lp,
                                 stage.lp_spec)
            y_next.append(torch.clamp(fx.rescale(kept, stage.lp_out_shift),
                                      next_spec.qmin, next_spec.qmax))
        v = torch.clamp(n - b * LB, 0, LB)
        delay = torch.cat([delay, blk], dim=1)[rows, v[:, None] + tail]
    acc = acc + fx.shift_left(part, stage.acc_shift)
    if emit_next:
        y_next = torch.cat(y_next, dim=1)[:, :(L + 1) // 2]
    return acc, delay, amax, (y_next if emit_next else None)


def fir_mp_stream_q(prog, chunk_q, n, delays, consumed, acc, amax):
    """The integer session step's octave cascade, octave by octave through
    :func:`fir_mp_stream_octave_q`: the plain version of the int cascade
    kernel (and the kernel route of ``core.fixed.session_step_q``'s
    cascade, with the same registers).

    ``prog`` the compiled ``core.fixed.FixedPointProgram``; chunk_q (S, L)
    ADC codes with invalid tails zeroed, L >= 1; n (S,) effective valid
    counts. Per octave the decimator phase is ``consumed & 1`` and the next
    valid count ``max(n - start + 1, 0) >> 1``. Returns ``(delays',
    consumed', acc', amax')``.
    """
    bank = prog.bank
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


# ---------------------------------------------------------------------------
# the MP solve kernels: mp_waterfill and mp_linear
# ---------------------------------------------------------------------------


def mp_waterfill(L: torch.Tensor, gamma,
                 iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """L (R, m) -> z (R,) = MP(L, gamma) per row, by the kernel's
    bisection: ``hi = max L``, ``lo = hi - gamma``, ``iters`` halvings on
    ``sum [L - mid]_+ > gamma``. Solved in float32 whatever L's dtype (the
    kernel too); the result comes back in L's dtype."""
    Lf = L.float()
    hi = Lf.amax(-1)
    lo = hi - gamma
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        too_low = torch.clamp_min(Lf - mid[:, None], 0).sum(-1) > gamma
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return ((lo + hi) * 0.5).to(L.dtype)


def _mpabs_bracket(u: torch.Tensor, gamma, iters: int) -> tuple:
    """The bracket (lo, hi) of MP([u; -u], gamma) over the last axis as the
    mp_linear kernel leaves it: ``hi = max |u|``, ``lo = hi - gamma``, then
    ``iters`` steps of the two-sided hinge sum."""
    nu = -u
    hi = u.abs().amax(-1)
    lo = hi - gamma
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        m = mid[..., None]
        h = (torch.clamp_min(u - m, 0).sum(-1)
             + torch.clamp_min(nu - m, 0).sum(-1))
        too_low = h > gamma
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return lo, hi


def _mpabs_bisect(u: torch.Tensor, gamma, iters: int) -> torch.Tensor:
    """MP([u; -u], gamma) over the last axis as the mp_linear kernel
    solves it: the midpoint of :func:`_mpabs_bracket`."""
    lo, hi = _mpabs_bracket(u, gamma, iters)
    return (lo + hi) * 0.5


def mp_linear(x: torch.Tensor, w: torch.Tensor, gamma,
              iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """x (B, d), w (d, O) -> y (B, O), y[b, o] = z_u - z_v with
    u = x[b] + w[:, o], v = x[b] - w[:, o], each z by the kernel's joint
    bisection. Blocked over O so the (B, O_blk, d) operands stay within
    ``LINEAR_BLOCK`` elements (the head's O = 152,064 included). A bf16 w
    is widened to float32 first (exact), as the kernel widens it."""
    return _mp_linear(x, w, gamma, iters, levels=False)[0]


EXACT_ROUNDS = 16   # the levels' Newton rounds at most, as the kernel's cap


def _exact_from(t: torch.Tensor, zc: torch.Tensor, gamma) -> tuple:
    """(z, k): the exact level z of [t; -t] over the last axis and the
    count k of its operands above z, by Newton from zc (left of the root)
    as the mp_linear kernel runs it: the count n and sum s of the operands
    above zc, z = (s - gamma) / max(n, 1), a recount at z; while a count
    moved, the sum at z and again (``EXACT_ROUNDS`` at most). A level
    whose count stood already takes the same z again."""
    def above(z):
        zz = z[..., None]
        return t > zz, -t > zz

    pos, neg = above(zc)
    n = (pos.sum(-1) + neg.sum(-1)).float()
    s = torch.where(pos, t, 0.0).sum(-1) + torch.where(neg, -t, 0.0).sum(-1)
    for r in range(1, EXACT_ROUNDS + 1):
        z = (s - gamma) / torch.clamp_min(n, 1.0)
        k = n
        pos, neg = above(z)
        n2 = (pos.sum(-1) + neg.sum(-1)).float()
        if bool((n2 == n).all()) or r == EXACT_ROUNDS:
            return z, k
        n = n2
        s = (torch.where(pos, t, 0.0).sum(-1)
             + torch.where(neg, -t, 0.0).sum(-1))


def mp_linear_with_levels(x: torch.Tensor, w: torch.Tensor, gamma,
                          iters: int = DEFAULT_ITERS) -> tuple:
    """(y, lv): :func:`mp_linear`'s y, and what the kernel's training
    forward writes beside it, lv (B, O, 4) float32 = [z_u, z_v, 1 / k_u,
    1 / k_v] per (b, o), each z the exact level of [t; -t] by Newton from
    the left end of the bisection's bracket (:func:`_exact_from`) and k
    the count of its operands above z (at least 1)."""
    return _mp_linear(x, w, gamma, iters, levels=True)


def _mp_linear(x: torch.Tensor, w: torch.Tensor, gamma, iters: int,
               levels: bool) -> tuple:
    """(y, lv or None), blocked over O as :func:`mp_linear` describes."""
    if w.dtype == torch.bfloat16:
        w = w.float()
    B, d = x.shape
    O = w.shape[1]
    ob = max(1, min(O, LINEAR_BLOCK // max(1, B * d)))
    ys = []
    lv = (torch.empty((B, O, 4), dtype=torch.float32, device=x.device)
          if levels else None)
    for o in range(0, O, ob):
        wb = w[:, o:o + ob].T[None]                    # (1, ob, d)
        xb = x[:, None, :]
        zs = []
        for j, t in enumerate((xb + wb, xb - wb)):
            lo, hi = _mpabs_bracket(t, gamma, iters)
            zs.append((lo + hi) * 0.5)
            if levels:
                z, k = _exact_from(t, lo, gamma)
                lv[:, o:o + ob, j] = z
                lv[:, o:o + ob, 2 + j] = 1.0 / torch.clamp_min(k, 1.0)
        ys.append(zs[0] - zs[1])
    return torch.cat(ys, dim=-1), lv


def mp_exact_masks(t: torch.Tensor, gamma) -> torch.Tensor:
    """dz/dt for z = MP([t; -t], gamma) over the last axis, z by the exact
    sort-based solve (``core.mp.mp_exact``): (1{t > z} - 1{-t > z}) / k,
    k = max(#{operands of [t; -t] above z}, 1)."""
    z = mp_mod.mp_exact(torch.cat([t, -t], dim=-1), gamma)[..., None]
    s_pos = (t > z).to(t.dtype)
    s_neg = (-t > z).to(t.dtype)
    k = torch.clamp_min((s_pos + s_neg).sum(-1, keepdim=True), 1.0)
    return (s_pos - s_neg) / k


def mp_linear_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                  gamma) -> tuple:
    """The gradients of ``mp_linear`` (the reference's custom VJP,
    ``_mp_linear_vjp_bwd``): x (B, d), w (d, O), output gradient g (B, O)
    -> (dx (B, d), dw (d, O)), float32, with m_u, m_v the masks of
    :func:`mp_exact_masks` for u = x[b] + w[:, o] and v = x[b] - w[:, o]:
    dx = sum_o g (m_u - m_v), dw = sum_b g (m_u + m_v). Blocked over O,
    and over B where one row's block is already too large, so the
    (B_blk, O_blk, d) operands stay within ``LINEAR_BLOCK`` elements. A
    bf16 w is widened to float32 first (exact). gamma gets no gradient,
    as in the reference."""
    if w.dtype == torch.bfloat16:
        w = w.float()
    B, d = x.shape
    O = w.shape[1]
    dx = torch.zeros_like(x)
    dw = torch.zeros_like(w)
    for rs, os_ in _blocks(B, d, O):
        xb, wb = x[rs, None, :], w[:, os_].T[None]     # (rb, 1, d), (1, ob, d)
        du = mp_exact_masks(xb + wb, gamma)
        dv = mp_exact_masks(xb - wb, gamma)
        gy = g[rs, os_, None]
        dx[rs] += (gy * (du - dv)).sum(1)
        dw[:, os_] += (gy * (du + dv)).sum(0).T
    return dx, dw


def _blocks(B: int, d: int, O: int):
    """(row, column) slices of at most ``LINEAR_BLOCK`` (b, o, i) operands."""
    rb = max(1, min(B, LINEAR_BLOCK // max(1, d)))
    ob = max(1, min(O, LINEAR_BLOCK // max(1, rb * d)))
    for r in range(0, B, rb):
        for o in range(0, O, ob):
            yield slice(r, r + rb), slice(o, o + ob)


def mp_linear_levels(x: torch.Tensor, w: torch.Tensor, gamma) -> torch.Tensor:
    """The levels of :func:`mp_linear_with_levels` by the sort-based solve:
    (B, O, 4) float32, [z_u, z_v, 1 / k_u, 1 / k_v] per (b, o), z_t the
    exact level of [t; -t] (``core.mp.mp_exact``) and k_t the count of its
    operands above z_t (at least 1)."""
    if w.dtype == torch.bfloat16:
        w = w.float()
    B, d = x.shape
    O = w.shape[1]
    out = torch.empty((B, O, 4), dtype=torch.float32, device=x.device)
    for rs, os_ in _blocks(B, d, O):
        xb, wb = x[rs, None, :], w[:, os_].T[None]
        for j, t in enumerate((xb + wb, xb - wb)):
            z = mp_mod.mp_exact(torch.cat([t, -t], dim=-1), gamma)
            k = ((t > z[..., None]).sum(-1) + (-t > z[..., None]).sum(-1))
            out[rs, os_, j] = z
            out[rs, os_, 2 + j] = 1.0 / torch.clamp_min(k.float(), 1.0)
    return out


def mp_linear_bwd_from_levels(x: torch.Tensor, w: torch.Tensor,
                              g: torch.Tensor, lv: torch.Tensor) -> tuple:
    """The backward kernel's grads pass on given levels ``lv`` (B, O, 4)
    (:func:`mp_linear_with_levels`, :func:`mp_linear_levels`, or the
    kernel's own) and the output gradient g (B, O): with g_t = g * (1 /
    k_t) and the sign masks s_t = 1{t > z_t} - 1{-t > z_t}, dx = sum_o
    (g_u s_u - g_v s_v) and dw = sum_b (g_u s_u + g_v s_v)."""
    if w.dtype == torch.bfloat16:
        w = w.float()
    B, d = x.shape
    O = w.shape[1]
    dx = torch.zeros_like(x)
    dw = torch.zeros_like(w)

    def sign(t, z):
        return (t > z).float() - (-t > z).float()

    for rs, os_ in _blocks(B, d, O):
        xb, wb = x[rs, None, :], w[:, os_].T[None]
        l = lv[rs, os_, :, None]
        gy = g[rs, os_, None]
        cu = (gy * l[..., 2, :]) * sign(xb + wb, l[..., 0, :])
        cv = (gy * l[..., 3, :]) * sign(xb - wb, l[..., 1, :])
        dx[rs] += (cu - cv).sum(1)
        dw[:, os_] += (cu + cv).sum(0).T
    return dx, dw


def mp_linear_near_level(x: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                         tol: float) -> torch.Tensor:
    """(B, O, 2) bool: the (b, o) branches (u, v) with an operand of [t; -t]
    within ``tol`` x (1 + |z|) of its level z (``z``: (B, O, 2)), where two
    solves summing in other orders may put it on either side. For the
    checks that hold the backward kernel's levels against the sort."""
    if w.dtype == torch.bfloat16:
        w = w.float()
    B, d = x.shape
    O = w.shape[1]
    out = torch.empty((B, O, 2), dtype=torch.bool, device=x.device)
    for rs, os_ in _blocks(B, d, O):
        xb, wb = x[rs, None, :], w[:, os_].T[None]
        for j, t in enumerate((xb + wb, xb - wb)):
            zj = z[rs, os_, j, None]
            gap = torch.minimum((t - zj).abs(), (-t - zj).abs()).amin(-1)
            out[rs, os_, j] = gap <= tol * (1.0 + zj[..., 0].abs())
    return out


# ---------------------------------------------------------------------------
# the serving tier's slot admissions
# ---------------------------------------------------------------------------


def slot_admit(regs, active: torch.Tensor, codes: torch.Tensor) -> None:
    """The admission codes' writes, IN PLACE, as the server's eager slot
    writes made them: the rows of the slots whose code has the reset bit
    (``codes & 2``) zeroed in every register of ``regs`` (each (S, ...)),
    then ``active`` (S,) set to ``not (code & 1)`` wherever a code is
    given (1: close, 2: open, 3: an open and a close)."""
    reset = torch.nonzero(codes & 2).flatten()
    for t in regs:
        t[reset] = 0
    given = codes != 0
    for value, pick in ((True, given & (codes & 1 == 0)),
                        (False, codes & 1 == 1)):
        active[torch.nonzero(pick).flatten()] = value
