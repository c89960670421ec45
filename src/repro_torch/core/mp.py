"""Margin Propagation (MP) primitives in PyTorch.

``z = MP(L, gamma)`` solves the reverse water-filling constraint

    sum_i [L_i - z]_+  =  gamma,        gamma > 0

along the last axis. The solvers here are the counterparts of
``repro.core.mp``: the exact sort-based closed form, differentiable as a
``torch.autograd.Function`` with the reference's rule (dz/dL_i =
1{L_i > z} / |support|, dz/dgamma = -1/|support|; training runs through
it), the add/compare/halve bisection the hardware runs, and the monotone
Newton scheme the software hot path uses.

Every float reduction inside a fixed-iteration solver goes through
:func:`tree_sum`, an explicit adjacent-pair add tree. The streaming
parity contract (session step through the CUDA kernel == the torch-op
cascade, and single-chunk streaming == one-shot) rests on every path
adding the same operands in the same order; the CUDA kernels reproduce
this exact tree.
"""

from __future__ import annotations

import functools
import numbers

import torch
import torch.nn.functional as F

__all__ = [
    "tree_sum",
    "mp_exact",
    "mp_bisect",
    "mp_newton",
    "mpabs",
    "mpabs_newton",
    "mp_dot",
    "mp_conv1d",
    "mp_conv1d_bank",
    "mp_linear",
    "DEFAULT_BISECT_ITERS",
    "DEFAULT_NEWTON_ITERS",
    "device_scalar",
]

DEFAULT_BISECT_ITERS = 26  # |interval| * 2^-26 < 1e-7 * gamma: fp32-parity
DEFAULT_NEWTON_ITERS = 12  # monotone Newton: lands exactly on the root


def tree_sum(h: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a FIXED adjacent-pair tree.

    Zero-pad to a power of two, then add ``h[..., 0::2] + h[..., 1::2]``
    until one value is left. This is not the half-split tree GPU
    reductions usually use: adjacent pairs are what the reference adds,
    and bitwise parity between the paths depends on keeping it.
    """
    n = h.shape[-1]
    if n == 0:
        return h.new_zeros(h.shape[:-1])
    p = 1
    while p < n:
        p <<= 1
    if p != n:
        h = F.pad(h, (0, p - n))
    while h.shape[-1] > 1:
        h = h[..., 0::2] + h[..., 1::2]
    return h[..., 0]


@functools.lru_cache(maxsize=256)
def device_scalar(value, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A 0-d constant on ``device``, made once per (value, dtype, device)
    and shared (read-only): a step that uses it copies nothing from the
    host, so it can run inside a captured CUDA graph."""
    return torch.tensor(value, dtype=dtype, device=device)


def _gamma(gamma, like: torch.Tensor) -> torch.Tensor:
    if isinstance(gamma, numbers.Real) and not isinstance(gamma,
                                                          torch.Tensor):
        return device_scalar(float(gamma), like.dtype, like.device)
    return torch.as_tensor(gamma, dtype=like.dtype, device=like.device)


def _mp_exact_fwd(L: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    m = L.shape[-1]
    s = torch.sort(L, dim=-1, descending=True).values
    cs = torch.cumsum(s, dim=-1)
    k = torch.arange(1, m + 1, dtype=L.dtype, device=L.device)
    z_k = (cs - g[..., None]) / k
    k_star = torch.clamp((s > z_k).sum(-1), min=1)
    cs_sel = torch.gather(cs, -1, (k_star - 1)[..., None])[..., 0]
    return (cs_sel - g) / k_star.to(L.dtype)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed down to ``shape`` (the inverse of broadcasting)."""
    lead = t.ndim - len(shape)
    t = t.sum(dim=tuple(range(lead))) if lead > 0 else t
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dim=dims, keepdim=True) if dims else t


class _MPExact(torch.autograd.Function):
    """The reference's custom VJP (``repro.core.mp._mp_exact_bwd``): saves
    (L, z); dL = g 1{L > z} / k and dgamma = -g / k, k = max(|support|,
    1), dgamma summed down to gamma's shape."""

    @staticmethod
    def forward(ctx, L, g):
        z = _mp_exact_fwd(L, g)
        ctx.save_for_backward(L, z)
        ctx.gamma_shape = g.shape
        return z

    @staticmethod
    def backward(ctx, gz):
        L, z = ctx.saved_tensors
        support = (L > z[..., None]).to(L.dtype)
        k = torch.clamp_min(support.sum(-1), 1.0)
        dL = gz[..., None] * support / k[..., None]
        dgamma = None
        if ctx.needs_input_grad[1]:
            dgamma = _sum_to(-gz / k, ctx.gamma_shape)
        return dL, dgamma


def mp_exact(L: torch.Tensor, gamma) -> torch.Tensor:
    """Exact reverse water-filling along the last axis, differentiable in
    L and gamma.

    L: (..., m); gamma: scalar or broadcastable to (...,). Returns (...,).
    """
    return _MPExact.apply(L, _gamma(gamma, L))


def mp_bisect(L: torch.Tensor, gamma,
              iters: int = DEFAULT_BISECT_ITERS) -> torch.Tensor:
    """MP by bisection on ``[max L - gamma, max L]`` (add/compare/halve)."""
    g = _gamma(gamma, L)
    hi = L.amax(-1)
    lo = hi - g
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        h = tree_sum(torch.clamp_min(L - mid[..., None], 0))
        too_low = h > g
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return (lo + hi) * 0.5


def mp_newton(L: torch.Tensor, gamma,
              iters: int = DEFAULT_NEWTON_ITERS) -> torch.Tensor:
    """MP by monotone Newton from the left of the root:
    ``z += (h(z) - gamma) / k(z)``, k the count of operands above z."""
    g = _gamma(gamma, L)
    z = L.amax(-1) - g
    for _ in range(iters):
        zc = z[..., None]
        s = tree_sum(torch.clamp_min(L - zc, 0))
        k = (L > zc).sum(-1).to(L.dtype)  # integer count: exact
        z = z + (s - g) / torch.clamp_min(k, 1.0)
    return z


def mpabs_newton(u: torch.Tensor, gamma,
                 iters: int = DEFAULT_NEWTON_ITERS) -> torch.Tensor:
    """MP([u; -u], gamma) by monotone Newton, without the concatenation:
    the |u| branch plus the -|u| branch, each tree-summed."""
    g = _gamma(gamma, u)
    a = u.abs()
    z = a.amax(-1) - g
    for _ in range(iters):
        zc = z[..., None]
        s = (tree_sum(torch.clamp_min(a - zc, 0))
             + tree_sum(torch.clamp_min(-a - zc, 0)))
        k = ((a > zc).sum(-1) + (-a > zc).sum(-1)).to(u.dtype)
        z = z + (s - g) / torch.clamp_min(k, 1.0)
    return z


def mpabs(u: torch.Tensor, gamma, exact: bool = True,
          iters: int = DEFAULT_BISECT_ITERS) -> torch.Tensor:
    """MP([u; -u], gamma) along the last axis. ``exact=False`` bisects on
    the u and -u branches without materializing the concatenation."""
    if exact:
        return mp_exact(torch.cat([u, -u], dim=-1), gamma)
    g = _gamma(gamma, u)
    hi = u.abs().amax(-1)
    lo = hi - g
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        m = mid[..., None]
        h = (tree_sum(torch.clamp_min(u - m, 0))
             + tree_sum(torch.clamp_min(-u - m, 0)))
        too_low = h > g
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return (lo + hi) * 0.5


def mp_dot(x: torch.Tensor, w: torch.Tensor, gamma,
           exact: bool = True) -> torch.Tensor:
    """Multiplierless <x, w> (paper eq. 9): mpabs(w + x) - mpabs(w - x)."""
    return mpabs(w + x, gamma, exact=exact) - mpabs(w - x, gamma, exact=exact)


def mp_linear(x: torch.Tensor, w: torch.Tensor, gamma,
              b: torch.Tensor | None = None, exact: bool = True,
              block_out: int = 128) -> torch.Tensor:
    """Multiplierless (..., d) @ (d, O): y[..., o] = mpabs(w[:, o] + x)
    - mpabs(w[:, o] - x), eq. 9 per output.

    The pure path: blocks of ``block_out`` outputs bound the
    (..., block_out, d) operand tensor. ``exact`` picks the sort-based
    solver, else bisection; the CUDA kernel behind ``kernels.ops.mp_linear``
    is the production path.
    """
    d, out = w.shape
    if x.shape[-1] != d:
        raise ValueError(f"x (..., {x.shape[-1]}) does not match w "
                         f"{tuple(w.shape)}")

    def block(wb):  # (d, bo) -> (..., bo)
        u = wb.T + x[..., None, :]
        v = wb.T - x[..., None, :]
        return mpabs(u, gamma, exact=exact) - mpabs(v, gamma, exact=exact)

    y = torch.cat([block(w[:, o:o + block_out])
                   for o in range(0, out, block_out)], dim=-1)
    if b is not None:
        y = y + b
    return y


def _mp_dot_fast(x: torch.Tensor, w: torch.Tensor, gamma,
                 solver: str) -> torch.Tensor:
    """Fixed-iteration mp_dot for the feature-extraction hot path. The
    operand order (``w + x``, ``w - x``) is the reference's."""
    if solver == "newton":
        return mpabs_newton(w + x, gamma) - mpabs_newton(w - x, gamma)
    if solver == "bisect":
        return (mpabs(w + x, gamma, exact=False)
                - mpabs(w - x, gamma, exact=False))
    raise ValueError(f"unknown MP solver: {solver!r}")


def mp_conv1d(x: torch.Tensor, h: torch.Tensor, gamma, exact: bool = True,
              solver: str = "newton", pad: bool = True) -> torch.Tensor:
    """Multiplierless FIR: y(n) = MP-dot(h, x[n-M+1..n]).

    x (..., N), h (M,). ``pad=True`` left-pads with M-1 zeros so y has N
    positions (zeroed registers at start); ``pad=False`` computes only the
    valid positions, (..., N-M+1), window n = x[n..n+M-1]. Shared
    positions match bitwise.
    """
    M = h.shape[0]
    xp = F.pad(x, (M - 1, 0)) if pad else x
    win = xp.unfold(-1, M, 1)                      # (..., n_out, M)
    hr = h.flip(0)
    if exact:
        return mp_dot(win, hr, gamma, exact=True)
    return _mp_dot_fast(win, hr, gamma, solver)


def mp_conv1d_bank(x: torch.Tensor, H: torch.Tensor, gamma,
                   exact: bool = True, chunk_n: int | None = 1024,
                   solver: str = "newton", pad: bool = True) -> torch.Tensor:
    """Multi-filter MP FIR: x (..., N), H (F, M) -> y (..., F, n_out).

    Long signals are solved ``chunk_n`` output positions at a time to bound
    the (F, B, Q, M) operand tensor; each position's solve sees the same
    window whatever the chunking, so results match ``mp_conv1d`` per band.
    """
    Fn, M = H.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xp = F.pad(x2, (M - 1, 0)) if pad else x2
    n_out = xp.shape[-1] - M + 1
    hr = H.flip(-1).reshape(Fn, 1, 1, M)

    def solve(win):  # (B, Q, M) -> (F, B, Q)
        if exact:
            return mp_dot(win[None], hr, gamma, exact=True)
        return _mp_dot_fast(win[None], hr, gamma, solver)

    win = xp.unfold(-1, M, 1)                      # (B, n_out, M) view
    if chunk_n is None or n_out <= chunk_n:
        y = solve(win)
    else:
        y = torch.cat([solve(win[:, q:q + chunk_n])
                       for q in range(0, n_out, chunk_n)], dim=-1)
    return y.movedim(0, 1).reshape(*lead, Fn, n_out)
