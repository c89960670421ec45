"""Wrappers of the hand-written CUDA kernels for the MP solves.

* ``mp_linear_kernel`` — ``csrc/mp_linear.cu``, the fused multiplierless
  matrix product of eq. 9 (replaces the reference's Pallas
  ``mp_linear_pallas``);
* ``mp_linear_bwd_kernel`` — ``csrc/mp_linear_bwd.cu``, its gradients
  (replaces the reference's custom VJP ``_mp_linear_vjp_bwd``, jnp);
* ``mp_waterfill_kernel`` — ``csrc/mp_waterfill.cu``, row-wise reverse
  water-filling (replaces ``mp_waterfill_pallas``).

As for the FIR kernels: a CUDA tensor launches the kernel on the current
stream and counts the launch in ``kernels._wrap.LAUNCHES``; a CPU tensor
runs the plain version in ``kernels.ref``; anything else raises, and
nothing falls back from one to the other.
"""

from __future__ import annotations

import functools
import math
import types

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._wrap import (_check, _expect, _f32, _on_cuda,
                                       _stream, count_launch)

__all__ = ["LINEAR_W_DTYPES", "mp_linear_kernel", "mp_linear_bwd_kernel",
           "mp_linear_plan",
           "mp_waterfill_kernel", "mp_waterfill_plan"]

# the weight dtypes the mp_linear kernel reads as they are
LINEAR_W_DTYPES = (torch.float32, torch.bfloat16)
_TILE_WIDTHS = (0, 2, 4, 8)


def _linear_args(w_dtype: torch.dtype, tile_to: int) -> None:
    if w_dtype not in LINEAR_W_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w_dtype}")
    if tile_to not in _TILE_WIDTHS:
        raise ValueError(f"tile_to must be one of {_TILE_WIDTHS}, got "
                         f"{tile_to}")


def mp_linear_kernel(x: torch.Tensor, w: torch.Tensor, gamma,
                     iters: int = ref.DEFAULT_ITERS, *,
                     tile_to: int = 0) -> torch.Tensor:
    """x (B, d) float32, w (d, O) float32 or bfloat16 -> y (B, O) float32,
    y[b, o] = mpabs(x[b] + w[:, o]) - mpabs(x[b] - w[:, o]) by joint
    bisection. The kernel reads a bf16 w as it is and widens it exactly,
    so the result is that of ``w.float()``. ``tile_to`` 2, 4 or 8 runs it
    in a shared-memory tile of that many columns instead of the one it
    would pick (``mp_linear_plan``), to time or test each tile; the result
    is the same up to the sums' order."""
    _linear_args(w.dtype, tile_to)
    if not _on_cuda(x, w):
        return ref.mp_linear(x, w, gamma, iters)
    from repro_torch.kernels._build import load
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x must be (B, d) and w (d, O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, d = x.shape
    O = w.shape[1]
    _expect("w", w, (d, O))
    x, w = _f32(x, "x"), w.contiguous()
    y = torch.empty((B, O), dtype=torch.float32, device=x.device)
    code = load("mp_linear")(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, d,
                             O, int(w.dtype == torch.bfloat16), tile_to,
                             float(gamma), int(iters), _stream())
    _check(code, "mp_linear", f"B={B} d={d} O={O} tile_to={tile_to}")
    count_launch("mp_linear")
    return y


def mp_linear_bwd_kernel(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                         gamma, iters: int = ref.DEFAULT_ITERS) -> tuple:
    """The gradients of :func:`mp_linear_kernel`: x (B, d) float32, w (d,
    O) float32 or bfloat16, output gradient g (B, O) float32 -> (dx (B, d),
    dw (d, O)), float32, with the masks of the exact water levels (the
    reference's custom VJP). The kernel finds each level by ``iters``
    bisection steps, then solves it exactly on the support found; the
    plain version (``ref.mp_linear_bwd``) sorts."""
    _linear_args(w.dtype, 0)
    if not _on_cuda(x, w, g):
        return ref.mp_linear_bwd(x, w, g, gamma)
    dx, dw, _ = _mp_linear_bwd_launch(x, w, g, gamma, iters)
    return dx, dw


def _mp_linear_bwd_launch(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          gamma, iters: int = ref.DEFAULT_ITERS) -> tuple:
    """One launch of ``csrc/mp_linear_bwd.cu`` on CUDA tensors -> (dx, dw,
    lv): the levels of every (b, o) go through a (B, O, 4) float32 scratch
    tensor, [z_u, z_v, g / k_u, g / k_v] (``ref.mp_linear_levels``),
    returned as well for the checks that hold each pass apart."""
    from repro_torch.kernels._build import load
    _linear_args(w.dtype, 0)
    if not _on_cuda(x, w, g):
        raise ValueError("mp_linear_bwd: the launch takes CUDA tensors")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x must be (B, d) and w (d, O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, d = x.shape
    O = w.shape[1]
    _expect("w", w, (d, O))
    _expect("g", g, (B, O))
    x, w, g = _f32(x, "x"), w.contiguous(), _f32(g, "g")
    f32 = dict(dtype=torch.float32, device=x.device)
    lv = torch.empty((B, O, 4), **f32)
    dx = torch.empty((B, d), **f32)
    dw = torch.empty((d, O), **f32)
    code = load("mp_linear_bwd")(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), lv.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), B, d, O, int(w.dtype == torch.bfloat16),
        float(gamma), int(iters), _stream())
    _check(code, "mp_linear_bwd", f"B={B} d={d} O={O}")
    count_launch("mp_linear_bwd")
    return dx, dw, lv


def mp_linear_plan(B: int, d: int, O: int,
                   w_dtype: torch.dtype = torch.bfloat16, *,
                   tile_to: int = 0) -> dict:
    """The tile the CUDA kernel runs these shapes in on the current card:
    batch rows ``BB``, columns ``TO``, positions per CTA, the CTA count,
    whether the tiles are resident in shared memory, how many CTAs an SM
    holds at once (``per_sm``), and from those the ``waves`` of CTAs the
    card runs them in and the share of the last wave's slots they fill.
    ``fits`` is False (and the rest 0) where the ``tile_to`` asked for
    does not fit in shared memory. Needs the built library and a card."""
    import ctypes

    from repro_torch.kernels._build import load
    _linear_args(w_dtype, tile_to)
    out = (ctypes.c_int * 6)()
    code = load("mp_linear_plan")(B, d, O, int(w_dtype == torch.bfloat16),
                                  tile_to, ctypes.addressof(out))
    _check(code, "mp_linear_plan", f"B={B} d={d} O={O} tile_to={tile_to}")
    plan = dict(zip(("BB", "TO", "positions", "ctas", "resident", "per_sm"),
                    list(out)))
    plan["fits"] = plan["BB"] != 0
    slots = plan["per_sm"] * torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    waves = plan["ctas"] / slots if slots else 0.0
    plan["waves"] = waves
    plan["last_wave_fill"] = waves / math.ceil(waves) if waves else 0.0
    return plan


WATERFILL_LANE_ELEMENTS = 32   # most elements a lane holds in registers


@functools.lru_cache(maxsize=None)
def mp_waterfill_plan(m: int):
    """The waterfill kernel's layout for rows of m elements: ``group``
    lanes per row (G, a power of two) and ``per_lane`` elements in each
    lane's registers (K), so a CTA of 256 threads holds 256 / G rows.
    G = 1 and K = m rounded up to a power of two for m <= 32 (a row per
    thread, no shuffle in a step); K = 32 and G = m / 32 rounded up to a
    power of two for m <= 1024; above, G = 32 and K = 0: one warp per
    row, re-read from global memory each step. Cached, read-only."""
    if m < 1:
        raise ValueError(f"mp_waterfill: m = {m} must be at least 1")
    K = WATERFILL_LANE_ELEMENTS
    if m > 32 * K:
        plan = dict(group=32, per_lane=0)
    elif m > K:
        plan = dict(group=1 << (-(-m // K) - 1).bit_length(), per_lane=K)
    else:
        plan = dict(group=1, per_lane=1 << (m - 1).bit_length())
    return types.MappingProxyType(plan)


def mp_waterfill_kernel(L: torch.Tensor, gamma,
                        iters: int = ref.DEFAULT_ITERS) -> torch.Tensor:
    """L (R, m) -> z (R,) = MP(L, gamma) per row. The kernel bisects in
    float32 (a bfloat16 L is widened first) and z comes back in L's
    dtype."""
    if not _on_cuda(L):
        return ref.mp_waterfill(L, gamma, iters)
    from repro_torch.kernels._build import load
    if L.ndim != 2:
        raise ValueError(f"L must be (R, m), got {tuple(L.shape)}")
    R, m = L.shape
    Lf = L.float().contiguous()
    z = torch.empty((R,), dtype=torch.float32, device=L.device)
    plan = mp_waterfill_plan(m)
    code = load("mp_waterfill")(Lf.data_ptr(), z.data_ptr(), R, m,
                                float(gamma), int(iters), plan["group"],
                                plan["per_lane"], _stream())
    _check(code, "mp_waterfill", f"R={R} m={m}")
    count_launch("mp_waterfill")
    return z.to(L.dtype)
