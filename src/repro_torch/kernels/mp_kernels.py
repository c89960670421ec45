"""Wrappers of the hand-written CUDA kernels for the MP solves.

* ``mp_linear_kernel`` — ``csrc/mp_linear.cu``, the fused multiplierless
  matrix product of eq. 9 (replaces the reference's Pallas
  ``mp_linear_pallas``);
* ``mp_linear_grads_kernel`` — ``csrc/mp_linear_bwd.cu``, its gradients
  from the exact levels that ``mp_linear_kernel(..., levels=True)`` writes
  in the training forward (together, the reference's custom VJP
  ``_mp_linear_vjp_bwd``, jnp); ``mp_linear_bwd_kernel`` runs both;
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
           "mp_linear_grads_kernel", "mp_linear_grads_plan", "mp_linear_plan",
           "mp_waterfill_kernel", "mp_waterfill_plan"]

# the weight dtypes the mp_linear kernel reads as they are
LINEAR_W_DTYPES = (torch.float32, torch.bfloat16)
_TILE_WIDTHS = (0, 2, 4, 8)
# csrc/mp_linear_bwd.cu's grads pass: positions per CTA, columns per chunk,
# and the CTAs an SM holds (its launch bounds)
GRADS_POSITIONS = 64
GRADS_CHUNK_COLUMNS = 128
GRADS_CTAS_PER_SM = 2
GRADS_WAVES = 16   # CTAs wanted: this many times what the card holds


def _linear_args(w_dtype: torch.dtype, tile_to: int) -> None:
    if w_dtype not in LINEAR_W_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w_dtype}")
    if tile_to not in _TILE_WIDTHS:
        raise ValueError(f"tile_to must be one of {_TILE_WIDTHS}, got "
                         f"{tile_to}")


def mp_linear_kernel(x: torch.Tensor, w: torch.Tensor, gamma,
                     iters: int = ref.DEFAULT_ITERS, *,
                     tile_to: int = 0, levels: bool = False):
    """x (B, d) float32, w (d, O) float32 or bfloat16 -> y (B, O) float32,
    y[b, o] = mpabs(x[b] + w[:, o]) - mpabs(x[b] - w[:, o]) by joint
    bisection. The kernel reads a bf16 w as it is and widens it exactly,
    so the result is that of ``w.float()``. ``tile_to`` 2, 4 or 8 runs it
    in a shared-memory tile of that many columns instead of the one it
    would pick (``mp_linear_plan``), to time or test each tile; the result
    is the same up to the sums' order. ``levels=True`` (the forward of a
    training step) returns (y, lv): y with the same bits, and lv (B, O, 4)
    float32, [z_u, z_v, 1 / k_u, 1 / k_v], the exact water levels the same
    launch solves from its bracket, for :func:`mp_linear_grads_kernel`
    (plain version: ``ref.mp_linear_with_levels``)."""
    _linear_args(w.dtype, tile_to)
    if not _on_cuda(x, w):
        if levels:
            return ref.mp_linear_with_levels(x, w, gamma, iters)
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
    lv = (torch.empty((B, O, 4), dtype=torch.float32, device=x.device)
          if levels else None)
    code = load("mp_linear")(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             None if lv is None else lv.data_ptr(), B, d, O,
                             int(w.dtype == torch.bfloat16), tile_to,
                             float(gamma), int(iters), _stream())
    _check(code, "mp_linear", f"B={B} d={d} O={O} tile_to={tile_to}")
    count_launch("mp_linear")
    return (y, lv) if levels else y


def mp_linear_bwd_kernel(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                         gamma, iters: int = ref.DEFAULT_ITERS) -> tuple:
    """The gradients of :func:`mp_linear_kernel` for a caller that holds
    no levels: x (B, d) float32, w (d, O) float32 or bfloat16, output
    gradient g (B, O) float32 -> (dx (B, d), dw (d, O)), float32, with the
    masks of the exact water levels (the reference's custom VJP). On the
    card: the levels-writing forward (its y dropped), then the grads pass;
    the plain version (``ref.mp_linear_bwd``) sorts."""
    _linear_args(w.dtype, 0)
    if not _on_cuda(x, w, g):
        return ref.mp_linear_bwd(x, w, g, gamma)
    _, lv = mp_linear_kernel(x, w, gamma, iters, levels=True)
    return mp_linear_grads_kernel(x, w, g, lv)


@functools.lru_cache(maxsize=None)
def mp_linear_grads_plan(d: int, O: int, sms: int):
    """The grads pass's grid on a card of ``sms`` SMs: ``tiles`` of 64
    positions x ``groups`` of ``chunks_per_group`` chunks of 128 columns,
    the groups as many as give about ``GRADS_WAVES`` times the CTAs the
    card holds (none beyond one chunk each). Each group leaves a dx
    partial of B x d float32 when there is more than one. Cached,
    read-only."""
    tiles = -(-d // GRADS_POSITIONS)
    chunks = -(-O // GRADS_CHUNK_COLUMNS)
    want = -(-(GRADS_WAVES * GRADS_CTAS_PER_SM * sms) // tiles)
    per_group = -(-chunks // max(1, min(chunks, want)))
    groups = -(-chunks // per_group)
    return types.MappingProxyType(dict(tiles=tiles, groups=groups,
                                       chunks_per_group=per_group))


def mp_linear_grads_kernel(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                           lv: torch.Tensor) -> tuple:
    """dx (B, d) and dw (d, O), float32, of ``mp_linear`` from the exact
    levels ``lv`` (B, O, 4) that :func:`mp_linear_kernel` wrote with
    ``levels=True`` (the backward's grads pass; no solve): x (B, d)
    float32, w (d, O) float32 or bfloat16, output gradient g (B, O)
    float32. Plain version: ``ref.mp_linear_bwd_from_levels``."""
    _linear_args(w.dtype, 0)
    if not _on_cuda(x, w, g, lv):
        return ref.mp_linear_bwd_from_levels(x, w, g, lv)
    from repro_torch.kernels._build import load
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x must be (B, d) and w (d, O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, d = x.shape
    O = w.shape[1]
    _expect("w", w, (d, O))
    _expect("g", g, (B, O))
    _expect("lv", lv, (B, O, 4))
    x, w, g, lv = _f32(x, "x"), w.contiguous(), _f32(g, "g"), _f32(lv, "lv")
    plan = mp_linear_grads_plan(d, O, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, d), **f32)
    dw = torch.empty((d, O), **f32)
    dxp = (torch.empty((plan["groups"], B, d), **f32)
           if plan["groups"] > 1 else None)
    code = load("mp_linear_bwd")(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), lv.data_ptr(),
        None if dxp is None else dxp.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), B, d, O, int(w.dtype == torch.bfloat16),
        plan["groups"], plan["chunks_per_group"], _stream())
    _check(code, "mp_linear_bwd", f"B={B} d={d} O={O}")
    count_launch("mp_linear_bwd")
    return dx, dw


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
