"""Wrappers of the hand-written CUDA kernels for the MP solves.

* ``mp_linear_kernel`` — ``csrc/mp_linear.cu``, the fused multiplierless
  matrix product of eq. 9 (replaces the reference's Pallas
  ``mp_linear_pallas``);
* ``mp_waterfill_kernel`` — ``csrc/mp_waterfill.cu``, row-wise reverse
  water-filling (replaces ``mp_waterfill_pallas``).

As for the FIR kernels: a CUDA tensor launches the kernel on the current
stream and counts the launch in ``kernels._wrap.LAUNCHES``; a CPU tensor
runs the plain version in ``kernels.ref``; anything else raises, and
nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._wrap import (LAUNCHES, _check, _expect, _f32,
                                       _on_cuda, _stream)

__all__ = ["mp_linear_kernel", "mp_waterfill_kernel"]


def mp_linear_kernel(x: torch.Tensor, w: torch.Tensor, gamma,
                     iters: int = ref.DEFAULT_ITERS) -> torch.Tensor:
    """x (B, d), w (d, O) float32 -> y (B, O), y[b, o] = mpabs(x[b] +
    w[:, o]) - mpabs(x[b] - w[:, o]) by joint bisection."""
    if not _on_cuda(x, w):
        return ref.mp_linear(x, w, gamma, iters)
    from repro_torch.kernels._build import load
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x must be (B, d) and w (d, O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, d = x.shape
    O = w.shape[1]
    _expect("w", w, (d, O))
    x, w = _f32(x, "x"), _f32(w, "w")
    y = torch.empty((B, O), dtype=torch.float32, device=x.device)
    code = load("mp_linear")(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, d,
                             O, float(gamma), int(iters), _stream())
    _check(code, "mp_linear", f"B={B} d={d} O={O}")
    LAUNCHES["mp_linear"] += 1
    return y


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
    code = load("mp_waterfill")(Lf.data_ptr(), z.data_ptr(), R, m,
                                float(gamma), int(iters), _stream())
    _check(code, "mp_waterfill", f"R={R} m={m}")
    LAUNCHES["mp_waterfill"] += 1
    return z.to(L.dtype)
