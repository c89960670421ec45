"""Quantization utilities, float half (paper §V, Fig. 8).

``QuantSpec`` + ``fake_quant`` are the QAT proxy: values are
round(x / s) clamped to [-(2^(b-1)), 2^(b-1)-1] and carried in float.
``torch.round`` rounds half to even, like ``jnp.round``. ``fake_quant`` is
forward only here; the straight-through gradient comes with the training
slice. The fixed-point type system (``FixedPointSpec``) is the fixed
slice's (ROADMAP.md §1, "Fixed half of core.quant, then core.fixed").
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["QuantSpec", "spec_for", "fake_quant", "unsupported_fixed",
           "FIXED_FOLLOWUP"]

# the ROADMAP.md §1 item that brings numerics="fixed" to the port
FIXED_FOLLOWUP = "Fixed half of core.quant, then core.fixed"


def unsupported_fixed(feature: str) -> NotImplementedError:
    """The one way the port says "numerics='fixed' is not ported yet"."""
    return NotImplementedError(
        f"{feature} does not support numerics='fixed' yet — the int32 "
        f"path is the {FIXED_FOLLOWUP!r} item in ROADMAP.md")


class QuantSpec(NamedTuple):
    bits: int
    scale: float  # LSB size

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


def _amax_of(x) -> float:
    """max |x|; empty and all-zero tensors give 1.0, non-finite raises."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.size == 0:
        return 1.0
    amax = float(np.max(np.abs(x)))
    if not math.isfinite(amax):
        raise ValueError(
            f"spec_for: tensor has non-finite values (max |x| = {amax})")
    return amax if amax > 0 else 1.0


def spec_for(x, bits: int) -> QuantSpec:
    """Symmetric per-tensor spec whose qmax reaches max |x|."""
    if bits < 2:
        raise ValueError(f"spec_for: need bits >= 2, got {bits}")
    return QuantSpec(bits=bits, scale=_amax_of(x) / ((1 << (bits - 1)) - 1))


def fake_quant(x: torch.Tensor, bits: int, amax=None) -> torch.Tensor:
    """Quantize-dequantize onto a symmetric ``bits``-bit grid.

    ``amax`` sets the range: a scalar, or a tensor broadcasting against
    ``x`` (the session path passes a per-stream ``(S, 1)`` running amax).
    ``None`` uses the tensor's own max |x| (right for taps, not for a batch
    of independent streams).
    """
    if amax is None:
        amax = x.detach().abs().amax()
    amax = torch.as_tensor(amax, dtype=x.dtype, device=x.device)
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    scale = amax / ((1 << (bits - 1)) - 1)
    q = torch.round(x / scale)
    q = torch.clamp(q, -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    return q * scale
