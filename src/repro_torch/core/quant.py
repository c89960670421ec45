"""Quantization utilities (paper §V, Fig. 8).

* ``QuantSpec`` + ``fake_quant`` are the QAT proxy: values are
  round(x / s) clamped to [-(2^(b-1)), 2^(b-1)-1] and carried in float,
  with the reference's gradient: straight through the round, zero outside
  the range and half at its edges (the clip is a max then a min, whose
  gradients split at ties, in ``jnp`` as in torch).
* ``FixedPointSpec`` is the hardware twin's type: symmetric fixed point
  with a POWER-OF-TWO scale, so every conversion between formats is a bit
  shift and the datapath of ``core.fixed`` runs on int32 with add,
  subtract, shift and compare only. ``pow2_spec_for`` snaps a range to the
  finest covering power-of-two scale.

``torch.round`` rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["QuantSpec", "FixedPointSpec", "spec_for", "pow2_spec_for",
           "fake_quant"]


class QuantSpec(NamedTuple):
    bits: int
    scale: float  # LSB size

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


class FixedPointSpec(NamedTuple):
    """Symmetric fixed point with a power-of-two LSB: value = q * 2**exp,
    q a signed integer in [qmin, qmax]. Converting between two specs is a
    bit shift: left to a finer exp (exact), right to a coarser one (floor).
    """
    bits: int
    exp: int  # scale = 2.0 ** exp (negative: fractional LSBs)

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def scale(self) -> float:
        return math.ldexp(1.0, self.exp)

    @property
    def amax(self) -> float:
        """Largest representable magnitude."""
        return self.qmax * self.scale

    def quantize(self, x, dtype=torch.int32) -> torch.Tensor:
        """Round half to even onto the grid, saturating clamp: codes of
        ``dtype`` (int32, or float32 carrying integers). ``x`` is taken as
        float32 and multiplied by the float32 reciprocal of the scale
        (exact: a power of two)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        q = torch.round(x * np.float32(1.0 / self.scale).item())
        return torch.clamp(q, self.qmin, self.qmax).to(dtype)

    def dequantize(self, q) -> torch.Tensor:
        """Exact (power-of-two) rescale of integer codes back to float."""
        return torch.as_tensor(q).to(torch.float32) * self.scale


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


def pow2_spec_for(x, bits: int, amax: float | None = None) -> FixedPointSpec:
    """Finest power-of-two-scale spec whose qmax reaches max |x| (or
    ``amax``): exp = ceil(log2(amax / qmax)). Host-side (numpy), with
    ``spec_for``'s handling of empty and all-zero tensors."""
    if bits < 2:
        raise ValueError(f"pow2_spec_for: need bits >= 2, got {bits}")
    if amax is None:
        amax = _amax_of(x)
    if not (math.isfinite(amax) and amax > 0):
        raise ValueError(f"pow2_spec_for: need finite amax > 0, got {amax}")
    qmax = (1 << (bits - 1)) - 1
    exp = math.ceil(math.log2(amax / qmax) - 1e-12)
    # guard the float log against landing one LSB short of covering amax
    while math.ldexp(qmax, exp) < amax:
        exp += 1
    return FixedPointSpec(bits=bits, exp=exp)


class _STERound(torch.autograd.Function):
    """``torch.round`` with the gradient passed straight through (the
    reference's ``_ste_round``)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor, bits: int, amax=None) -> torch.Tensor:
    """Quantize-dequantize onto a symmetric ``bits``-bit grid, with a
    straight-through gradient (QAT).

    ``amax`` sets the range: a scalar, or a tensor broadcasting against
    ``x`` (the session path passes a per-stream ``(S, 1)`` running amax).
    ``None`` uses the tensor's own max |x| (right for taps, not for a batch
    of independent streams); no gradient flows into the range.
    """
    from repro_torch.core.mp import device_scalar
    if amax is None:
        amax = x.detach().abs().amax()
    amax = torch.as_tensor(amax, dtype=x.dtype, device=x.device)
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    scale = amax / ((1 << (bits - 1)) - 1)
    q = _STERound.apply(x / scale)
    lo = device_scalar(float(-(1 << (bits - 1))), q.dtype, q.device)
    hi = device_scalar(float((1 << (bits - 1)) - 1), q.dtype, q.device)
    q = torch.minimum(torch.maximum(q, lo), hi)
    return q * scale
