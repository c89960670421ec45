"""Template kernel machine classifier in the MP domain (paper §III-B).

    z+ = MP([w+ + K, w- - K, b+], gamma1)
    z- = MP([w+ - K, w- + K, b-], gamma1)
    z  = MP([z+, z-], 1)
    p  = [z+ - z]_+ - [z- - z]_+          in [-1, 1]

w+ and w- are stored separately (the hardware ROMs) and relu'd on use.
``forward(params, K)`` is the functional form; with ``exact=True`` it is
differentiable in all five leaves (through relu, exp and the autograd
rule of ``mp_exact``), which is how ``core.trainer`` trains it.
``MPKernelMachine`` is an ``nn.Module`` holding them as parameters, and
``quantize_params`` gives the fixed-point twin's ROM contents.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.mp import mp_exact, mp_newton
from repro_torch.core.quant import FixedPointSpec

__all__ = ["MPKernelMachineParams", "MPKernelMachine", "init_params",
           "forward", "quantize_params"]


class MPKernelMachineParams(NamedTuple):
    w_pos: torch.Tensor       # (P, C) nonnegative after relu
    w_neg: torch.Tensor       # (P, C)
    b_pos: torch.Tensor       # (C,)
    b_neg: torch.Tensor       # (C,)
    log_gamma1: torch.Tensor  # scalar


def init_params(generator: torch.Generator, num_templates: int,
                num_classes: int, gamma1: float = 8.0,
                device=None) -> MPKernelMachineParams:
    """Random templates, uniform in [0, 0.5), drawn from ``generator`` on
    the CPU (so a seed gives the same weights on every device) and moved to
    ``device``; the biases start at 0 and gamma1 at ``gamma1``. The
    reference draws from ``jax.random``, so the same seed gives other
    values there; use the bridge to carry its exact weights over."""
    shape = (num_templates, num_classes)
    w_pos = torch.rand(shape, generator=generator) * 0.5
    w_neg = torch.rand(shape, generator=generator) * 0.5
    p = MPKernelMachineParams(
        w_pos=w_pos, w_neg=w_neg,
        b_pos=torch.zeros(num_classes), b_neg=torch.zeros(num_classes),
        log_gamma1=torch.tensor(math.log(gamma1), dtype=torch.float32))
    return MPKernelMachineParams(*(t.to(device) for t in p))


def forward(params: MPKernelMachineParams, K: torch.Tensor,
            gamma_scale: float = 1.0, exact: bool = True) -> torch.Tensor:
    """K (B, P) kernel vector -> p (B, C) signed confidence in [-1, 1].

    ``exact=False`` solves with fixed-iteration monotone Newton (the
    serving readout); ``exact=True`` with the sort-based closed form.
    """
    wp = torch.relu(params.w_pos)
    wn = torch.relu(params.w_neg)
    gamma1 = torch.exp(params.log_gamma1) * gamma_scale
    Kp = K[:, :, None]
    Kn = -K[:, :, None]
    solve = mp_exact if exact else mp_newton

    def z_of(a, b, bias):  # (B, 2P+1, C) operands reduced along 2P+1
        ops = torch.cat([a[None] + Kp, b[None] + Kn], dim=1)
        bias_col = bias[None, None, :].expand(ops.shape[0], 1, ops.shape[2])
        ops = torch.cat([ops, bias_col], dim=1)
        return solve(ops.movedim(1, -1), gamma1)

    z_pos = z_of(wp, wn, params.b_pos)
    z_neg = z_of(wn, wp, params.b_neg)
    z = solve(torch.stack([z_pos, z_neg], dim=-1), 1.0)
    return torch.relu(z_pos - z) - torch.relu(z_neg - z)


def quantize_params(params: MPKernelMachineParams,
                    rom_spec: FixedPointSpec, operand_spec: FixedPointSpec):
    """Integer ROM contents for the fixed-point twin (``core.fixed``):
    w+/w- relu'd (the ROMs hold nonnegative entries, as ``forward``
    enforces), quantized onto the 8-bit ``rom_spec`` grid, then
    shift-aligned onto the 10-bit ``operand_spec`` grid of the MP adders;
    biases quantize directly at operand scale. Returns ``(wp_q, wn_q,
    bpos_q, bneg_q)`` int32 numpy arrays at ``operand_spec.exp``.

    Host-side numpy: the quantizing multiply is by the float32 reciprocal
    of the scale, as ``FixedPointSpec.quantize`` does (pow2 reciprocals are
    exact, rounding is half to even), so the codes do not depend on the
    device."""
    k = rom_spec.exp - operand_spec.exp

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    def quant(x, spec):
        q = np.round(host(x) * np.float32(1.0 / spec.scale))
        return np.clip(q, spec.qmin, spec.qmax).astype(np.int64)

    def align(q):
        # left shifts exact, right shifts floor like the shifter
        return (q << k if k >= 0 else q >> (-k)).astype(np.int32)

    wp_q = align(quant(np.maximum(host(params.w_pos), 0.0), rom_spec))
    wn_q = align(quant(np.maximum(host(params.w_neg), 0.0), rom_spec))
    bpos_q = quant(params.b_pos, operand_spec).astype(np.int32)
    bneg_q = quant(params.b_neg, operand_spec).astype(np.int32)
    return wp_q, wn_q, bpos_q, bneg_q


class MPKernelMachine(nn.Module):
    """The classifier as a module; its five leaves are parameters (the
    deployed pipeline freezes them: ``requires_grad_(False)``)."""

    def __init__(self, params: MPKernelMachineParams):
        super().__init__()
        for name, t in params._asdict().items():
            self.register_parameter(name, nn.Parameter(
                torch.as_tensor(t, dtype=torch.float32).detach().clone()))

    @property
    def params(self) -> MPKernelMachineParams:
        return MPKernelMachineParams(*(getattr(self, f)
                                       for f in MPKernelMachineParams._fields))

    def forward(self, K: torch.Tensor, gamma_scale: float = 1.0,
                exact: bool = True) -> torch.Tensor:
        return forward(self.params, K, gamma_scale, exact)
