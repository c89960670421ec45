"""Int8 error-feedback gradient compression for the slow (inter-pod) axis.

The counterpart of the reference's ``repro.distributed.compression``.
QSGD-style, per tensor:

    c_t   = quantize_int8(g_t + e_t)          (symmetric, scale amax / 127)
    g_hat = all-reduce(c_t * scale) / n_pods
    e_t+1 = (g_t + e_t) - dequant(c_t)        (error feedback)

Float32 throughout, rounding half to even, as the reference: the codes,
the scale and the residual are bit for bit its own. The all-reduce runs
over the ``pod`` dim of the mesh (``mesh.get_group("pod")``); the
reduction inside a pod stays full precision.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map

__all__ = ["compress_state_init", "compressed_psum",
           "compressed_grad_allreduce"]


def compress_state_init(grads: Any) -> Any:
    """Error-feedback residuals, float32 zeros congruent with ``grads``."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def _quant_dequant_int8(x: torch.Tensor):
    """``(q int8, scale f32 0-d)``: q = clip(round(x / scale), -127, 127)
    with scale = amax / 127 (1 when x is all zero)."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones((), dtype=x.dtype, device=x.device))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, err: torch.Tensor, group=None):
    """The mean over the ranks of ``group`` of int8-compressed ``x``, with
    error feedback. Returns ``(mean estimate in x's dtype, new err)``."""
    xf = x.to(torch.float32) + err
    q, scale = _quant_dequant_int8(xf)
    deq = q.to(torch.float32) * scale
    new_err = xf - deq
    total = q.to(torch.int32).to(torch.float32) * scale
    dist.all_reduce(total, group=group)
    n = float(dist.get_world_size(group))
    return (total / n).to(x.dtype), new_err


def compressed_grad_allreduce(grads: Any, err_state: Any, mesh,
                              axis_name: str = "pod"):
    """:func:`compressed_psum` leaf by leaf over ``mesh``'s ``axis_name``
    dim. The grads come in averaged within the pod and replicated over
    it. Returns ``(grads, err_state)``."""
    group = mesh.get_group(axis_name)
    errs: list = []

    def one(g, e):
        out, new_err = compressed_psum(g, e, group)
        errs.append(new_err)
        return out

    new_grads = tree_map(one, grads, err_state)
    it = iter(errs)
    return new_grads, tree_map(lambda _: next(it), err_state)
