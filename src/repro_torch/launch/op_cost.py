"""Per-device op cost of a torch program, counted as it runs (fake tensors
do): the port's replacement for the reference's ``repro.launch.hlo_cost``,
which walks compiled XLA HLO text and has no torch counterpart.

    with FakeTensorMode(), OpCost() as cost:
        train_step(state, batch)
    cost.as_dict()   # flops, transcendentals, bytes_accessed, bytes_out,
                     # collective_bytes {type: bytes, ..., "total"}

The cost model is the reference's, op by op (its keys too):

* flops: 2 * prod(out) * prod(contract) per matrix product (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``: einsum and matmul reach these), plus
  the bias add; 1 per output element for elementwise ops (torch's
  ``pointwise`` tag); reductions 1 per input and output element; a sort
  n log2 n; a scatter's combining adds 1 per element;
* transcendentals (exp, log, tanh, rsqrt, sqrt, pow, sigmoid, sin, cos,
  erf, expm1, log1p, ...) counted apart, not in flops;
* bytes: operands + outputs per op (``bytes_accessed``) and outputs
  alone (``bytes_out``, the basis of the fused-memory model); a gather
  or index read counts only the touched slice (2 x its output), a scatter
  2 x its update; views cost nothing, a copy its write;
* collective bytes: output bytes per collective type (the reference's
  names: all-gather, all-reduce, reduce-scatter, all-to-all,
  collective-broadcast), also per mesh group (``collectives_by_group``:
  the roofline charges each group at its link's rate).

Where it differs from the HLO walk: the port's Python loops (layers,
attention and loss chunks, microbatches) run unrolled, so every trip is
counted as it runs and no trip count is needed; nothing is fused, so
``bytes_accessed`` is the unfused figure (the reference's too, for its
CPU-compiled module); a ``DTensor`` op counts on this rank's local shard
(per device, as the reference's SPMD module is per device); the backward
is counted as autograd runs it, recomputation under ``remat`` included.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost"]

_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log10", "log1p", "expm1",
                   "tanh", "rsqrt", "sqrt", "pow", "sigmoid", "sin", "cos",
                   "tan", "erf", "erfc", "atan2", "softplus",
                   "_softmax", "_log_softmax", "silu", "gelu"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "logsumexp", "norm", "linalg_vector_norm", "all",
               "any", "argmax", "argmin"}
_GATHERS = {"gather", "index", "index_select", "embedding", "take"}
_SCATTERS = {"scatter", "scatter_", "scatter_add", "scatter_add_",
             "index_put", "index_put_", "index_add", "index_add_",
             "scatter_reduce", "scatter_reduce_", "_index_put_impl_"}
_SORTS = {"sort", "argsort", "topk"}
_COPIES = {"clone", "copy_", "_to_copy", "contiguous", "_copy_from"}
_FREE = {"detach", "lift_fresh", "wait_tensor", "_local_scalar_dense",
         "set_", "resize_", "empty", "empty_like", "empty_strided",
         "device"}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_out": "all-gather",
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-broadcast",
                "broadcast_": "collective-broadcast"}


def _local(x):
    """A ``DTensor``'s local shard (this rank's share); anything else as it
    is."""
    from torch.distributed.tensor import DTensor
    return x._local_tensor if isinstance(x, DTensor) else x


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(_local(x))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(tree)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _numel(ts) -> int:
    return sum(t.numel() for t in ts)


class OpCost(TorchDispatchMode):
    """Count every op dispatched while active (see the module docstring).
    Counts are this rank's; enter it inside a ``FakeTensorMode`` to count
    without computing."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes_accessed = 0.0
        self.bytes_out = 0.0
        self.collective_bytes = defaultdict(float)
        self.collectives_by_group = defaultdict(float)   # (type, group)
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "prim" or name in _FREE or func.is_view:
            return
        self.ops += 1
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        b_in, b_out = _nbytes(ins), _nbytes(outs)
        n_out = _numel(outs)
        if ns in ("_c10d_functional", "c10d_functional", "c10d"):
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return
            group = args[-1] if args and isinstance(args[-1], str) else \
                kwargs.get("group_name", "")
            self.collective_bytes[kind] += b_out
            self.collectives_by_group[(kind, group)] += b_out
            self.bytes_accessed += b_in + b_out
            self.bytes_out += b_out
            return
        if name in ("mm", "bmm", "addmm", "baddbmm"):
            a = ins[1] if name in ("addmm", "baddbmm") else ins[0]
            self.flops += 2.0 * n_out * a.shape[-1]
            if name in ("addmm", "baddbmm"):
                self.flops += n_out
        elif name in _GATHERS:
            self.bytes_accessed += 2 * b_out
            self.bytes_out += b_out
            return
        elif name in _SCATTERS:
            upd = ins[-1] if ins else None
            ub = _nbytes([upd]) if upd is not None else 0
            self.bytes_accessed += 2 * ub
            self.bytes_out += ub
            self.flops += upd.numel() if upd is not None else 0
            return
        elif name in _SORTS:
            n = outs[0].shape[-1] if outs and outs[0].ndim else 1
            self.flops += n_out * max(math.log2(max(n, 2)), 1.0)
        elif name in _COPIES:
            self.bytes_accessed += b_out if name != "_to_copy" \
                else b_in + b_out
            self.bytes_out += b_out
            return
        elif name in _TRANSCENDENTAL:
            self.transcendentals += n_out
        elif name in _REDUCTIONS:
            self.flops += n_out + _numel(ins)
        elif torch.Tag.pointwise in func.tags:
            self.flops += n_out
        self.bytes_accessed += b_in + b_out
        self.bytes_out += b_out

    def as_dict(self) -> dict:
        coll = dict(self.collective_bytes)
        coll["total"] = sum(self.collective_bytes.values())
        return {"flops": self.flops, "transcendentals": self.transcendentals,
                "bytes_accessed": self.bytes_accessed,
                "bytes_out": self.bytes_out, "collective_bytes": coll}
