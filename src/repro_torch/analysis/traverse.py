"""The shared graph walk every analysis pass runs on: the port's programs
traced from torch into one flat ``torch.fx`` graph of aten ops.

The reference walks jaxprs, recursing through call, loop and kernel
primitives. A graph made by ``make_fx`` has none of those: the port's
Python loops (the bisection steps, the 1024-position blocks of
``fxp_fir_bank``, the octaves) unroll while it is traced, so a node
executes exactly once per call and the walk is a single pass in program
order.

Two facts the passes share live here:

* **Which nodes depend on a program input.** A node that reaches no
  placeholder (``arange``, index arithmetic such as ``2 * arange``,
  compares on constant shift tables) is a constant: :meth:`Traced.value`
  evaluates it on real tensors, the legality pass and the census fold it
  instead of counting it, and the IR builder stores what it produces as a
  ROM. Ops that read only their operand's shape (``zeros_like``,
  ``new_zeros``) do not make a node input-dependent.
* **Node names.** :func:`trace` runs the function under a
  ``TorchFunctionMode`` that writes the innermost frame outside torch into
  the node metadata (``torch.fx.traceback.set_stack_trace`` under
  ``preserve_node_meta``), so every node carries the port's source
  location, ``fixed.py:205 (fxp_mp_bisect)``. A node without one is named
  by its aten op and its index in the graph, ``aten.add.Tensor#123``.
"""

from __future__ import annotations

import copy
import os
import sys
from typing import Callable

import torch
import torch.fx.traceback as fx_traceback
from torch.overrides import TorchFunctionMode

__all__ = ["Traced", "trace", "op_name", "SHAPE_ONLY_OPS"]

_TORCH_DIR = os.path.dirname(torch.__file__)

# ops whose result depends on their operand's shape and dtype only
SHAPE_ONLY_OPS = frozenset({
    "zeros_like", "ones_like", "empty_like", "full_like", "new_zeros",
    "new_ones", "new_empty", "new_full", "sym_size", "sym_numel",
})


def op_name(node) -> str:
    """The aten op of a ``call_function`` node without its overload:
    ``aten.add.Tensor`` -> ``add``."""
    t = node.target
    packet = getattr(t, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(t, "__name__", str(t))


def _user_frame() -> str:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_TORCH_DIR) and fn != __file__:
            return (f"{os.path.basename(fn)}:{f.f_lineno} "
                    f"({f.f_code.co_name})")
        f = f.f_back
    return ""


class _SourceMode(TorchFunctionMode):
    """Stamps every torch call's source location on the nodes it makes."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        fx_traceback.set_stack_trace([_user_frame()])
        return func(*args, **(kwargs or {}))


def trace(fn: Callable, *args, program=None) -> "Traced":
    """Trace ``fn(*args)`` (tensors in, a tensor or a flat tuple of tensors
    out) into a :class:`Traced` graph with fake tensors: shapes and dtypes
    only, so a full-config program traces without running it.

    ``program``, when given, is the object ``fn`` reads its constants from:
    it is deep-copied first, so the per-device constant caches the port
    keeps on program objects (``core.fixed._rom``) never hold a fake
    tensor afterwards. For the same reason the port's modules call
    ``core.mp.device_scalar`` uncached while tracing (its shared cache may
    hold tensors that captured CUDA graphs read, so it is not cleared).
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.mp import device_scalar

    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("repro_torch.")
               and getattr(m, "device_scalar", None) is device_scalar]
    if program is not None:
        prog = copy.deepcopy(program)
        run = lambda *a: fn(prog, *a)      # noqa: E731
    else:
        run = fn

    def traced(*a):
        with _SourceMode():
            return run(*a)

    for m in patched:
        m.device_scalar = device_scalar.__wrapped__
    try:
        with fx_traceback.preserve_node_meta():
            gm = make_fx(traced, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*args)
    finally:
        for m in patched:
            m.device_scalar = device_scalar
    return Traced(gm)


class Traced:
    """A traced program: its graph, its inputs and outputs in order, the
    set of input-dependent nodes and the constant values of the others."""

    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.graph = gm.graph
        self.inputs = [n for n in self.graph.nodes if n.op == "placeholder"]
        out = next(n for n in self.graph.nodes if n.op == "output")
        res = out.args[0]
        self.outputs = list(res) if isinstance(res, (list, tuple)) \
            else [res]
        self.index = {n: i for i, n in enumerate(self.graph.nodes)}
        dep = set(self.inputs)
        for n in self.graph.nodes:
            if n.op == "call_function" and op_name(n) not in SHAPE_ONLY_OPS \
                    and any(a in dep for a in n.all_input_nodes):
                dep.add(n)
        self.dependent = frozenset(dep)
        self._values: dict = {}

    # -- walking -----------------------------------------------------------

    def calls(self) -> list:
        """Every ``call_function`` node, in program order."""
        return [n for n in self.graph.nodes if n.op == "call_function"]

    def num_nodes(self) -> int:
        return len(self.graph.nodes)

    def is_dependent(self, node) -> bool:
        return node in self.dependent

    # -- naming ------------------------------------------------------------

    def source(self, node) -> str:
        """``file:line (function)`` of the port's code that made ``node``,
        else its aten op and graph index."""
        st = node.meta.get("stack_trace")
        if st:
            return st
        return f"{node.target}#{self.index[node]}"

    def name(self, node) -> str:
        return f"{op_name(node)}@{self.source(node)}"

    # -- values ------------------------------------------------------------

    def meta(self, node):
        """The fake tensor (shape, dtype) a node produces."""
        return node.meta.get("val")

    def value(self, node):
        """The concrete value of an input-free node (a real tensor), made by
        running its aten op on its operands' values."""
        if node in self._values:
            return self._values[node]
        if node in self.dependent:
            raise ValueError(f"{self.name(node)} depends on a program input")
        if node.op == "get_attr":
            v = getattr(self.gm, node.target)
        elif node.op == "call_function":
            def arg(a):
                if not isinstance(a, torch.fx.Node):
                    return a
                if a in self.dependent:      # a shape-only operand
                    m = self.meta(a)
                    return torch.empty(m.shape, dtype=m.dtype)
                return self.value(a)
            args = torch.fx.node.map_aggregate(node.args, arg)
            kwargs = torch.fx.node.map_aggregate(node.kwargs, arg)
            kwargs = {k: v for k, v in kwargs.items() if k != "device"}
            with torch.device("cpu"):
                v = node.target(*args, **kwargs)
        else:
            raise ValueError(f"no value for {node.op} node {node.name}")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
        self._values[node] = v
        return v
