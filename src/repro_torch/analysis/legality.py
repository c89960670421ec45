"""Op-legality pass (the multiplierless verifier) and the op census, over
a traced aten graph.

Legality is the paper's primitive-set contract as a whitelist: the
integer datapath may hold adds and subtracts, shifts, compares and
selects, bitwise logic and data movement, and nothing else. A multiply is
legal only as a shift in disguise, by a positive power-of-two literal
(uniform when it is a constant tensor). Only input-dependent nodes are
judged and counted: a node that reaches no program input
(:class:`~repro_torch.analysis.traverse.Traced`) is a constant the
hardware never computes, so ``2 * torch.arange(n)`` index arithmetic is
folded, while ``3 * x`` of an input ``x`` is a violation.

The census buckets keep the reference's names (``add``, ``compare``,
``shift``, ``multiply``, ``transcendental_or_div``) and its counting
rules, so the numbers compare one to one with ``ANALYSIS.json`` and
``artifacts/ir/*/ir.json``: an elementwise op counts its output elements,
a reduction its consumed minus produced elements, ``clamp`` one compare
per bound and element (the reference's ``jnp.clip`` is a ``max`` and a
``min``), a pow2-literal multiply a shift.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from collections import Counter
from typing import Optional

import torch

from repro_torch.analysis.traverse import Traced, op_name

MUL_OPS = {"mul"}
ADD_OPS = {"add", "sub", "neg", "rsub"}
CMP_OPS = {"maximum", "minimum", "clamp", "clamp_min", "clamp_max", "relu",
           "gt", "lt", "ge", "le", "eq", "where", "abs", "sign"}
SHIFT_OPS = {"bitwise_left_shift", "bitwise_right_shift", "__lshift__",
             "__rshift__"}
REDUCE_ADD_OPS = {"sum"}
REDUCE_CMP_OPS = {"amax", "amin"}
# realized without a multiplier but in no cost bucket (as in the reference)
BITWISE_OPS = {"bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
               "logical_not", "logical_and", "logical_or", "ne"}
# value movement and layout: wiring, not arithmetic
STRUCTURAL_OPS = {
    "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "permute",
    "expand", "clone", "alias", "lift_fresh_copy", "_to_copy", "detach",
    "slice", "select", "unfold", "flip", "cat", "stack",
    "constant_pad_nd", "index", "t", "transpose", "contiguous",
    "arange", "zeros", "ones", "full", "scalar_tensor", "empty",
    "zeros_like", "ones_like", "empty_like", "full_like", "new_zeros",
    "new_ones", "new_empty", "new_full",
}
DIV_OPS = {"div", "floor_divide", "remainder", "fmod", "exp", "log",
           "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "reciprocal",
           "erf", "sin", "cos", "log1p", "expm1"}

LEGAL_OPS = (ADD_OPS | CMP_OPS | SHIFT_OPS | REDUCE_ADD_OPS
             | REDUCE_CMP_OPS | BITWISE_OPS | STRUCTURAL_OPS)


def numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def out_elems(node) -> int:
    v = node.meta.get("val")
    if isinstance(v, (list, tuple)):
        return sum(numel(t.shape) for t in v)
    return numel(v.shape) if v is not None else 0


def in_elems(node) -> int:
    a = node.args[0]
    v = a.meta.get("val") if isinstance(a, torch.fx.Node) else None
    return numel(v.shape) if v is not None else 1


def pow2_literal(tr: Traced, arg) -> Optional[int]:
    """log2 of a positive power-of-two multiplier: a Python number, or an
    input-free tensor whose elements all equal one. Else None."""
    if isinstance(arg, torch.fx.Node):
        if tr.is_dependent(arg):
            return None
        v = tr.value(arg)
        if v.numel() == 0 or not bool((v == v.reshape(-1)[0]).all()):
            return None
        arg = v.reshape(-1)[0].item()
    if not isinstance(arg, numbers.Number) or isinstance(arg, bool):
        return None
    f = float(arg)
    if f <= 0 or abs(math.log2(f) % 1.0) >= 1e-9:
        return None
    return int(round(math.log2(f)))


def pow2_multiply(tr: Traced, node) -> Optional[tuple]:
    """``(operand, k)`` when ``node`` is a binary multiply of one
    input-dependent operand by ``2**k``, else None."""
    if op_name(node) not in MUL_OPS or len(node.args) != 2:
        return None
    a, b = node.args
    for x, c in ((a, b), (b, a)):
        if isinstance(x, torch.fx.Node) and tr.is_dependent(x):
            k = pow2_literal(tr, c)
            return None if k is None else (x, k)
    return None


def clamp_bounds(node) -> int:
    """Bounds a ``clamp`` node applies (each one compare per element)."""
    name = op_name(node)
    if name != "clamp":
        return 1
    lo = node.args[1] if len(node.args) > 1 else node.kwargs.get("min")
    hi = node.args[2] if len(node.args) > 2 else node.kwargs.get("max")
    return (lo is not None) + (hi is not None)


def census_bucket(name: str) -> Optional[str]:
    """The census bucket of an aten op (elementwise ops and reductions)."""
    if name in MUL_OPS:
        return "multiply"
    if name in ADD_OPS or name in REDUCE_ADD_OPS:
        return "add"
    if name in CMP_OPS or name in REDUCE_CMP_OPS:
        return "compare"
    if name in SHIFT_OPS:
        return "shift"
    if name in DIV_OPS:
        return "transcendental_or_div"
    return None


def node_census(tr: Traced, node) -> tuple:
    """``(bucket, count)`` of one input-dependent node, or (None, 0)."""
    name = op_name(node)
    n = out_elems(node)
    if name in MUL_OPS:
        return ("shift" if pow2_multiply(tr, node) else "multiply"), n
    bucket = census_bucket(name)
    if bucket is None:
        return None, 0
    if name in REDUCE_ADD_OPS or name in REDUCE_CMP_OPS:
        return bucket, max(in_elems(node) - n, 0)
    if name == "clamp":
        return bucket, n * clamp_bounds(node)
    return bucket, n


def census(tr: Traced) -> Counter:
    """Op census of a traced program: the input-dependent nodes, by the
    reference's buckets."""
    counts: Counter = Counter()
    for node in tr.calls():
        if tr.is_dependent(node):
            bucket, n = node_census(tr, node)
            if bucket is not None and n:
                counts[bucket] += n
    return counts


def assert_multiplierless(c: Counter, tag: str) -> None:
    """The hard gate: zero multiplies (pow2-literal scalings are shifts)
    and zero divides."""
    bad = {k: c[k] for k in ("multiply", "transcendental_or_div") if c[k]}
    if bad:
        raise AssertionError(
            f"{tag}: the integer program is NOT multiplierless: {bad}")


@dataclasses.dataclass(frozen=True)
class LegalityViolation:
    """One input-dependent op outside the multiplierless primitive set."""
    primitive: str
    path: str
    source: str
    count: int          # elements it produces per program call
    reason: str

    @property
    def name(self) -> str:
        return f"{self.path}/{self.primitive}@{self.source}"


@dataclasses.dataclass(frozen=True)
class LegalityResult:
    """``ok``, the census the whitelist admitted and every violation."""
    ok: bool
    violations: tuple
    legal_ops: Counter

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "legal_ops": dict(sorted(self.legal_ops.items())),
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }


def check_legality(tr: Traced, *, max_violations: int = 64) -> LegalityResult:
    """Run the op-legality pass over a traced program."""
    violations: list = []
    legal: Counter = Counter()

    def violate(node, reason):
        if len(violations) < max_violations:
            violations.append(LegalityViolation(
                primitive=str(node.target), path="", source=tr.source(node),
                count=out_elems(node), reason=reason))

    for node in tr.calls():
        if not tr.is_dependent(node):
            continue
        name = op_name(node)
        if name in MUL_OPS:
            if pow2_multiply(tr, node):
                legal["shift"] += out_elems(node)
            else:
                violate(node, "multiply whose multiplier is not a positive "
                              "pow2 literal — needs a hardware multiplier")
            continue
        if name in LEGAL_OPS:
            bucket, n = node_census(tr, node)
            if bucket is not None and n:
                legal[bucket] += n
            continue
        violate(node, "op outside the add/sub/shift/compare/select/bitwise "
                      "whitelist")
    return LegalityResult(ok=not violations, violations=tuple(violations),
                          legal_ops=legal)


def assert_legal(tr: Traced, tag: str,
                 result: Optional[LegalityResult] = None) -> LegalityResult:
    r = result if result is not None else check_legality(tr)
    if not r.ok:
        names = "; ".join(v.name for v in r.violations[:5])
        raise AssertionError(
            f"{tag}: {len(r.violations)} op(s) outside the multiplierless "
            f"whitelist: {names}")
    return r
