"""Worst-case interval analysis over a traced aten graph: prove every
register fits its bitwidth.

An abstract interpreter in the interval domain. Each node's value is
summarized by one closed interval ``[lo, hi]`` covering every element it
can take for any program input inside the declared input intervals (the
ADC range and the session register contract of
``repro_torch.analysis.targets``). Bounds are exact Python integers, so
"does this intermediate fit int32" is answered by arithmetic.

The port's graphs are flat (its Python loops unroll while it is traced),
so the pass visits each node once, in program order: no loop carries, no
fixpoint and no widening, where the reference
(``repro.analysis.intervals``) joins and widens ``scan`` carries past its
unroll limit. Input-free nodes take the exact interval of their concrete
value.

Every input-dependent integer node is a register: its record holds the
interval, the two's-complement bits it needs and the headroom against the
int32 carrier the IR gives it. An int32 sum that torch accumulates in
int64 and casts back (``core.fixed._sum``) is one int32 reduction, held to
the int32 range: a record escaping it is an overflow violation naming the
node. Int64 index arithmetic is held to int32 as well, the carrier the IR
gives it.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from typing import NamedTuple

import torch

from repro_torch.analysis.traverse import Traced, op_name

INF = float("inf")
INT32 = (-(1 << 31), (1 << 31) - 1)


def _isinf(v) -> bool:
    return isinstance(v, float) and math.isinf(v)


class Interval(NamedTuple):
    """Closed interval of exact ints (or +-inf)."""
    lo: object
    hi: object

    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    @property
    def concrete(self) -> bool:
        return self.lo == self.hi and not isinstance(self.lo, float)

    def __repr__(self) -> str:
        return f"[{self.lo}, {self.hi}]"


TOP = Interval(-INF, INF)
BOOL = Interval(0, 1)


def signed_bits(iv: Interval) -> object:
    """Smallest two's-complement width holding every value in ``iv``."""
    if _isinf(iv.lo) or _isinf(iv.hi):
        return INF
    lo, hi = int(iv.lo), int(iv.hi)
    n_hi = hi.bit_length() + 1 if hi >= 0 else 1
    n_lo = (-lo - 1).bit_length() + 1 if lo < 0 else 1
    return max(n_lo, n_hi, 1)


def carrier_bits(iv: Interval, *, unsigned: bool = False) -> object:
    """Smallest register width of the carrier's signedness family."""
    if _isinf(iv.lo) or _isinf(iv.hi):
        return INF
    if unsigned:
        if iv.lo < 0:
            return INF
        return max(int(iv.hi).bit_length(), 1)
    return signed_bits(iv)


def _json_bound(v):
    return None if _isinf(v) else int(v)


def of_value(v) -> Interval:
    """Interval of a concrete value (tensor or Python number)."""
    if isinstance(v, torch.Tensor):
        if v.numel() == 0:
            return Interval(0, 0)
        if v.dtype.is_floating_point:
            return Interval(float(v.min()), float(v.max()))
        return Interval(int(v.min()), int(v.max()))
    if isinstance(v, bool):
        return Interval(int(v), int(v))
    if isinstance(v, numbers.Integral):
        return Interval(int(v), int(v))
    return Interval(float(v), float(v))


@dataclasses.dataclass
class RegisterRecord:
    """Worst-case summary of one input-dependent integer node."""
    name: str
    primitive: str
    path: str
    source: str
    dtype_bits: int
    lo: object
    hi: object
    visits: int = 1
    unsigned: bool = False

    @property
    def required_bits(self) -> object:
        return carrier_bits(Interval(self.lo, self.hi),
                            unsigned=self.unsigned)

    @property
    def headroom_bits(self) -> object:
        r = self.required_bits
        return -INF if r == INF else self.dtype_bits - r

    def to_dict(self) -> dict:
        rb = self.required_bits
        return {
            "name": self.name,
            "dtype_bits": self.dtype_bits,
            "interval": [_json_bound(self.lo), _json_bound(self.hi)],
            "required_bits": _json_bound(rb),
            "headroom_bits": (None if rb == INF
                              else int(self.dtype_bits - rb)),
            "visits": self.visits,
        }


@dataclasses.dataclass(frozen=True)
class OverflowViolation:
    """One integer intermediate whose worst case exceeds its carrier."""
    name: str
    primitive: str
    source: str
    dtype_bits: int
    required_bits: object
    lo: object
    hi: object

    def to_dict(self) -> dict:
        return {
            "name": self.name, "primitive": self.primitive,
            "source": self.source, "dtype_bits": self.dtype_bits,
            "required_bits": _json_bound(self.required_bits),
            "interval": [_json_bound(self.lo), _json_bound(self.hi)],
        }


@dataclasses.dataclass
class IntervalResult:
    """Everything the pass proved about one program."""
    ok: bool
    violations: list
    registers: list                  # RegisterRecord, sorted by headroom
    out_intervals: list              # Interval per program output
    min_headroom_bits: object
    max_required_bits: object
    unsupported: list                # ops handled conservatively
    # node -> Interval of every node the pass evaluated (the lookup the IR
    # builder types registers with)
    by_node: dict = dataclasses.field(default_factory=dict)

    def to_dict(self, *, top_registers: int = 20) -> dict:
        return {
            "ok": self.ok,
            "min_headroom_bits": _json_bound(self.min_headroom_bits),
            "max_required_bits": _json_bound(self.max_required_bits),
            "num_registers": len(self.registers),
            "violations": [v.to_dict() for v in self.violations],
            "tightest_registers": [r.to_dict()
                                   for r in self.registers[:top_registers]],
            "out_intervals": [[_json_bound(iv.lo), _json_bound(iv.hi)]
                              for iv in self.out_intervals],
            "unsupported_primitives": sorted(set(self.unsupported)),
        }


# ---------------------------------------------------------------------------
# transfer functions
# ---------------------------------------------------------------------------


def mul_iv(a: Interval, b: Interval) -> Interval:
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if (_isinf(x) and y == 0) or (_isinf(y) and x == 0):
                cands.append(0)
            else:
                cands.append(x * y)
    return Interval(min(cands), max(cands))


def shift_right_iv(a: Interval, k: Interval, bits: int = 32) -> Interval:
    """Arithmetic right shift of a ``bits``-wide value; counts of ``bits``
    or more give the sign."""
    if _isinf(a.lo) or _isinf(a.hi):
        return TOP
    top = bits - 1
    klo = 0 if _isinf(k.lo) else min(max(int(k.lo), 0), top)
    khi = top if _isinf(k.hi) else min(max(int(k.hi), 0), top)
    cands = [int(x) >> kk for x in (a.lo, a.hi) for kk in (klo, khi)]
    return Interval(min(cands), max(cands))


def shift_left_iv(a: Interval, k: Interval, bits: int = 32) -> Interval:
    """Left shift of a ``bits``-wide value; a count of ``bits`` or more
    gives 0."""
    if _isinf(a.lo) or _isinf(a.hi) or _isinf(k.hi):
        return TOP
    klo = 0 if _isinf(k.lo) else max(int(k.lo), 0)
    khi = max(int(k.hi), 0)
    cands = [int(x) << kk for x in (a.lo, a.hi)
             for kk in (klo, khi) if kk < bits]
    if khi >= bits:
        cands.append(0)
    return Interval(min(cands), max(cands))


def max_iv(a: Interval, b: Interval) -> Interval:
    return Interval(max(a.lo, b.lo), max(a.hi, b.hi))


def min_iv(a: Interval, b: Interval) -> Interval:
    return Interval(min(a.lo, b.lo), min(a.hi, b.hi))


def _bitwise_iv(a: Interval, b: Interval) -> Interval:
    if a.lo >= 0 and b.lo >= 0 and not (_isinf(a.hi) or _isinf(b.hi)):
        n = max(int(a.hi), int(b.hi)).bit_length()
        return Interval(0, (1 << n) - 1 if n else 0)
    na, nb = signed_bits(a), signed_bits(b)
    if na == INF or nb == INF:
        return TOP
    n = max(na, nb)
    return Interval(-(1 << (n - 1)), (1 << (n - 1)) - 1)


def _cmp(op, a: Interval, b: Interval) -> Interval:
    """Comparison to a bool interval, resolved when operands are disjoint."""
    if op == "lt":
        if a.hi < b.lo:
            return Interval(1, 1)
        if a.lo >= b.hi:
            return Interval(0, 0)
    elif op == "le":
        if a.hi <= b.lo:
            return Interval(1, 1)
        if a.lo > b.hi:
            return Interval(0, 0)
    elif op == "gt":
        if a.lo > b.hi:
            return Interval(1, 1)
        if a.hi <= b.lo:
            return Interval(0, 0)
    elif op == "ge":
        if a.lo >= b.hi:
            return Interval(1, 1)
        if a.hi < b.lo:
            return Interval(0, 0)
    elif op == "eq":
        if a.concrete and b.concrete and a.lo == b.lo:
            return Interval(1, 1)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval(0, 0)
    elif op == "ne":
        if a.concrete and b.concrete and a.lo == b.lo:
            return Interval(0, 0)
        if a.hi < b.lo or b.hi < a.lo:
            return Interval(1, 1)
    return BOOL


def reduced_elems(node) -> int:
    """Elements each output of a reduction node consumes."""
    shape = node.args[0].meta["val"].shape
    dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
    if dims is None:
        return max(int(math.prod(shape)), 1)
    if isinstance(dims, int):
        dims = [dims]
    m = 1
    for d in dims:
        m *= int(shape[d])
    return m


IDENTITY_OPS = {
    "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "permute",
    "expand", "clone", "alias", "lift_fresh_copy", "detach", "slice",
    "select", "unfold", "flip", "t", "transpose", "contiguous", "amax",
    "amin", "index",
}


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


class _Analyzer:
    def __init__(self, tr: Traced):
        self.tr = tr
        self.env: dict = {}
        self.records: list = []
        self.violations: list = []
        self.unsupported: list = []

    def iv(self, a) -> Interval:
        if isinstance(a, torch.fx.Node):
            got = self.env.get(a)
            if got is None:
                got = self.env[a] = of_value(self.tr.value(a))
            return got
        if a is None:
            return TOP
        return of_value(a)

    def record(self, node, iv: Interval) -> None:
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor) or val.dtype == torch.bool \
                or val.dtype.is_floating_point:
            return
        tr = self.tr
        rec = RegisterRecord(name=tr.name(node), primitive=op_name(node),
                             path="", source=tr.source(node), dtype_bits=32,
                             lo=iv.lo, hi=iv.hi)
        self.records.append(rec)
        if iv.lo < INT32[0] or iv.hi > INT32[1]:
            self.violations.append(OverflowViolation(
                name=rec.name, primitive=rec.primitive, source=rec.source,
                dtype_bits=32, required_bits=rec.required_bits,
                lo=iv.lo, hi=iv.hi))

    def leaf(self, node) -> Interval:
        name = op_name(node)
        args = node.args
        a = lambda i: self.iv(args[i])       # noqa: E731
        val = node.meta.get("val")
        if name in IDENTITY_OPS:
            return a(0)
        if name in ("cat", "stack"):
            out = None
            for t in args[0]:
                out = self.iv(t) if out is None else out.join(self.iv(t))
            return out
        if name == "constant_pad_nd":
            pv = args[2] if len(args) > 2 else node.kwargs.get("value", 0)
            return a(0).join(of_value(pv))
        if name == "_to_copy":
            x = a(0)
            if val.dtype != torch.bool:
                return x
            if x.lo == x.hi == 0:
                return Interval(0, 0)
            return BOOL if x.lo <= 0 <= x.hi else Interval(1, 1)
        if name in ("add", "sub", "rsub"):
            alpha = node.kwargs.get("alpha", 1)
            x, y = a(0), mul_iv(a(1), of_value(alpha))
            if name == "rsub":
                x, y = y, x
            if name == "add":
                return Interval(x.lo + y.lo, x.hi + y.hi)
            return Interval(x.lo - y.hi, x.hi - y.lo)
        if name == "neg":
            x = a(0)
            return Interval(-x.hi, -x.lo)
        if name == "mul":
            return mul_iv(a(0), a(1))
        if name == "maximum":
            return max_iv(a(0), a(1))
        if name == "minimum":
            return min_iv(a(0), a(1))
        if name in ("clamp", "clamp_min", "clamp_max", "relu"):
            x = a(0)
            lo = hi = None
            if name == "relu":
                lo = 0
            elif name == "clamp_min":
                lo = args[1]
            elif name == "clamp_max":
                hi = args[1]
            else:
                lo = args[1] if len(args) > 1 else node.kwargs.get("min")
                hi = args[2] if len(args) > 2 else node.kwargs.get("max")
            if lo is not None:
                x = max_iv(x, self.iv(lo))
            if hi is not None:
                x = min_iv(x, self.iv(hi))
            return x
        if name == "abs":
            lo, hi = a(0)
            return Interval(0 if lo <= 0 <= hi else min(abs(lo), abs(hi)),
                            max(abs(lo), abs(hi)))
        if name == "sign":
            lo, hi = a(0)
            return Interval(-1 if lo < 0 else (1 if lo > 0 else 0),
                            1 if hi > 0 else (-1 if hi < 0 else 0))
        if name in ("gt", "lt", "ge", "le", "eq", "ne"):
            return _cmp(name, a(0), a(1))
        if name == "where":
            c = a(0)
            if c.concrete:
                return a(1) if c.lo else a(2)
            return a(1).join(a(2))
        if name in ("bitwise_left_shift", "__lshift__"):
            return shift_left_iv(a(0), a(1), val.dtype.itemsize * 8)
        if name in ("bitwise_right_shift", "__rshift__"):
            return shift_right_iv(a(0), a(1), val.dtype.itemsize * 8)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "logical_and", "logical_or"):
            if val.dtype == torch.bool:
                return BOOL
            x, y = a(0), a(1)
            if name == "bitwise_and" and x.lo >= 0 and y.lo >= 0:
                return Interval(0, min(x.hi, y.hi))
            return _bitwise_iv(x, y)
        if name in ("bitwise_not", "logical_not"):
            if val.dtype == torch.bool:
                return BOOL
            x = a(0)
            return Interval(-x.hi - 1, -x.lo - 1)
        if name == "sum":
            x, m = a(0), reduced_elems(node)
            return Interval(x.lo * m, x.hi * m)
        self.unsupported.append(name)
        return TOP

    def run(self, in_intervals) -> list:
        tr = self.tr
        if len(in_intervals) != len(tr.inputs):
            raise ValueError(f"{len(tr.inputs)} program inputs, "
                             f"{len(in_intervals)} intervals")
        for n, iv in zip(tr.inputs, in_intervals):
            self.env[n] = iv
        for node in tr.calls():
            if not tr.is_dependent(node):
                continue
            iv = self.leaf(node)
            self.env[node] = iv
            self.record(node, iv)
        return [self.iv(o) if o is not None else Interval(0, 0)
                for o in tr.outputs]


def analyze_intervals(tr: Traced, in_intervals) -> IntervalResult:
    """Run worst-case interval analysis over a traced program.

    ``in_intervals`` is one :class:`Interval` per program input, in the
    order of the traced function's arguments. ``ok`` proves every integer
    intermediate fits the int32 carrier for every input in the declared
    intervals.
    """
    an = _Analyzer(tr)
    outs = an.run(list(in_intervals))
    regs = sorted(an.records,
                  key=lambda r: (r.headroom_bits
                                 if not _isinf(r.headroom_bits) else -10**9))
    heads = [r.headroom_bits for r in regs]
    reqs = [r.required_bits for r in regs]
    return IntervalResult(
        ok=not an.violations and not an.unsupported,
        violations=an.violations, registers=regs, out_intervals=outs,
        min_headroom_bits=min(heads) if heads else INF,
        max_required_bits=max(reqs) if reqs else 0,
        unsupported=an.unsupported, by_node=dict(an.env))
