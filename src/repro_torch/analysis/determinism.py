"""Determinism lint: bit-parity hazards in a traced aten graph.

The fixed-point twin's value is bit-exactness: every run, backend and
chunking gives the same int32 words. Two things break that:

* **Float ops reachable in a ``numerics="fixed"`` program**: any
  non-structural op with a float operand or result is a leak from the
  float path and a gating finding.
* **Free-tree float reductions** (``sum``, ``cumsum``, matrix products,
  convolutions over floats): float addition is not associative, so a
  retiled reduction changes low bits. In a float program they are
  informational findings.

Integer ops are exact at any evaluation order; compares, selects and
``amax``/``amin`` are exact on floats too. Input-free nodes are constants
and are not linted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.legality import STRUCTURAL_OPS
from repro_torch.analysis.traverse import Traced, op_name

_EXACT = STRUCTURAL_OPS | {
    "where", "eq", "ne", "lt", "le", "gt", "ge", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "logical_not",
    "logical_and", "logical_or", "sign", "isfinite", "amax", "amin",
    "argmax", "argmin", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "relu", "abs", "neg", "sort", "topk", "gather",
    "scatter", "masked_fill",
}
_FREE_TREE = {"sum", "mean", "cumsum", "mm", "bmm", "addmm", "matmul",
              "convolution", "dot", "mv"}


def _has_float_io(node) -> bool:
    vals = [node.meta.get("val")] + [a.meta.get("val")
                                     for a in node.all_input_nodes]
    for v in vals:
        for t in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(t, torch.Tensor) and t.dtype.is_floating_point:
                return True
    return False


@dataclasses.dataclass(frozen=True)
class DeterminismFinding:
    """One bit-parity hazard."""
    kind: str           # "float_in_fixed" | "free_tree_reduction"
    primitive: str
    path: str
    source: str
    count: int
    gating: bool

    @property
    def name(self) -> str:
        return f"{self.path}/{self.primitive}@{self.source}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["name"] = self.name
        return d


@dataclasses.dataclass(frozen=True)
class DeterminismResult:
    ok: bool
    findings: tuple

    def to_dict(self) -> dict:
        return {"ok": self.ok, "num_findings": len(self.findings),
                "findings": [f.to_dict() for f in self.findings]}


def lint_determinism(tr: Traced, *, numerics: str = "fixed",
                     max_findings: int = 64) -> DeterminismResult:
    """Lint a traced program for bit-parity hazards (gating under
    ``numerics="fixed"``)."""
    findings: list = []
    for node in tr.calls():
        if len(findings) >= max_findings:
            break
        if not tr.is_dependent(node):
            continue
        name = op_name(node)
        if name in _EXACT or not _has_float_io(node):
            continue
        kind = "free_tree_reduction" if name in _FREE_TREE else \
            "float_in_fixed"
        if kind == "float_in_fixed" and numerics != "fixed":
            continue
        findings.append(DeterminismFinding(
            kind=kind, primitive=str(node.target), path="",
            source=tr.source(node), count=1, gating=numerics == "fixed"))
    return DeterminismResult(ok=not any(f.gating for f in findings),
                             findings=tuple(findings))
