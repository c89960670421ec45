"""Hardware-op census as an IR pass.

Counts the reference's buckets (``add``, ``compare``, ``shift``,
``multiply``, ``transcendental_or_div``) over IR instructions, each
classified by the aten op it was lowered from through the bucket tables
of ``repro_torch.analysis.legality`` (one source of truth). The builder
lowers every input-dependent node and keeps its census element counts on
the instructions (a two-bound ``clamp`` is two instructions, one compare
per element each; a pow2-literal ``mul`` is a ``shl``), so the totals equal
``legality.census`` of the graph the program was built from.
"""

from __future__ import annotations

from collections import Counter

from repro_torch.analysis.legality import (MUL_OPS, REDUCE_ADD_OPS,
                                           REDUCE_CMP_OPS, census_bucket)


def _packet(aten_op: str) -> str:
    """``aten.add.Tensor`` -> ``add``."""
    parts = aten_op.split(".")
    return parts[1] if len(parts) > 1 else aten_op


def census_program(prog) -> Counter:
    """Scaled op census of an IR :class:`~repro_torch.ir.isa.Program`."""
    counts: Counter = Counter()

    def visit(instrs, scale: int) -> None:
        for ins in instrs:
            if ins.op in ("loop", "grid"):
                for rg in ins.regions:
                    visit(rg.body, scale * rg.trip_count)
                continue
            name = _packet(ins.aten_op)
            n = ins.census_out_elems
            if name in MUL_OPS:
                # the builder only admits pow2-literal scalings
                counts["shift"] += n * scale
                continue
            bucket = census_bucket(name)
            if bucket is None:
                continue
            if name in REDUCE_ADD_OPS or name in REDUCE_CMP_OPS:
                n = max(ins.census_in_elems - n, 0)
            if n:
                counts[bucket] += n * scale

    visit(prog.body, 1)
    return counts
