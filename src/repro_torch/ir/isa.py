"""The typed fixed-point op-stream IR: register model + instruction set.

The port's copy of the reference's IR (``repro.ir.isa``), unchanged in
shape so the same back ends (interpreter, torch re-emitter, C, register
allocation, Verilog, cycle simulator) run on it. A :class:`Program` is a
flat stream of :class:`Instr` over an SSA register file of :class:`Reg`:
every register carries its static shape, its carrier dtype and, when the
program was built with input intervals, the proven worst-case value
interval and minimal two's-complement width from
``repro_torch.analysis.intervals``.

==============  ===========================================================
class           opcodes
==============  ===========================================================
arith           ``add sub neg min max abs sign clamp``
shift           ``shl shra shrl`` (operand or immediate ``imm`` amounts)
compare         ``lt le gt ge eq ne``
select          ``select_n``
bitwise         ``and or xor not``
reduce          ``reduce_sum reduce_max reduce_min`` (attr ``axes``)
movement        ``mov broadcast reshape transpose rev slice gather
                concat pad iota convert dynamic_slice
                dynamic_update_slice``
control         ``loop`` (a scan region), ``grid`` (census only)
ref (grid)      ``ref_get ref_swap program_id num_programs``
const           ``rom`` (a named constant table)
==============  ===========================================================

There is no multiply, no divide and no float opcode: a program that
cannot be expressed here cannot be built, so "the datapath is
multiplierless" is a type error. A multiply by a positive power-of-two
literal arrives as a ``shl``.

Instructions remember the aten op they were lowered from
(``Instr.aten_op``) and the census element counts, so the IR census
(``repro_torch.ir.census``) equals the graph census of
``repro_torch.analysis.legality`` exactly. The port's programs are traced
with their Python loops unrolled, so they hold no ``loop`` or ``grid``
region; the opcodes stay for the copied back ends.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Reg", "Rom", "Instr", "Region", "Program",
    "ARITH_OPS", "SHIFT_OPS", "CMP_OPS", "SELECT_OPS", "BITWISE_OPS",
    "REDUCE_ADD_OPS", "REDUCE_CMP_OPS", "MOVE_OPS", "CONTROL_OPS",
    "REF_OPS", "ALL_OPS", "DTYPES",
]

# dtype codes: the IR carries two value kinds only — the int32 datapath
# carrier and the 1-bit predicate wires comparisons produce
DTYPES = ("i32", "i1")

ARITH_OPS = frozenset({"add", "sub", "neg", "min", "max", "abs", "sign",
                       "clamp"})
SHIFT_OPS = frozenset({"shl", "shra", "shrl"})
CMP_OPS = frozenset({"lt", "le", "gt", "ge", "eq", "ne"})
SELECT_OPS = frozenset({"select_n"})
BITWISE_OPS = frozenset({"and", "or", "xor", "not"})
REDUCE_ADD_OPS = frozenset({"reduce_sum"})
REDUCE_CMP_OPS = frozenset({"reduce_max", "reduce_min"})
MOVE_OPS = frozenset({
    "mov", "broadcast", "reshape", "transpose", "rev", "slice", "gather",
    "concat", "pad", "iota", "convert", "dynamic_slice",
    "dynamic_update_slice",
})
CONTROL_OPS = frozenset({"loop", "grid", "cond"})
REF_OPS = frozenset({"ref_get", "ref_swap", "program_id", "num_programs"})

ALL_OPS = (ARITH_OPS | SHIFT_OPS | CMP_OPS | SELECT_OPS | BITWISE_OPS
           | REDUCE_ADD_OPS | REDUCE_CMP_OPS | MOVE_OPS | CONTROL_OPS
           | REF_OPS)


@dataclasses.dataclass(frozen=True)
class Reg:
    """One SSA value: a typed register (scalar or tensor).

    ``bits`` is the carrier width (32 for the int32 datapath, 1 for
    predicate wires). ``interval``/``required_bits`` are the worst-case
    facts from the interval pass when the program was built with declared
    input intervals — ``required_bits`` is the minimal two's-complement
    register a netlist needs, ``bits`` what the software carrier spends.
    ``None`` means the fact was not computed (untyped build) or the value
    is a predicate.
    """
    idx: int
    shape: tuple
    dtype: str                              # "i32" | "i1"
    bits: int                               # carrier width
    interval: Optional[tuple] = None        # (lo, hi) exact ints
    required_bits: Optional[int] = None

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def storage_bits(self) -> int:
        """The width a netlist register allocator assigns this register:
        1 for predicate wires, the proven minimal two's-complement width
        when the program was typed by the interval pass, the full carrier
        width otherwise. Never below 1."""
        if self.dtype == "i1":
            return 1
        if self.required_bits is not None:
            return max(1, int(self.required_bits))
        return int(self.bits)

    def short(self) -> str:
        iv = "" if self.interval is None else \
            f" in [{self.interval[0]}, {self.interval[1]}]" \
            f" ({self.required_bits}b)"
        shp = "x".join(str(d) for d in self.shape) or "scalar"
        return f"r{self.idx}:{self.dtype}[{shp}]{iv}"


@dataclasses.dataclass(frozen=True)
class Rom:
    """A named constant table (taps, mu, shift tables, classifier weights):
    the contents of one hardware ROM. ``data`` is a host int32 (or bool)
    ndarray; the C emitter writes one ``.mem`` init file per ROM."""
    idx: int
    name: str
    data: np.ndarray

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)


@dataclasses.dataclass(frozen=True)
class Instr:
    """One IR instruction: ``dest = op(srcs, **attrs)``.

    ``srcs`` are register indices; ``dests`` usually one register (``loop``
    carries + stacked outputs make it several). ``attrs`` hold the static
    parameters (shift immediates, reduce axes, gather dimension numbers…)
    as plain JSON-serializable values. ``regions`` holds the sub-programs
    of control instructions (the ``loop`` body / ``grid`` kernel).

    ``aten_op`` + ``census_out_elems``/``census_in_elems`` pin the census
    semantics of the graph node this instruction was lowered from, so the
    IR census is the graph census.
    """
    op: str
    dests: tuple
    srcs: tuple
    attrs: dict
    regions: tuple = ()
    aten_op: str = ""
    census_out_elems: int = 0
    census_in_elems: int = 0


@dataclasses.dataclass
class Region:
    """A control instruction's sub-program: its own instruction stream over
    the shared register file. ``inputs`` are the registers the region binds
    per entry (loop: consts + carries + per-trip x slices; grid: cells),
    ``outputs`` the registers it yields per trip."""
    kind: str                    # "loop" | "grid"
    trip_count: int              # loop length / pallas grid product
    inputs: tuple                # reg indices bound at region entry
    outputs: tuple               # reg indices yielded per trip
    body: list = dataclasses.field(default_factory=list)   # [Instr]
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Program:
    """A lowered fixed-point program: typed registers + ROMs + the op
    stream. ``executable`` is False for programs containing a ``grid``
    region (census/verification surface only — the Pallas kernel's memory
    cells have no sequential SSA execution here)."""
    name: str
    inputs: tuple                # reg indices, program argument order
    outputs: tuple               # reg indices, program result order
    regs: list                   # Reg, indexed by Reg.idx
    roms: list                   # Rom, indexed by Rom.idx
    rom_of_reg: dict             # reg idx -> rom idx (const registers)
    body: list                   # [Instr]
    meta: dict = dataclasses.field(default_factory=dict)
    executable: bool = True

    # -- introspection ----------------------------------------------------

    def num_instrs(self) -> int:
        def count(instrs) -> int:
            n = 0
            for ins in instrs:
                n += 1
                for rg in ins.regions:
                    n += count(rg.body)
            return n
        return count(self.body)

    def rom_bytes(self) -> int:
        return sum(r.data.size * 4 for r in self.roms)

    def register_table(self) -> list:
        """The netlist view: every typed register with its proven width,
        sorted by index (deterministic)."""
        rows = []
        for r in self.regs:
            rows.append({
                "reg": r.idx,
                "shape": list(r.shape),
                "dtype": r.dtype,
                "carrier_bits": r.bits,
                "interval": (None if r.interval is None
                             else [int(r.interval[0]), int(r.interval[1])]),
                "required_bits": r.required_bits,
            })
        return rows
