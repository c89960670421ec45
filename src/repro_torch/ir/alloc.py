"""Netlist register allocation: interval-proven widths, not the carrier.

The software backends carry every value in int32. Hardware does not have
to: the interval pass proves a worst-case value range per register, and
``Reg.required_bits`` is the minimal two's-complement width that holds it
(``Reg.storage_bits`` falls back to the 32-bit carrier for untyped
registers and to 1 bit for predicate wires). :func:`allocate` turns the
register table into the width map the Verilog emitter declares memories
with, plus a machine-readable cost report — the repo's stand-in for the
paper's slice count (Table I: 0 DSP, <1K slices) until a real synthesis
run exists.

Storing a value proven to lie in ``[lo, hi]`` into a ``required_bits``-wide
register and sign-extending it on read is exact; 32-bit datapath math with
a W-bit truncating store composes bit-for-bit for the wraparound group
(add/sub/neg/shl are congruences mod 2**W) and is value-exact for the
order group (cmp/min/max/shra) because the stored value is the value.
That argument is what lets the emitted netlist run narrow registers under
a 32-bit ALU and still replay the interpreter bit-for-bit.

ROMs stay 32-bit in the netlist so the committed ``rom/*.mem`` $readmemh
images load unchanged; the report prices them at both the carrier and the
minimal width so the table tracks what a width-trimmed ROM would cost.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.ir.isa import Program, CMP_OPS, SHIFT_OPS

__all__ = ["Allocation", "allocate"]


def _min_signed_bits(lo: int, hi: int) -> int:
    """Smallest two's-complement width holding every value in [lo, hi]
    (same convention as ``repro_torch.analysis.intervals.signed_bits``)."""
    lo, hi = int(lo), int(hi)
    n_hi = hi.bit_length() + 1 if hi >= 0 else 1
    n_lo = (-lo - 1).bit_length() + 1 if lo < 0 else 1
    return max(n_lo, n_hi, 1)


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Width assignment + cost report for one program.

    ``widths[reg_idx]`` is the storage width the netlist declares for the
    register's memory (ROM-backed registers keep the 32-bit $readmemh
    carrier). ``report`` is JSON-ready and committed as ``alloc.json``.
    """
    program: str
    widths: tuple
    report: dict

    def width(self, reg_idx: int) -> int:
        return self.widths[reg_idx]


def _walk_instrs(instrs):
    for ins in instrs:
        yield ins
        for rg in ins.regions:
            yield from _walk_instrs(rg.body)


def allocate(prog: Program) -> Allocation:
    """Assign every register its interval-proven storage width and price
    the datapath: register bits, ROM bits, and the static shift/add/
    compare unit sites a fully time-multiplexed FSM schedules work onto
    (the paper's MP modules are exactly such shared units)."""
    rom_regs = set(prog.rom_of_reg)
    widths = []
    for r in prog.regs:
        if r.idx in rom_regs:
            widths.append(32)           # the $readmemh image carrier
        else:
            widths.append(r.storage_bits)

    reg_count = reg_elems = bits_alloc = bits_carrier = 0
    histogram: dict = {}
    for r in prog.regs:
        if r.idx in rom_regs:
            continue
        w = widths[r.idx]
        reg_count += 1
        reg_elems += r.size
        bits_alloc += w * r.size
        bits_carrier += (1 if r.dtype == "i1" else 32) * r.size
        histogram[w] = histogram.get(w, 0) + 1

    rom_words = sum(r.data.size for r in prog.roms)
    rom_bits_min = 0
    for r in prog.roms:
        data = np.asarray(r.data)
        lo = int(data.min()) if data.size else 0
        hi = int(data.max()) if data.size else 0
        rom_bits_min += _min_signed_bits(lo, hi) * data.size

    # static datapath unit sites: one entry per instruction that needs the
    # unit, regardless of how many elements the FSM time-multiplexes
    # through it (min/max/abs/sign/clamp/select are comparator+mux pairs;
    # immediate-distance shifts are wiring on an FPGA, dynamic ones are
    # barrel shifters)
    adders = comparators = muxes = dyn_shifters = imm_shifts = 0
    element_ops = 0
    for ins in _walk_instrs(prog.body):
        element_ops += ins.census_out_elems if ins.op != "loop" else 0
        if ins.op in ("add", "sub", "neg", "reduce_sum"):
            adders += 1
        elif ins.op in ("abs",):
            adders += 1
            comparators += 1
            muxes += 1
        elif ins.op in CMP_OPS:
            comparators += 1
        elif ins.op in ("min", "max", "reduce_max", "reduce_min"):
            comparators += 1
            muxes += 1
        elif ins.op == "clamp":
            comparators += 2
            muxes += 2
        elif ins.op == "sign":
            comparators += 2
            muxes += 2
        elif ins.op == "select_n":
            muxes += 1
        elif ins.op in SHIFT_OPS:
            if "imm" in ins.attrs:
                imm_shifts += 1
            else:
                dyn_shifters += 1

    report = {
        "program": prog.name,
        "registers": {
            "count": reg_count,
            "elements": reg_elems,
            "bits_allocated": bits_alloc,
            "bits_carrier": bits_carrier,
            "carrier_saving": (round(1.0 - bits_alloc / bits_carrier, 4)
                               if bits_carrier else 0.0),
            "width_histogram": {str(k): v
                                for k, v in sorted(histogram.items())},
        },
        "roms": {
            "count": len(prog.roms),
            "words": rom_words,
            "bits_stored": 32 * rom_words,
            "bits_minimal": rom_bits_min,
        },
        "datapath": {
            "adder_sites": adders,
            "comparator_sites": comparators,
            "mux_sites": muxes,
            "dyn_shifter_sites": dyn_shifters,
            "imm_shift_sites": imm_shifts,
        },
        "time_multiplexed": {
            # one element-op per cycle on shared units: the sequential
            # cycle bound a fully folded FSM implementation pays
            "element_ops_per_inference": element_ops,
        },
    }
    return Allocation(program=prog.name, widths=tuple(widths),
                      report=report)
