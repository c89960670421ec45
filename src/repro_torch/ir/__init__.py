"""Typed fixed-point op-stream IR with pluggable back ends, for the port's
traced integer programs (the counterpart of the reference's ``repro.ir``).

``repro_torch.analysis`` is the front half (tracing, legality, intervals);
this package is the back half:

* :mod:`repro_torch.ir.isa`        — instruction set + typed registers
* :mod:`repro_torch.ir.build`      — aten graph -> IR (multiplierless by
  construction, input-free nodes folded into ROMs)
* :mod:`repro_torch.ir.interp`     — numpy ground-truth executor
* :mod:`repro_torch.ir.emit_torch` — IR -> torch int ops, on any device
* :mod:`repro_torch.ir.cgen`       — C99 + ROM ``.mem`` emitter
* :mod:`repro_torch.ir.census`     — the op census as an IR pass
* :mod:`repro_torch.ir.alloc`      — interval-proven register widths
* :mod:`repro_torch.ir.verilog`    — Verilog netlist emitter
* :mod:`repro_torch.ir.vsim`       — cycle simulator of that netlist
* :mod:`repro_torch.ir.debug`      — first-divergence locator
* :mod:`repro_torch.ir.emit`       — the artifact CLI (``python -m
  repro_torch.ir.emit``)
"""

from repro_torch.ir.build import BuildError, build_program
from repro_torch.ir.census import census_program
from repro_torch.ir.isa import Instr, Program, Reg, Region, Rom

__all__ = [
    "BuildError", "build_program", "census_program",
    "Instr", "Program", "Reg", "Region", "Rom",
]
