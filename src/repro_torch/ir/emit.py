"""Emit the hardware artifacts of the port's integer programs from the
typed fixed-point IR.

Lowers the standard targets (``repro_torch.analysis.targets``) through
``repro_torch.ir`` and writes, per target, under ``--out-dir/<target>/``:

    program.c     -- one-file C99 reference of the whole datapath (int32
                     two's complement, shift/add/compare only; ``main``
                     reads/writes raw little-endian register images)
    program.v     -- synthesizable Verilog netlist over interval-width
                     registers, ROMs loaded from rom/*.mem ($readmemh)
    rom/<n>.mem   -- one $readmemh init file per constant ROM
    alloc.json    -- the register allocation report
    ir.json       -- the program: op census (equal to the graph census),
                     instruction/ROM totals and the typed register table

Each netlist is held, at emit time, against the IR interpreter on seeded
inputs drawn from the input intervals, through the in-repo cycle simulator
(``repro_torch.ir.vsim``; iverilog when installed). Everything written is
deterministic. It writes only under ``--out-dir``.

    PYTHONPATH=src python -m repro_torch.ir.emit --smoke --device cpu \\
        --out-dir /tmp/ir
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

TARGETS = ("oneshot_q", "session_step_q", "oneshot_q_cascade",
           "stream_cascade_q")


def emit_target(t, out_dir: str) -> dict:
    from repro_torch.analysis.legality import census
    from repro_torch.ir import build_program, census_program
    from repro_torch.ir.alloc import allocate
    from repro_torch.ir.cgen import emit_c, emit_rom_mem
    from repro_torch.ir.verilog import emit_verilog

    prog = build_program(t.traced, name=t.name, in_intervals=t.in_intervals)
    c_ir = dict(census_program(prog))
    c_graph = dict(census(t.traced))
    if c_ir != c_graph:
        raise AssertionError(
            f"{t.name}: IR census {c_ir} != graph census {c_graph}")

    tdir = os.path.join(out_dir, t.name)
    if os.path.isdir(tdir):
        shutil.rmtree(tdir)
    os.makedirs(tdir)

    alloc = allocate(prog)
    with open(os.path.join(tdir, "alloc.json"), "w") as f:
        json.dump(alloc.report, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(os.path.join(tdir, "program.c"), "w") as f:
        f.write(emit_c(prog))
    with open(os.path.join(tdir, "program.v"), "w") as f:
        f.write(emit_verilog(prog, alloc))
    romdir = os.path.join(tdir, "rom")
    os.makedirs(romdir)
    for fname, text in sorted(emit_rom_mem(prog).items()):
        with open(os.path.join(romdir, fname), "w") as f:
            f.write(text)
    verify_netlist(t, prog, alloc, tdir)

    doc = {
        "name": t.name,
        "executable": prog.executable,
        "census": {k: int(v) for k, v in sorted(c_ir.items())},
        "num_nodes": t.traced.num_nodes(),
        "num_instrs": prog.num_instrs(),
        "num_inputs": len(prog.inputs),
        "num_outputs": len(prog.outputs),
        "num_registers": len(prog.regs),
        "num_roms": len(prog.roms),
        "rom_bytes": prog.rom_bytes(),
        "roms": [{"name": r.name, "shape": list(r.shape)}
                 for r in prog.roms],
        "registers": prog.register_table(),
    }
    with open(os.path.join(tdir, "ir.json"), "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return {"name": t.name, "census": doc["census"],
            "num_instrs": doc["num_instrs"], "rom_bytes": doc["rom_bytes"]}


def seeded_inputs(prog, in_intervals, seed: int = 0x1CF11) -> list:
    """Inputs drawn uniformly from each input register's interval."""
    import numpy as np
    rng = np.random.default_rng(seed)
    inputs = []
    for iv, reg_i in zip(in_intervals, prog.inputs):
        r = prog.regs[reg_i]
        arr = rng.integers(int(iv.lo), int(iv.hi) + 1,
                           size=r.shape if r.shape else (),
                           dtype=np.int64).astype(np.int32)
        inputs.append(arr != 0 if r.dtype == "i1" else arr)
    return inputs


def verify_netlist(t, prog, alloc, tdir: str) -> None:
    """The written ``program.v`` must replay the IR interpreter bit for bit
    on seeded inputs; a mismatch names the first diverging instruction."""
    import numpy as np
    from repro_torch.ir import interp as ir_interp
    from repro_torch.ir import vsim
    from repro_torch.ir.debug import first_divergence
    from repro_torch.ir.verilog import emit_testbench

    inputs = seeded_inputs(prog, t.in_intervals)
    with open(os.path.join(tdir, "program.v")) as f:
        text = f.read()
    want = ir_interp.run(prog, inputs)
    if vsim.have_iverilog():
        got = vsim.run_iverilog(text, emit_testbench(prog, alloc),
                                inputs, rom_dir=tdir)
        how = "iverilog"
    else:
        got = vsim.run_netlist(text, inputs,
                               vsim.rom_loader_from_dir(tdir))
        how = "vsim"
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            detail = ""
            if how == "vsim":
                d = first_divergence(prog, text, inputs,
                                     vsim.rom_loader_from_dir(tdir))
                detail = f" ({d})"
            raise AssertionError(
                f"{t.name}: netlist output {i} diverges from the IR "
                f"interpreter under {how}{detail}")
    print(f"{t.name}: netlist == interpreter ({how}, "
          f"{len(want)} outputs)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (3 octaves)")
    ap.add_argument("--out-dir", required=True, help="output tree")
    ap.add_argument("--device", default=None,
                    help="device the pipeline is made on (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.targets import build_targets

    os.makedirs(args.out_dir, exist_ok=True)
    targets, _meta = build_targets(smoke=args.smoke, device=args.device,
                                   names=TARGETS)
    for t in targets:
        s = emit_target(t, args.out_dir)
        print(f"{t.name}: instrs={s['num_instrs']} "
              f"rom_bytes={s['rom_bytes']} census={s['census']}")
    print(f"wrote {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
