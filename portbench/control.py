"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

For each seed, runs the cell as ``run.py`` does (the same set-up, window
and sampled outputs, no trace) and prints one JSON line: the port's
numbers against the reference (the lower reading, over many seeds) and
the control's, the reference computed a precision below the
configuration's (the configuration's ``control`` block: bfloat16 for
float32, 4-bit registers for the 8-bit twin), in the port's place. The
control must fail a limit; the benchmark's own runs never run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]


def readings(workload: str, seed: int, seconds: float, device,
             t_start: float) -> dict:
    from portbench import checks, run
    ctx = run.run_cell(workload, seed, seconds, False, device, check=False,
                       t_start=t_start)
    mix = run.resolve(run.benchmark(), workload)["mix"]
    drv = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    ref = ctx["reference"]
    ctrl = checks.control_reference(ref)
    return {"seed": seed, "units": ctx["units"],
            "program": drv.compare(ref, **ctx["inputs"]),
            "control": drv.compare(ref, **drv.control(ctrl,
                                                      **ctx["inputs"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench import run
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(args.workload, seed, args.seconds, device, t)
        out["card"] = run.card()
        print(json.dumps(out), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
