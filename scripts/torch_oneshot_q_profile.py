#!/usr/bin/env python3
"""Time the fixed-point one-shot bank and ``mp_waterfill`` of one checkout
of the PyTorch/CUDA port on one card: what PERF.md compares between two
commits, run in turns in one call (parent, change, change, parent).

    python3 scripts/torch_oneshot_q_profile.py [ROOT]

ROOT is the root of the checkout whose ``src/repro_torch`` is timed (by
default this one, e.g. a parent unpacked with ``git archive`` into the
ignored ``.cmp/``); the timing helpers are this checkout's
``chip_smoke.py``. The entry points used here (``make_pipeline``,
``core.fixed``, ``kernels.mp_kernels.mp_waterfill_kernel``) exist in both.
Imports no JAX. Needs one card. Prints the card line and one JSON object:

* ``bank_*``: one fixed ``apply``'s bank, ``bank_accumulate_q(use_pallas=
  True)`` on the ADC codes of 8 seeded 1 s clips at 16 kHz (the esc10-mp
  program calibrated on them): its int bank kernel launches per call, the
  device time of those kernels and of every device record, the records
  per call (torch.profiler), and its ms by CUDA events; it must equal the
  torch-op bank (``use_pallas=False``) exactly;
* ``readout_ms``: ``standardize_q`` + ``classifier_q`` by CUDA events;
* ``apply_*``: the whole fixed ``apply`` under the profiler: wall ms,
  device busy us, device kernels, busy share;
* ``waterfill_ms``: ``mp_waterfill_kernel`` on 1,228,800 rows of 32 (CUDA
  events), its max error against the plain version and the gate.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(root: Path) -> int:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                  # puts HERE/src on the path
    sys.path.insert(0, str(root / "src"))    # ... behind ROOT/src
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_oneshot_q_profile: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.configs.esc10_mp import make_pipeline
    from repro_torch.core import fixed as fx
    from repro_torch.data.acoustic import make_esc10_like
    from repro_torch.kernels import LAUNCHES, ref
    from repro_torch.kernels.mp_kernels import mp_waterfill_kernel
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {repro_torch.__file__}, not {root}")
    print(cs.card_line(), flush=True)
    clips = make_esc10_like(per_class_train=26, per_class_test=1,
                            fs=16000.0, seconds=1.0, seed=0).x_train[:8]
    pipe = make_pipeline(numerics="fixed")
    prog = pipe.calibrate_fixed(clips)
    x = torch.from_numpy(np.ascontiguousarray(clips)).cuda()
    xq = fx.quantize_signal(prog, x)

    def bank():
        return fx.bank_accumulate_q(prog.bank, xq, use_pallas=True)

    before = sum(LAUNCHES.values())
    s = bank()
    launches = sum(LAUNCHES.values()) - before
    cs.exact(s, fx.bank_accumulate_q(prog.bank, xq), "bank vs torch ops")
    dev = cs.device_us(bank, cs.is_bank_q_kernel)
    app = cs.profiled(lambda: pipe.apply(x))
    out = dict(root=str(root), bank_launches=launches,
               bank_kernel_device_us=dev["kernel_us"],
               bank_launch_device_us=dev["launch_us"],
               bank_device_us=dev["all_us"],
               bank_device_records=dev["kernels_per_call"],
               bank_ms=cs.cuda_ms(bank, 20),
               readout_ms=cs.cuda_ms(lambda: fx.classifier_q(
                   prog.clf, fx.standardize_q(prog, s)), 10),
               apply_wall_ms=app["wall_ms"], apply_device_us=app["busy_us"],
               apply_device_kernels=app["kernels"],
               apply_device_busy_share=app["busy_share"])
    g = torch.Generator(device="cuda").manual_seed(9)
    L = torch.randn(1228800, 32, generator=g, device="cuda").mul_(3.0)
    err, tol = cs.max_err(mp_waterfill_kernel(L, cs.WATERFILL_GAMMA),
                          ref.mp_waterfill(L, cs.WATERFILL_GAMMA))
    if not err <= tol:
        raise AssertionError(f"mp_waterfill: max |diff| {err} > {tol}")
    out.update(waterfill_ms=cs.cuda_ms(
        lambda: mp_waterfill_kernel(L, cs.WATERFILL_GAMMA), 20),
        waterfill_max_abs_err=err, waterfill_tol=tol)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()))
