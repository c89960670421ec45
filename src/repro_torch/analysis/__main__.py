"""Static verification gate over the port's deployed integer programs.

Runs op-legality, worst-case interval analysis and the determinism lint
over the standard targets (``repro_torch.analysis.targets``), prints a
summary and, with ``--out``, writes the report in ``ANALYSIS.json``'s
schema. It writes nothing unless told where. Exit status is the gate:
nonzero when a gating target has an illegal op, a possible integer
overflow or a float op on the fixed path.

    PYTHONPATH=src python -m repro_torch.analysis --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --out report.json
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (3 octaves) — same passes")
    ap.add_argument("--out", default=None, help="report path (JSON)")
    ap.add_argument("--top-registers", type=int, default=20,
                    help="tightest registers to include per target")
    ap.add_argument("--device", default=None,
                    help="device the pipeline is made on (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import report as rp
    from repro_torch.analysis.targets import build_targets

    targets, meta = build_targets(smoke=args.smoke, device=args.device)
    report = rp.build_report(targets, meta,
                             top_registers=args.top_registers)
    if args.out:
        rp.write_report(args.out, report)
        print(f"wrote {args.out}")
    print(rp.summarize(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
