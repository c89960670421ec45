"""Machine-readable analysis report for ``python -m repro_torch.analysis``.

The port's copy of ``repro.analysis.report``. The report is deterministic
(sorted keys, no timestamps, no machine info), in the reference's
``ANALYSIS.json`` schema, so the two compare section by section.
"""

from __future__ import annotations

import json

from repro_torch.analysis.determinism import lint_determinism
from repro_torch.analysis.intervals import analyze_intervals
from repro_torch.analysis.legality import check_legality

SCHEMA_VERSION = 1


def analyze_target(t, *, top_registers: int = 20) -> dict:
    """Run every applicable pass over one
    :class:`~repro_torch.analysis.targets.Target`; its report section."""
    section = {
        "numerics": t.numerics,
        "n_samples": t.n_samples,
        "gate": t.gate,
        "assumptions": dict(sorted(t.assumptions.items())),
        "legality": check_legality(t.traced).to_dict(),
        "determinism": lint_determinism(t.traced,
                                        numerics=t.numerics).to_dict(),
    }
    if t.in_intervals is not None:
        section["intervals"] = analyze_intervals(
            t.traced, t.in_intervals).to_dict(top_registers=top_registers)
    return section


def target_ok(section: dict) -> bool:
    """Every pass that ran on this target came back clean."""
    return (section["legality"]["ok"]
            and section["determinism"]["ok"]
            and section.get("intervals", {"ok": True})["ok"])


def build_report(targets, meta: dict, *, top_registers: int = 20) -> dict:
    sections = {t.name: analyze_target(t, top_registers=top_registers)
                for t in targets}
    gate_ok = all(target_ok(s) for name, s in sections.items()
                  if s["gate"])
    return {
        "schema": SCHEMA_VERSION,
        "ok": gate_ok,
        "meta": dict(sorted(meta.items())),
        "targets": sections,
    }


def write_report(path, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")


def summarize(report: dict) -> str:
    """Human-oriented one-screen summary of a report dict."""
    lines = [f"analysis: {'OK' if report['ok'] else 'FAIL'} "
             f"({report['meta'].get('config', '?')} config)"]
    m = report["meta"]
    if m.get("max_safe_session_samples"):
        lines.append(
            f"  session envelope: acc <= {m['acc_envelope'][1]} over "
            f"{m['envelope_samples']} samples; int32-safe up to "
            f"{m['max_safe_session_samples']} session samples")
    for name, s in report["targets"].items():
        leg = s["legality"]
        det = s["determinism"]
        parts = [f"legality {'ok' if leg['ok'] else 'FAIL'}"
                 f" ({sum(leg['legal_ops'].values())} scaled legal ops)"]
        if "intervals" in s:
            iv = s["intervals"]
            parts.append(
                f"intervals {'ok' if iv['ok'] else 'FAIL'} "
                f"(min headroom {iv['min_headroom_bits']} bits over "
                f"{iv['num_registers']} registers)")
        parts.append(f"determinism {'ok' if det['ok'] else 'FAIL'} "
                     f"({det['num_findings']} findings)")
        flag = "" if s["gate"] else " [informational]"
        lines.append(f"  {name}{flag}: " + "; ".join(parts))
        for v in s["legality"]["violations"][:3]:
            lines.append(f"    illegal op: {v['primitive']} at "
                         f"{v['path']}@{v['source']}")
        for v in s.get("intervals", {}).get("violations", [])[:3]:
            lines.append(f"    overflow: {v['name']} needs "
                         f"{v['required_bits']} bits "
                         f"(interval {v['interval']})")
    return "\n".join(lines)
