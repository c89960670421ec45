"""What the port records about itself: the spans and wave timings of its
tracer (``repro_torch.tracing``). The tracer records while a profiler is
active, so in a run with ``--trace 1`` its record is the rounds that
``trace.profile`` ran.

The readers of ``metrics/`` that use it return None where the port has no
tracer (an older port) or its record is empty.
"""

from __future__ import annotations

import importlib

# the calls whose children the stream readers keep apart
ADMISSION = ("server.open", "server.close")


def record(ctx: dict) -> dict | None:
    """The tracer's export (read once a run), or None."""
    if "program_record" not in ctx:
        try:
            tracing = importlib.import_module("repro_torch.tracing")
        except ImportError:
            rec = None
        else:
            rec = tracing.export()
            if not rec["spans"]:
                rec = None
        ctx["program_record"] = rec
    return ctx["program_record"]


def _ancestors(span: dict, by_id: dict):
    p = span["parent"]
    while p in by_id:
        span = by_id[p]
        yield span
        p = span["parent"]


def outermost(rec: dict, names, outside=()) -> list:
    """The spans named in ``names`` that no span named in ``names`` or
    ``outside`` encloses."""
    by_id = {s["id"]: s for s in rec["spans"]}
    stop = set(names) | set(outside)
    return [s for s in rec["spans"] if s["name"] in names
            and not any(a["name"] in stop for a in _ancestors(s, by_id))]


def host_ms(rec: dict, names, less=(), outside=()) -> float:
    """Host ms in the ``outermost`` spans named in ``names``, less the
    time of the spans named in ``less`` inside them."""
    by_id = {s["id"]: s for s in rec["spans"]}
    tops = outermost(rec, names, outside)
    top_ids = {s["id"] for s in tops}
    ns = sum(s["end_ns"] - s["start_ns"] for s in tops)
    for s in rec["spans"]:
        if s["name"] in less:
            up = list(_ancestors(s, by_id))
            if any(a["id"] in top_ids for a in up) \
                    and not any(a["name"] in less for a in up):
                ns -= s["end_ns"] - s["start_ns"]
    return ns * 1e-6


def stream_per_wave(ctx: dict, names, less=(), outside=()) -> float | None:
    """``host_ms`` per ``server.wave`` span of the record; None without
    a wave."""
    rec = record(ctx)
    waves = len(outermost(rec, ("server.wave",))) if rec else 0
    if not waves:
        return None
    return host_ms(rec, names, less, outside) / waves


def timed_waves(ctx: dict) -> list:
    """The waves the server timed with its events (none off the card)."""
    rec = record(ctx)
    return rec["waves"] if rec else []
