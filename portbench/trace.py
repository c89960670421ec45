"""Spans and the device trace.

``Spans`` times the benchmark's own calls into the port on the host clock
(and names them in the profiler's trace). ``profile`` runs a few units of
work (served waves, batches) under ``torch.profiler`` and reduces the
trace: device time by kernel name, the busy and idle time of the traced
window, and the idle gaps named by the span the host was in.
"""

from __future__ import annotations

import contextlib
import time

PREFIX = "portbench."


class Spans:
    """Host-clock durations of named spans, kept in memory."""

    def __init__(self):
        self.seconds: dict = {}
        self.marked = False            # name spans in a profiler's trace

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.marked:
            import torch
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(run_units, units: int, spans: Spans) -> dict | None:
    """Run ``run_units(units)`` (which ends synchronized) under the
    profiler and reduce its trace. Returns None where the profiler saw no
    device activity (then no device metric is read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    spans.marked = True
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(PREFIX + "traced"):
                run_units(units)
                torch.cuda.synchronize()
    finally:
        spans.marked = False
    window, host, dev = None, [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the spans' own device-side annotations are not operations
            if not e.name.startswith(PREFIX):
                dev.append((s, t, e.name))
        elif e.name == PREFIX + "traced":
            window = (s, t)
        elif e.name.startswith(PREFIX):
            host.append((s, t, e.name[len(PREFIX):]))
    if window is None or not dev:
        return None
    w0, w1 = window
    dev = [(max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1]
    busy = _union([(s, t) for s, t, _ in dev])
    by_name: dict = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    gaps: dict = {}
    edges = [w0] + [x for b in busy for x in b] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t <= s:
            continue
        mid = (s + t) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        # the innermost span the host was in at the gap's middle
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "other"
        gaps[name] = gaps.get(name, 0.0) + (t - s) * 1e-6
    return dict(units=units, window_s=(w1 - w0) * 1e-6,
                busy_s=sum(t - s for s, t in busy) * 1e-6,
                by_name=by_name, idle_by_span=gaps)


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def breakdown(tr: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations that took
    most time and the ten spans the host was in during the most idle
    time, seconds over the traced window."""
    top = sorted(tr["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
