"""Spans inside the port, on the profiler's clock, and the card's time
between served waves.

A span is a named interval of host time: ``with tracing.span(name, key):``.
Spans nest (the span open when another opens is its parent) and carry a
key that joins the spans of one piece of work: the serving layer keys a
submit, the dispatch and waves that run it and the resolve that ends it by
the ``FeedTicket``'s serial. Finished spans go into a bounded buffer that
drops the oldest, with the timings of served waves that the server reads
from its own CUDA events (:func:`record_wave`). :func:`export` returns
both, on the Unix-epoch clock in ns that ``torch.profiler`` uses, so an
export lays over a profiler trace of the same run.

The tracer records while a ``torch.profiler`` started from Python is
active (as torch's own annotations do), or between :func:`enable` and
:func:`disable`. Off, a site costs two flag checks and a shared no-op
object. The port emits no
profiler ranges: a ``record_function`` range shows in the device trace as
an annotation, and costs ~50 times a site.

Spans nest per process, from one thread: the serving tier runs on the
caller's thread. The tracer is one per process, because the profiler that
switches it on is.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import time
from typing import Iterable, Optional

import torch

__all__ = ["enable", "disable", "recording", "reset", "span",
           "record_wave", "export", "split_gaps", "CAPACITY"]

CAPACITY = 65536            # spans (and wave timings) kept, newest last

# torch's own flag for fast checks from Python: set while a profiler
# started from Python runs (``torch.autograd._profiler_enabled()`` is the
# same answer at ~5 times the cost)
_ap = torch.autograd.profiler


class _Tracer:
    """The process's record: finished spans, open spans, wave timings."""

    __slots__ = ("on", "spans", "waves", "stack", "ids", "finished")

    def __init__(self):
        self.on = False
        # (id, name, start_ns, end_ns, parent id, key); perf_counter_ns
        self.spans: collections.deque = collections.deque(maxlen=CAPACITY)
        # (wave, key, host_ns, span_ms, gap_ms)
        self.waves: collections.deque = collections.deque(maxlen=CAPACITY)
        self.stack: list = []
        self.ids = itertools.count(1)
        self.finished = 0


_TRACER = _Tracer()


class _Span:
    __slots__ = ("name", "key", "tr", "id", "parent", "t0")

    def __init__(self, name: str, key):
        self.name, self.key = name, key

    def __enter__(self):
        tr = self.tr = _TRACER
        self.parent = tr.stack[-1] if tr.stack else None
        self.id = next(tr.ids)
        tr.stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tr = self.tr
        tr.stack.pop()
        tr.spans.append((self.id, self.name, self.t0, t1, self.parent,
                         self.key))
        tr.finished += 1
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, key=None):
    """A context manager timing ``name`` while the tracer records, else a
    shared no-op."""
    if _TRACER.on or _ap._is_profiler_enabled:
        return _Span(name, key)
    return _OFF


def recording() -> bool:
    """Whether spans are recorded now: a profiler is active, or
    :func:`enable` was called."""
    return _TRACER.on or _ap._is_profiler_enabled


def enable() -> None:
    """Record spans (and let the server time its waves) until
    :func:`disable`, with or without a profiler."""
    _TRACER.on = True


def disable() -> None:
    _TRACER.on = False


def reset() -> None:
    """Drop every recorded span and wave timing (at most ``CAPACITY`` of
    each are kept). Spans open now finish unrecorded."""
    global _TRACER
    on = _TRACER.on
    _TRACER = _Tracer()
    _TRACER.on = on


def record_wave(wave: int, key, host_ns: int, span_ms: float,
                gap_ms: Optional[float]) -> None:
    """A served wave's timing, read from its CUDA events: ``span_ms`` on
    the card from before its first copy to after its decisions were copied
    out, ``gap_ms`` from the previous timed wave's end to its start (None
    for the first of a run of timed waves), and ``host_ns``
    (``perf_counter_ns``) when its start event was enqueued."""
    _TRACER.waves.append((wave, key, host_ns, span_ms, gap_ms))


def _innermost(spans: Iterable[tuple]) -> list:
    """``(start, end, name)`` pieces, sorted and disjoint, giving each
    instant that nested ``(name, start, end)`` spans cover to the
    innermost of them."""
    out, stack, cur = [], [], None
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][0] <= s:
            end, outer = stack.pop()
            if cur < end:
                out.append((cur, end, outer))
                cur = end
        if stack and cur < s:
            out.append((cur, s, stack[-1][1]))
        stack.append((e, name))
        cur = s if cur is None else max(cur, s)
    while stack:
        end, outer = stack.pop()
        if cur < end:
            out.append((cur, end, outer))
            cur = end
    return out


def split_gaps(gaps: Iterable[tuple], spans: Iterable[tuple]) -> dict:
    """Share out host intervals ``gaps`` ``[(start, end), ...]`` among the
    innermost of the nested ``spans`` ``[(name, start, end), ...]`` that
    cover each instant; time under no span goes to ``"caller"``. Returns
    ``{name: total}`` in the intervals' unit: each gap's length exactly.

    On an export ``rec``, the card's gaps between waves split among the
    server's spans are ``split_gaps([(w["start_ns"] - w["gap_ms"] * 1e6,
    w["start_ns"]) for w in rec["waves"] if w["gap_ms"] is not None],
    [(s["name"], s["start_ns"], s["end_ns"]) for s in rec["spans"] if
    s["name"].startswith("server.")])``."""
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]
    out: dict = {}
    for gs, ge in gaps:
        if ge <= gs:
            continue
        covered = 0
        k = max(bisect.bisect_right(starts, gs) - 1, 0)
        for ps, pe, name in pieces[k:]:
            if ps >= ge:
                break
            o = min(pe, ge) - max(ps, gs)
            if o > 0:
                out[name] = out.get(name, 0) + o
                covered += o
        out["caller"] = out.get("caller", 0) + (ge - gs) - covered
    return out


def export() -> dict:
    """The record, times on the Unix-epoch clock in ns:

    - ``spans``: ``{id, name, start_ns, end_ns, parent, key, self_ns}``
      in the order they finished; ``self_ns`` is the duration less its
      recorded children's;
    - ``waves``: ``{wave, key, start_ns, span_ms, gap_ms}``, ``start_ns``
      when the wave's start event was enqueued (a gap, laid on the host
      clock, is the interval of ``gap_ms`` that ends there: see
      :func:`split_gaps`);
    - ``dropped``: spans finished but no longer kept;
    - ``anchor``: the (``perf_counter_ns``, ``time_ns``) pair the times
      were converted by.
    """
    tr = _TRACER
    pc0 = time.perf_counter_ns()
    epoch = time.time_ns()
    pc = (pc0 + time.perf_counter_ns()) // 2
    off = epoch - pc
    spans = list(tr.spans)
    waves = list(tr.waves)
    inner: dict = {}
    for _, _, t0, t1, parent, _ in spans:
        if parent is not None:
            inner[parent] = inner.get(parent, 0) + t1 - t0
    return {
        "clock": "unix_ns",
        "anchor": {"perf_counter_ns": pc, "time_ns": epoch},
        "spans": [{"id": i, "name": n, "start_ns": t0 + off,
                   "end_ns": t1 + off, "parent": p, "key": k,
                   "self_ns": t1 - t0 - inner.get(i, 0)}
                  for i, n, t0, t1, p, k in spans],
        "waves": [{"wave": w, "key": k, "start_ns": h + off,
                   "span_ms": s, "gap_ms": g} for w, k, h, s, g in waves],
        "dropped": tr.finished - len(spans),
    }
