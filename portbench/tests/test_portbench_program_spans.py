"""The readers of the port's own spans and wave timings: nothing where the
port has no tracer or it recorded nothing, and the expected numbers from a
hand-built record."""

import sys

import pytest

from portbench import run

STREAM = ("admit_host_ms.stream", "submit_host_ms.stream",
          "resolve_host_ms.stream", "step_gap_ms.stream",
          "step_span_ms.stream")
CLIPS = ("readout_host_ms.clips",)
MS = 1_000_000


def spans(*rows):
    """Export rows from (id, name, start ms, end ms, parent)."""
    return [{"id": i, "name": n, "start_ns": int(a * MS),
             "end_ns": int(b * MS), "parent": p, "key": None, "self_ns": 0}
            for i, n, a, b, p in rows]


STREAM_RECORD = {
    "spans": spans(
        (1, "server.open", 0, 3, None),
        (2, "server.slot_write", 0.5, 1, 1),
        (3, "server.flush", 1, 2.5, 1),
        (4, "server.resolve", 1, 2, 3),        # a flush's: admission's
        (5, "server.close", 3, 4, None),
        (6, "server.submit", 5, 9, None),
        (7, "server.dispatch", 5.5, 8.5, 6),
        (8, "server.wave", 5.5, 8.5, 7),
        (9, "server.stage", 6, 7, 8),
        (10, "server.wait", 6, 6.5, 9),
        (11, "server.submit", 10, 12, None),
        (12, "server.dispatch", 10.5, 11.5, 11),
        (13, "server.wave", 10.5, 11.5, 12),
        (14, "server.resolve", 13, 16, None),
        (15, "server.wait", 14, 15, 14)),
    "waves": [{"wave": 1, "key": 1, "start_ns": 0, "span_ms": 1.5,
               "gap_ms": None},
              {"wave": 2, "key": 2, "start_ns": 0, "span_ms": 2.5,
               "gap_ms": 4.0}],
    "dropped": 0}

CLIPS_RECORD = {
    "spans": spans(
        (1, "pipeline.features", 0, 1, 3),
        (2, "pipeline.readout", 1, 2, 3),
        (3, "pipeline.apply", 0, 2, None),
        (4, "fixed.bank", 3, 4, 6),
        (5, "fixed.readout", 4, 7, 6),
        (6, "fixed.infer_q", 3, 7, None)),
    "waves": [], "dropped": 0}

WANT = {"admit_host_ms.stream": (3 + 1) / 2,
        "submit_host_ms.stream": (4 - 0.5 + 2) / 2,
        "resolve_host_ms.stream": (3 - 1) / 2,
        "step_gap_ms.stream": 4.0,
        "step_span_ms.stream": (1.5 + 2.5) / 2,
        "readout_host_ms.clips": (1 + 3) / 2}


def test_the_readers_are_the_benchmarks():
    names = {m["name"] for m in run.benchmark()["per_layer"]}
    assert set(STREAM + CLIPS) <= names


@pytest.mark.parametrize("metric", STREAM + CLIPS)
def test_no_tracer_no_reading(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert run.reader(metric)({}) is None


@pytest.mark.parametrize("metric", STREAM + CLIPS)
def test_empty_record_no_reading(monkeypatch, metric):
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "export", lambda: {
        "spans": [], "waves": [], "dropped": 0})
    assert run.reader(metric)({}) is None


@pytest.mark.parametrize("metric", STREAM + CLIPS)
def test_reading_of_a_record(monkeypatch, metric):
    from repro_torch import tracing
    rec = STREAM_RECORD if metric in STREAM else CLIPS_RECORD
    monkeypatch.setattr(tracing, "export", lambda: rec)
    assert run.reader(metric)({}) == pytest.approx(WANT[metric], abs=1e-12)
    # a stream reader finds no wave in a clips record, and the clips
    # reader no call in a stream record
    other = CLIPS_RECORD if metric in STREAM else STREAM_RECORD
    monkeypatch.setattr(tracing, "export", lambda: other)
    assert run.reader(metric)({}) is None
