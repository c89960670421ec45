"""The port's tracer (``repro_torch.tracing``) and the serving counters it
sits beside, on the CPU: when it records, how spans nest and are keyed,
that tracing changes no decision or register, the profiler's clock, the
bounded buffer, the per-bucket sample counts and the split of the card's
gaps between waves among the spans."""

import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.esc10_mp import make_pipeline
from repro_torch.core import fixed
from repro_torch.serving import StreamServer

SERVER_KW = dict(capacity=4, max_chunk=64, min_chunk=16)
_PIPES: dict = {}


@pytest.fixture(autouse=True)
def clean_tracer():
    """One thread (small ops under several test workers) and a tracer that
    starts empty and off, and is left so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    tracing.reset()
    try:
        yield
    finally:
        tracing.disable()
        tracing.reset()
        torch.set_num_threads(n)


def pipe(numerics="float", impl="pallas"):
    key = (numerics, impl)
    if key not in _PIPES:
        _PIPES[key] = make_pipeline(
            smoke=True, device="cpu", stream_impl=impl, numerics=numerics,
            fixed_amax=3.0 if numerics == "fixed" else None)
    return _PIPES[key]


def traffic(seed=0):
    """Three rounds over three streams: splits, several buckets."""
    x = np.random.default_rng(seed).standard_normal((3, 400)).astype(
        np.float32)
    return [[("a", x[0, 0:40]), ("b", x[1, 0:7]), ("c", x[2, 0:100])],
            [("b", x[1, 7:71]), ("c", x[2, 100:101])],
            [("a", x[0, 40:200]), ("c", x[2, 101:140])]]


def serve(p, rounds, mode="feed"):
    """Serve ``rounds`` on a fresh server: (results, registers, server)."""
    srv = StreamServer(p, **SERVER_KW)
    for sid in ("a", "b", "c"):
        srv.open(sid)
    out = []
    for feeds in rounds:
        if mode == "feed":
            out.extend(srv.feed(feeds))
        else:
            ticket = srv.submit(feeds)
            res = srv.poll(ticket)
            if res is None:
                srv.drain()
                res = ticket.results
            out.extend(res)
    srv.close("b")
    srv.open("b")
    out.extend(srv.feed([("b", rounds[0][1][1])]))
    return ([(r.session_id, r.label, r.confidence, r.samples_seen)
             for r in out], [t.clone() for t in srv.state.tensors()], srv)


def names(rec):
    return [s["name"] for s in rec["spans"]]


def no_profiler_ranges(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the port opened a profiler range")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch):
    no_profiler_ranges(monkeypatch)
    p = pipe("fixed")
    assert not tracing.recording()
    serve(p, traffic())
    p.apply(np.zeros((2, 256), np.float32))
    prog = p.fixed_program()
    fixed.infer_q(prog, fixed.quantize_signal(prog, torch.zeros(2, 256)))
    rec = tracing.export()
    assert rec["spans"] == [] and rec["waves"] == []
    assert rec["dropped"] == 0
    # on, the port still opens no profiler range
    tracing.enable()
    serve(p, traffic())
    assert "server.wave" in names(tracing.export())


def test_spans_nest_and_share_the_tickets_key():
    tracing.enable()
    srv = StreamServer(pipe(), **SERVER_KW)
    srv.open("a")
    srv.open("b")
    x = np.ones(100, np.float32)
    srv.feed([("a", x), ("b", x[:20])])        # 2 waves: 100 splits at 64
    ticket = srv.submit([("a", x[:10])])
    srv.poll(ticket) or srv.drain()
    srv.close("a")
    rec = tracing.export()
    by_id = {s["id"]: s for s in rec["spans"]}

    def parent(s):
        return by_id[s["parent"]]["name"] if s["parent"] else None

    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
        assert 0 <= s["self_ns"] <= s["end_ns"] - s["start_ns"]
        if s["parent"]:
            up = by_id[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]
    want = {"server.open": None, "server.close": None,
            "server.submit": None, "server.dispatch": None,
            "server.wave": "server.dispatch",
            "server.stage": "server.wave", "server.launch": "server.wave",
            "server.copy_out": "server.wave", "server.resolve": None,
            # the wave's one apply; a restore applies what is pending
            "server.slot_write": {"server.launch", "server.open"}}
    seen = set()
    for s in rec["spans"]:
        w = want.get(s["name"], "unlisted")
        if w == "unlisted":
            continue
        seen.add(s["name"])
        got = parent(s)
        assert (got in w) if isinstance(w, set) else got == w, s
    assert seen == set(want)
    # per ticket: its submit, its dispatch, waves and resolve share a key
    keys = [s["key"] for s in rec["spans"] if s["name"] == "server.submit"]
    assert len(keys) == 2 and keys[0] < keys[1]
    assert ticket.key == keys[1]
    for k, n_waves in zip(keys, (2, 1)):
        mine = [s["name"] for s in rec["spans"] if s["key"] == k]
        assert mine.count("server.wave") == n_waves
        assert mine.count("server.dispatch") == 1
        assert mine.count("server.resolve") == 1
    for s in rec["spans"]:
        if s["name"] in ("server.open", "server.close", "server.slot_write"):
            assert s["key"] is None


@pytest.mark.parametrize("mode", ["feed", "submit"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_tracing_changes_no_decision_or_register(numerics, impl, mode):
    p = pipe(numerics, impl)
    rounds = traffic(1)
    off, regs_off, srv_off = serve(p, rounds, mode)
    tracing.enable()
    on, regs_on, srv_on = serve(p, rounds, mode)
    assert on == off
    for a, b in zip(regs_on, regs_off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert srv_on.stats() == srv_off.stats()
    assert "server.wave" in names(tracing.export())


def test_recorded_under_a_profiler_on_its_clock():
    from torch.profiler import ProfilerActivity, profile
    p = pipe()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 512)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        p.apply(x)
    assert not tracing.recording()
    rec = tracing.export()
    assert names(rec) == ["pipeline.features", "pipeline.readout",
                          "pipeline.apply"]
    assert abs(rec["anchor"]["time_ns"] - time.time_ns()) < 10**9
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [(t0 + int(e.time_range.start * 1000),
            t0 + int(e.time_range.end * 1000), e.name)
           for e in prof.events() if e.name.startswith("aten::")]
    assert ops
    for s in rec["spans"]:
        inside = [n for a, b, n in ops
                  if s["start_ns"] <= a and b <= s["end_ns"]]
        assert inside, s["name"]


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 8)
    tracing.reset()
    tracing.enable()
    for i in range(20):
        with tracing.span(f"s{i}"):
            pass
        tracing.record_wave(i, None, i, 1.0, None)
    rec = tracing.export()
    assert names(rec) == [f"s{i}" for i in range(12, 20)]
    assert [w["wave"] for w in rec["waves"]] == list(range(12, 20))
    assert rec["dropped"] == 12


@pytest.mark.parametrize("together", [True, False])
def test_stats_count_valid_and_padded_samples(together):
    srv = StreamServer(pipe(), capacity=4, max_chunk=1024, min_chunk=128)
    lens = {"a": 100, "b": 300, "c": 2048}
    for sid in lens:
        srv.open(sid)
    reqs = [(sid, np.zeros(n, np.float32)) for sid, n in lens.items()]
    if together:
        srv.feed(reqs)
        # wave 1: 100, 300, 1024 in 1024; wave 2: c's second 1024
        valid, padded = {1024: 2448}, {1024: 3 * 1024 - 1424}
    else:
        for r in reqs:
            srv.feed([r])
        valid = {128: 100, 512: 300, 1024: 2048}
        padded = {128: 28, 512: 212, 1024: 0}
    st = srv.stats()
    assert st["bucket_valid_samples"] == valid
    assert st["bucket_padded_samples"] == padded
    assert st["waits"] == 0                   # no event to wait for here


def test_gap_split_sums_each_gap_exactly():
    spans = [("server.open", 100, 200), ("server.slot_write", 120, 140),
             ("server.flush", 150, 190), ("server.wait", 160, 170),
             ("server.submit", 300, 400), ("server.wave", 310, 390),
             ("server.stage", 310, 330)]
    gaps = [(90, 210), (250, 320), (395, 500)]
    got = tracing.split_gaps(gaps, spans)
    assert got == {"caller": 10 + 10 + 50 + 100, "server.open": 20 + 10 + 10,
                   "server.slot_write": 20, "server.flush": 30,
                   "server.wait": 10, "server.submit": 10 + 5,
                   "server.stage": 10}
    assert sum(got.values()) == sum(b - a for a, b in gaps)
    assert tracing.split_gaps([(5, 5)], spans) == {}


class _Event:
    """A stand-in for a timed CUDA event: a time on the card, in ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_wave_timings_chain_only_across_timed_waves():
    srv = StreamServer(pipe(), **SERVER_KW)
    e = [_Event(t) for t in (0.0, 2.0, 5.0, 6.5, 20.0, 21.0)]
    # waves 1 and 2 back to back; wave 4 follows an untimed wave 3
    srv._timed = [(1, 7, e[0], e[1], 10, False), (2, 7, e[2], e[3], 20, True)]
    srv._read_timings()
    srv._timed = [(4, 8, e[4], e[5], 40, False)]
    srv._read_timings()
    rec = tracing.export()
    assert [(w["wave"], w["key"], w["span_ms"], w["gap_ms"])
            for w in rec["waves"]] == [(1, 7, 2.0, None), (2, 7, 1.5, 3.0),
                                       (4, 8, 1.0, None)]
    assert srv._last_end is e[5]
    assert srv._timing_pool == [e[0], e[1], e[2], e[3], e[4]]
