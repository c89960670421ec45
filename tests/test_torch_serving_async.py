"""The port's serving tier against the reference's, on the CPU.

The reference pipeline (the esc10-mp smoke bank, a 4-class classifier and
random standardization) is built with the JAX package under
``jax.threefry_partitionable(False)`` and carried into the port through
``bridge.pipeline_from_numpy``. The same numpy feeds go through the
reference's ``StreamServer`` (``stream_impl="xla"``, which the reference
holds bit for bit to its Pallas path) and the port's (its plain stream
cascade here, the CUDA kernel's plain version). Gates: float labels equal
and confidences / p within 1e-5; fixed-point confidences, p codes and
every register exactly equal. Port-only checks (async against sync)
are bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.esc10_mp import FILTERBANK_SMOKE as REF_SMOKE
from repro.core import kernel_machine as km_ref
from repro.core import pipeline as pl_ref
from repro.core.filterbank import FilterBank as RefFilterBank
from repro.core.pipeline import InFilterPipeline as RefPipeline
from repro.serving import StreamServer as RefServer
from repro.serving import make_batched_step as ref_make_step
from repro_torch import bridge
from repro_torch.core import pipeline as pl
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving import (FeedRequest, StreamServer,
                                 make_batched_step)
from torch_mesh_ranks import one_rank_group

TOL = 1e-5
LENS = [5, 16, 33, 64, 100]     # buckets 16 / 32 / 64, 100 splits
SERVER_KW = dict(capacity=4, max_chunk=64, min_chunk=16)
_CACHE: dict = {}


def reference(numerics: str):
    """The reference pipeline and its shared compiled step."""
    key = ("ref", numerics)
    if key not in _CACHE:
        cfg = REF_SMOKE._replace(stream_impl="xla")
        if numerics == "fixed":
            cfg = cfg._replace(numerics="fixed", fixed_amax=3.0)
        P = cfg.num_filters
        with jax.threefry_partitionable(False):
            fb = RefFilterBank(cfg)
            clf = km_ref.init_params(jax.random.PRNGKey(0), P, 4)
            mu = jax.random.normal(jax.random.PRNGKey(1), (P,)) * 0.1 + 1.0
            sigma = jnp.abs(jax.random.normal(jax.random.PRNGKey(2),
                                              (P,))) + 0.5
        pipe = RefPipeline(cfg, fb.bp_by_octave, fb.lp_filters, mu, sigma,
                           clf)
        _CACHE[key] = (pipe, ref_make_step(pipe))
    return _CACHE[key]


def ref_jit(numerics: str, name: str):
    """A jitted closure over the reference pipeline: ``apply`` (session
    step with valid counts) or the deprecated cohort ``step``."""
    key = ("jit", numerics, name)
    if key not in _CACHE:
        ref, _ = reference(numerics)
        fn = ((lambda c, s, v: ref.apply(c, s, valid=v)) if name == "apply"
              else (lambda s, c: ref.step(s, c)))
        _CACHE[key] = jax.jit(fn)
    return _CACHE[key]


def port(numerics: str, impl: str = "pallas"):
    """The port's pipeline carried over from :func:`reference`, and one
    shared step."""
    key = ("port", numerics, impl)
    if key not in _CACHE:
        ref, _ = reference(numerics)
        pipe = bridge.pipeline_from_numpy(
            ref.config, [np.asarray(t) for t in ref.bp_taps],
            [np.asarray(t) for t in ref.lp_taps], np.asarray(ref.mu),
            np.asarray(ref.sigma), [np.asarray(a) for a in ref.clf],
            device="cpu", stream_impl=impl)
        _CACHE[key] = (pipe, make_batched_step(pipe))
    return _CACHE[key]


def ref_server(numerics="float", **kw):
    pipe, step = reference(numerics)
    return RefServer(pipe, step_fn=step, **{**SERVER_KW, **kw})


def port_server(numerics="float", impl="pallas", **kw):
    pipe, step = port(numerics, impl)
    return StreamServer(pipe, step_fn=step, **{**SERVER_KW, **kw})


def feeds(rng, ids, n):
    return [(ids[int(rng.integers(len(ids)))],
             rng.standard_normal(int(rng.choice(LENS))).astype(np.float32))
            for _ in range(n)]


def key_of(results):
    return [(r.session_id, r.label, r.samples_seen) for r in results]


def assert_results(got, want, numerics, msg=""):
    assert key_of(got) == key_of(want), msg
    for g, w in zip(got, want):
        if numerics == "fixed":
            assert g.confidence == w.confidence, msg
        else:
            assert abs(g.confidence - w.confidence) <= TOL, msg


def assert_registers(port_state, ref_state, numerics, msg=""):
    for a, b in zip(port_state.tensors(), jax.tree.leaves(ref_state)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, msg
        if numerics == "fixed" or a.dtype != np.float32:
            np.testing.assert_array_equal(a, b, err_msg=msg)
        else:
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                       err_msg=msg)


def assert_same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def assert_same_bits(sa, sb, msg=""):
    for a, b in zip(sa.tensors(), sb.tensors()):
        assert torch.equal(a, b), msg


def readouts(port_srv, ref_srv):
    """Both servers' p for every slot (a pure readout, no register moves)."""
    S = port_srv.capacity
    p, _ = port_srv.pipeline.apply(torch.zeros(S, 0), port_srv.state)
    q, _ = ref_srv.pipeline.apply(jnp.zeros((S, 0)), ref_srv.state)
    return p.numpy(), np.asarray(q)


@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_served_decisions_match_reference(numerics):
    """Rounds with splits, a bucket change each round, and slots opened
    and closed between waves."""
    rng = np.random.default_rng(11)
    port_srv, ref_srv = port_server(numerics), ref_server(numerics)
    if numerics == "fixed":        # one compiled program, field by field
        assert_same_tree(
            bridge.program_to_numpy(port_srv.pipeline.fixed_program()),
            bridge.program_to_numpy(ref_srv.pipeline.fixed_program()))
    schedule = [("open", "a"), ("open", "b"), ("open", "c"), ("feed", 4),
                ("close", "b"), ("feed", 3), ("open", "d"), ("feed", 5),
                ("open", "b"), ("close", "a"), ("feed", 4)]
    open_ids = []
    for op, arg in schedule:
        if op == "open":
            port_srv.open(arg)
            ref_srv.open(arg)
            open_ids.append(arg)
        elif op == "close":
            port_srv.close(arg)
            ref_srv.close(arg)
            open_ids.remove(arg)
        else:
            reqs = feeds(rng, open_ids, arg)
            assert_results(port_srv.feed(reqs), ref_srv.feed(reqs), numerics)
    assert port_srv.stats()["buckets"] == ref_srv.stats()["buckets"]
    assert_registers(port_srv.state, ref_srv.state, numerics)
    p, q = readouts(port_srv, ref_srv)
    if numerics == "fixed":
        np.testing.assert_array_equal(p, q)
    else:
        np.testing.assert_allclose(p, q, atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_async_equals_sync_bit_for_bit(numerics, seed):
    """Random submit batches resolved by one drain (a different wave
    composition) against one synchronous feed of the same requests."""
    rng = np.random.default_rng(seed)
    ids = ["a", "b", "c"]
    reqs = feeds(rng, ids, int(rng.integers(3, 9)))
    sync, async_ = port_server(numerics), port_server(numerics)
    for srv in (sync, async_):
        for sid in ids:
            srv.open(sid)
    want = sync.feed(reqs)
    tickets, i = [], 0
    while i < len(reqs):
        k = int(rng.integers(1, len(reqs) - i + 1))
        tickets.append(async_.submit(reqs[i:i + k]))
        i += k
    async_.drain()
    got = [r for t in tickets for r in t.results]
    assert [(r.session_id, r.label, r.confidence, r.samples_seen)
            for r in got] == [(r.session_id, r.label, r.confidence,
                               r.samples_seen) for r in want], seed
    assert_same_bits(sync.state, async_.state, f"seed={seed}")


def test_submit_poll_drain_semantics():
    srv = port_server()
    srv.open("a")
    srv.open("b")
    rng = np.random.default_rng(0)
    t1 = srv.submit([("a", rng.standard_normal(33).astype(np.float32))])
    t2 = srv.feed_async([("b", rng.standard_normal(16).astype(np.float32)),
                         FeedRequest("a", rng.standard_normal(5))])
    assert not t1.done and srv.poll(t1) is None   # nothing dispatched
    assert srv.stats()["queued_requests"] == 3
    srv.drain()
    assert t1.done and t2.done
    assert [r.session_id for r in t2.results] == ["b", "a"]
    assert t2.results[1].samples_seen == 33 + 5
    assert srv.poll(t2) == t2.results
    s = srv.stats()
    assert (s["queued_requests"], s["unresolved_requests"],
            s["inflight_waves"]) == (0, 0, 0)
    t0 = srv.submit([])
    assert t0.done and t0.results == []
    ok = np.zeros(16, np.float32)
    with pytest.raises(KeyError, match="session 'ghost' is not open"):
        srv.submit([("a", ok), ("ghost", ok)])
    with pytest.raises(ValueError, match="1-D"):
        srv.submit([("a", np.zeros((2, 16), np.float32))])
    assert srv.stats()["queued_requests"] == 0    # nothing half-queued


def test_watermark_deadline_and_lifecycle_flush(tmp_path):
    srv = port_server(coalesce_watermark=2, checkpoint_dir=str(tmp_path))
    srv.open("a")
    srv.open("b")
    x = np.ones(16, np.float32)
    srv.submit([("a", x)])
    assert (srv.stats()["queued_requests"], srv.steps_run) == (1, 0)
    t = srv.submit([("b", x)])
    assert srv.stats()["queued_requests"] == 0 and srv.steps_run == 1
    assert srv.stats()["inflight_waves"] == 1
    assert srv.poll(t) is not None                # the CPU is done at once
    late = port_server(coalesce_deadline=0.0)
    late.open("a")
    t = late.submit([("a", x)])                   # deadline: dispatched
    assert late.steps_run == 1 and late.poll(t)[0].samples_seen == 16
    t = srv.submit([("a", np.ones(40, np.float32))])
    srv.close("a", checkpoint=True)               # absorbs the queued feed
    assert t.done and t.results[0].samples_seen == 56
    srv.open("a")
    assert srv.session("a").samples_seen == 56


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_churn_with_eviction_matches_reference(numerics, seed, tmp_path):
    """Random open / feed / evict / close through the port's async path
    (capacity 3 of 4 streams: opening evicts the least-recently-fed
    session) against the reference's synchronous server."""
    rng = np.random.default_rng(seed)
    ids = [f"s{i}" for i in range(4)]
    clock = [0.0]
    tick = lambda: clock[0]   # noqa: E731
    ref = ref_server(numerics, capacity=3, clock=tick,
                     checkpoint_dir=str(tmp_path / f"ref{seed}"))
    srv = port_server(numerics, capacity=3, clock=tick,
                      checkpoint_dir=str(tmp_path / f"port{seed}"))
    open_set, tickets, expected = set(), [], []
    for _ in range(24):
        clock[0] += 1.0
        op = rng.choice(["open", "feed", "evict", "close"],
                        p=[0.3, 0.45, 0.15, 0.1])
        sid = ids[int(rng.integers(len(ids)))]
        if op == "open" and sid not in open_set:
            ref.open(sid)
            srv.open(sid)
            open_set = {s.id for s in ref.sessions()}
            assert open_set == {s.id for s in srv.sessions()}
        elif op == "feed" and open_set:
            batch = feeds(rng, sorted(open_set), int(rng.integers(1, 4)))
            expected.append(ref.feed(batch))
            tickets.append(srv.submit(batch))
            if rng.random() < 0.4:
                srv.drain()
        elif op in ("evict", "close") and sid in open_set:
            getattr(ref, op)(sid)
            getattr(srv, op)(sid)
            open_set.discard(sid)
    srv.drain()
    for want, t in zip(expected, tickets):
        assert_results(t.results, want, numerics, f"seed={seed}")
    for sid in open_set:
        a, b = srv.session(sid), ref.session(sid)
        assert (a.slot, a.samples_seen, len(a.history)) == \
            (b.slot, b.samples_seen, len(b.history))
    assert_registers(srv.state, ref.state, numerics, f"seed={seed}")


@pytest.mark.parametrize("parked_by", ["reference", "port"])
def test_parked_session_resumes_in_the_other_package(parked_by, tmp_path):
    """Fixed point, bit for bit: a session parked by one package's server
    reopens in the other's and goes on as if it had never left."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(300).astype(np.float32)
    y = rng.standard_normal(300).astype(np.float32)
    d = str(tmp_path)
    first, second = ((ref_server, port_server) if parked_by == "reference"
                     else (port_server, ref_server))
    a = first("fixed", checkpoint_dir=d)
    a.open("bg")
    a.open("mic")
    a.feed([("mic", x[:100]), ("bg", y[:70])])
    a.feed([("mic", x[100:160])])
    history = a.session("mic").history
    a.evict("mic")
    b = second("fixed", checkpoint_dir=d)
    b.open("other")                          # the session moves slot
    resumed = b.open("mic")
    assert resumed.samples_seen == 160
    assert [tuple(vars(d).values()) for d in resumed.history] == \
        [tuple(vars(d).values()) for d in history]
    got = b.feed([("mic", x[160:])])
    # the same stream, never parked
    ref = ref_server("fixed")
    ref.open("mic")
    ref.feed([("mic", x[:100])])
    ref.feed([("mic", x[100:160])])
    want = ref.feed([("mic", x[160:])])
    assert_results(got, want, "fixed")
    row = pl.take_slot if isinstance(b, StreamServer) else pl_ref.take_slot
    for g, w in zip(jax.tree.leaves(row(b.state, b.session("mic").slot)),
                    jax.tree.leaves(pl_ref.take_slot(ref.state, 0))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _poison_scenarios(srv):
    """The reference's poisoned-server contract, run on ``srv``: returns
    the poisoned description after a failing wave 1 and a flaky wave 2."""
    srv.open("a")
    srv.feed([("a", np.zeros(32, np.float32))])
    boom = RuntimeError("device OOM")

    def bad_step(p, state, chunk, valid):
        raise boom

    real_step, srv._step = srv._step, bad_step
    with pytest.raises(RuntimeError, match=r"wave 1") as ei:
        srv.feed([("a", np.zeros(160, np.float32))])
    assert ei.value.__cause__ is boom
    first = srv.stats()["poisoned"]              # stats() does not raise
    for call in (lambda: srv.feed([("a", np.zeros(16, np.float32))]),
                 lambda: srv.submit([("a", np.zeros(16, np.float32))]),
                 lambda: srv.open("b"), lambda: srv.drain()):
        with pytest.raises(RuntimeError, match="poisoned") as ei:
            call()
        assert "wave 1" in str(ei.value)
    srv2 = type(srv)(srv.pipeline, step_fn=real_step, **SERVER_KW)
    srv2.open("a")
    calls = {"n": 0}

    def flaky_step(p, state, chunk, valid):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("transient")
        return real_step(p, state, chunk, valid)

    srv2._step = flaky_step
    with pytest.raises(RuntimeError, match=r"wave 2"):
        srv2.feed([("a", np.zeros(192, np.float32))])
    with pytest.raises(RuntimeError, match="poisoned"):
        srv2.feed([("a", np.zeros(16, np.float32))])
    return first, srv2.stats()["poisoned"]


def test_poisoned_server_contract_matches_reference():
    got = _poison_scenarios(port_server())
    want = _poison_scenarios(ref_server())
    assert got == want
    assert got[0] == ("step raised RuntimeError on wave 1 of a feed() call "
                      "(bucket 64, sessions ['a'])")


def _error_of(call):
    try:
        call()
    except Exception as e:          # noqa: BLE001 - compared below
        return type(e), str(e)
    return None


def test_lifecycle_errors_match_reference(tmp_path):
    """Backpressure, eviction and lookup errors: the reference's types and
    messages."""
    for numerics in ("float",):
        out = {}
        for name, make in (("ref", ref_server), ("port", port_server)):
            clock = [0.0]
            full = make(numerics, capacity=1)
            idle = make(numerics, capacity=1, evict_after=5.0,
                        clock=lambda: clock[0],
                        checkpoint_dir=str(tmp_path / name))
            errs = []
            full.open("a")
            idle.open("a")
            clock[0] = 2.0
            errs.append(_error_of(lambda: full.open("b")))
            errs.append(_error_of(lambda: idle.open("b")))
            errs.append(_error_of(lambda: full.evict("a")))
            errs.append(_error_of(lambda: full.evict("ghost")))
            errs.append(_error_of(lambda: full.close("ghost")))
            errs.append(_error_of(lambda: full.open("a")))
            errs.append(_error_of(lambda: full.open("bad id")))
            errs.append(_error_of(lambda: full.feed([("a", np.zeros(0))])))
            clock[0] = 9.0
            idle.open("b")                       # a idle 9 s: evicted
            errs.append((idle.is_open("a"), idle.is_open("b")))
            errs.append(_error_of(lambda: idle.open("a")))   # b idle 0 s
            errs.append([s.id for s in idle.sessions()])
            out[name] = errs
        assert out["port"] == out["ref"]
        assert all(e is not None for e in out["port"])


# the port's own counters, which the reference does not keep
PORT_STATS = {"device", "bucket_valid_samples", "bucket_padded_samples",
              "waits", "admission_applies", "slots_admitted"}


def test_stats_keys_match_reference():
    got, want = port_server(impl="xla").stats(), ref_server().stats()
    assert set(got) - PORT_STATS == set(want)
    assert got["device"] == "cpu"
    assert {k: got[k] for k in want} == want


def test_step_refuses_foreign_inputs_and_states(tmp_path):
    pipe, step = port("float")
    srv = port_server()
    chunk, valid = step.inputs(srv.state, 16)
    with pytest.raises(ValueError, match="static inputs"):
        step(pipe, srv.state, chunk.clone(), valid)
    with pytest.raises(ValueError, match="not bound"):
        step(pipe, pipe.init_session(4), chunk, valid)
    other, _ = port("fixed")
    with pytest.raises(ValueError, match="another pipeline"):
        StreamServer(other, step_fn=step)
    with pytest.raises(TypeError, match="DeviceMesh"):
        StreamServer(pipe, mesh=object())
    # a mesh (one gloo rank) is taken: its server decides and steps as one
    # without, bit for bit
    with one_rank_group(tmp_path):
        meshed = StreamServer(pipe, step_fn=step,
                              mesh=make_host_mesh(device="cpu"), **SERVER_KW)
        plain = port_server()
        rng = np.random.default_rng(4)
        for server in (meshed, plain):
            server.open("m")
            server.open("n")
        for reqs in [feeds(rng, ["m", "n"], 5) for _ in range(2)]:
            assert key_of(meshed.feed(reqs)) == key_of(plain.feed(reqs))
        for a, b in zip(meshed.state.tensors(), plain.state.tensors()):
            assert torch.equal(a, b)
    # one state, written in place; p is the bucket's one output buffer
    state = srv.state
    srv.open("a")
    srv.feed([("a", np.ones(16, np.float32))])
    p1 = step(pipe, state, chunk, valid)[1]
    assert srv.state is state and p1 is step(pipe, state, chunk, valid)[1]
    assert srv.step_counts()["eager_runs"] == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_random_slot_lifecycles_match_reference(seed):
    """The reference's random-slot-lifecycle harness
    (tests/test_streaming_parity.py) on the port's session step: S slots on
    random open / feed / close schedules with garbage in the rows that are
    not fed; the port's two cascades bit for bit each other, and the
    reference's step within 1e-5."""
    ref, _ = reference("float")
    px, pk = port("float", "xla")[0], port("float", "pallas")[0]
    menu = [7, 16, 64]
    for _ in (0,):
        rng = np.random.default_rng(seed)
        S = 3
        total = [int(rng.integers(40, 120)) for _ in range(S)]
        audio = [rng.standard_normal(t).astype(np.float32) for t in total]
        fed, opened = [0] * S, [False] * S
        sr = pl_ref.set_active(ref.init_session(S), jnp.arange(S), False)
        sx = pl.set_active(px.init_session(S), list(range(S)), False)
        sk = pl.set_active(pk.init_session(S), list(range(S)), False)
        for _ in range(14):
            slot = int(rng.integers(S))
            if not opened[slot]:
                opened[slot] = True
                sr = pl_ref.set_active(sr, jnp.asarray([slot]), True)
                pl.set_active(sx, [slot], True)
                pl.set_active(sk, [slot], True)
                continue
            take = min(int(rng.choice(menu)), total[slot] - fed[slot])
            L = min((m for m in menu if m >= max(take, 1)), default=64)
            chunk = (rng.standard_normal((S, L)) * 50.0).astype(np.float32)
            chunk[slot, :take] = audio[slot][fed[slot]:fed[slot] + take]
            valid = np.zeros(S, np.int32)
            valid[slot] = take
            fed[slot] += take
            q, sr = ref_jit("float", "apply")(jnp.asarray(chunk), sr,
                                              jnp.asarray(valid))
            p_x, sx = px.apply(chunk, sx, valid=torch.from_numpy(valid))
            p_k, sk = pk.apply(chunk, sk, valid=torch.from_numpy(valid))
            assert torch.equal(p_x, p_k), seed
            np.testing.assert_allclose(p_k.numpy(), np.asarray(q), atol=TOL,
                                       rtol=0, err_msg=f"seed={seed}")
            if fed[slot] == total[slot]:
                sr = pl_ref.set_active(sr, jnp.asarray([slot]), False)
                pl.set_active(sx, [slot], False)
                pl.set_active(sk, [slot], False)
        assert_same_bits(sx, sk, f"seed={seed}")
        assert_registers(sk, sr, "float", f"seed={seed}")


@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_deprecated_cohort_shims_match_reference(numerics):
    ref, _ = reference(numerics)
    pipe, _ = port(numerics)
    rng = np.random.default_rng(4)
    chunks = [rng.standard_normal((2, n)).astype(np.float32)
              for n in (33, 1, 33)]
    state, rstate = pipe.init_state(2), ref.init_state(2)
    for c in chunks:
        state, p = pipe.step(state, c)
        rstate, q = ref_jit(numerics, "step")(rstate, jnp.asarray(c))
        if numerics == "fixed":
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))
        else:
            np.testing.assert_allclose(p.numpy(), np.asarray(q), atol=TOL,
                                       rtol=0)
    assert [int(c) for c in state.consumed] == \
        [int(c) for c in rstate.consumed]
    assert torch.equal(pipe.stream(chunks), p)
    with pytest.raises(ValueError, match="dtype"):
        pipe.stream([chunks[0], chunks[1].astype(np.float16)])
    with pytest.raises(ValueError, match="at least one chunk"):
        pipe.stream([])


def test_serve_cli_esc10_on_cpu(capsys):
    args = ["--arch", "esc10-mp", "--smoke", "--device", "cpu",
            "--streams", "3", "--chunk", "100", "--rounds", "2"]
    sync = serve_main(args)
    async_ = serve_main(args + ["--async", "--shards", "2"])
    assert [r.samples_seen for r in sync] == [200] * 3
    assert sorted(key_of(async_)) == sorted(key_of(sync))
    assert "device=cpu" in capsys.readouterr().out
    # the LLM side samples at a temperature (seeded: the same tokens twice)
    llm = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
           "--temperature", "0.7", "--batch", "2", "--prompt-len", "2",
           "--gen", "3"]
    tokens = serve_main(llm)
    assert tokens.shape == (2, 3)
    np.testing.assert_array_equal(serve_main(llm), tokens)
