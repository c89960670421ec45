"""The port's StreamRouter on the CPU: against one port server (bit for
bit), against the reference's router on the same feeds, request order
across shards, per-shard checkpoints and backpressure, one shared step."""

import numpy as np
import pytest
import torch

from repro.serving import StreamRouter as RefRouter
from repro_torch.serving import StreamRouter, StreamServer, shard_of
from test_torch_serving_async import (SERVER_KW, assert_registers,
                                      assert_results, feeds, port,
                                      port_server, reference)

ROUTER_KW = dict(max_chunk=64, min_chunk=16)


def _router(numerics="float", **kw):
    pipe, step = port(numerics)
    return StreamRouter(pipe, step_fn=step, **{**ROUTER_KW, **kw})


@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_router_matches_one_server_and_the_reference(numerics, tmp_path):
    rng = np.random.default_rng(7)
    ids = [f"mic-{i:02d}" for i in range(6)]
    router = _router(numerics, num_shards=2, capacity=6,
                     checkpoint_dir=str(tmp_path / "port"))
    ref_pipe, ref_step = reference(numerics)
    ref = RefRouter(ref_pipe, num_shards=2, capacity=6, step_fn=ref_step,
                    checkpoint_dir=str(tmp_path / "ref"), **ROUTER_KW)
    single = port_server(numerics, capacity=6)
    for sid in ids:
        for srv in (router, ref, single):
            srv.open(sid)
    assert [router.shard_of(s) for s in ids] == [ref.shard_of(s)
                                                 for s in ids]
    for _ in range(3):
        reqs = feeds(rng, ids, 8)
        got = router.feed(reqs)
        want = single.feed(reqs)
        assert [(r.session_id, r.label, r.confidence, r.samples_seen)
                for r in got] == [(r.session_id, r.label, r.confidence,
                                   r.samples_seen) for r in want]
        assert_results(got, ref.feed(reqs), numerics)
    for k in range(2):
        assert_registers(router.shard(k).state, ref.shard(k).state,
                         numerics)
        # each shard is its own server: one state, one step shared
        assert router.shard(k)._batched is router.shard(0)._batched
    # per stream, the shards' registers are the single server's bit for bit
    for sid in ids:
        srv = router.shard(router.shard_of(sid))
        a, b = srv.session(sid).slot, single.session(sid).slot
        for x, y in zip(srv.state.tensors(), single.state.tensors()):
            assert torch.equal(x[a], y[b]), sid
    st = router.stats()
    assert st["resident"] == 6 and st["poisoned"] is None
    # the port's own counters are summed over the shards
    assert st.keys() - {"bucket_valid_samples", "bucket_padded_samples",
                        "waits"} == ref.stats().keys()
    assert len(st["shards"]) == 2
    for k in ("bucket_valid_samples", "bucket_padded_samples"):
        assert sum(st[k].values()) == sum(sum(p[k].values())
                                          for p in st["shards"])


def test_router_async_order_poll_and_shared_step():
    router = _router(num_shards=2, capacity=8)
    rng = np.random.default_rng(3)
    ids = [f"m{i}" for i in range(6)]
    assert {shard_of(s, 2) for s in ids} == {0, 1}
    for sid in ids:
        router.open(sid)
    order = [ids[i] for i in rng.permutation(len(ids))]
    reqs = [(sid, rng.standard_normal(16).astype(np.float32))
            for sid in order]
    t = router.submit(reqs)
    assert router.poll(t) is None                  # queued, not dispatched
    router.drain()
    assert [r.session_id for r in t.results] == order
    assert router.poll(t) == t.results
    t2 = router.feed_async(reqs[:2])
    for k in range(2):
        router.shard(k).drain()
    assert router.poll(t2) is not None
    assert router.submit([]).results == []
    sync = StreamServer(router.pipeline, **{**SERVER_KW, "capacity": 8})
    for sid in ids:
        sync.open(sid)
    sync.feed(reqs)
    sync.feed(reqs[:2])
    for sid in ids:
        assert router.session(sid).samples_seen == \
            sync.session(sid).samples_seen
    with pytest.raises(KeyError, match="session 'ghost' is not open"):
        router.submit([(ids[0], np.zeros(4)), ("ghost", np.zeros(4))])
    assert router.stats()["queued_requests"] == 0


def test_router_eviction_reopens_from_the_shard_store(tmp_path):
    router = _router(num_shards=3, capacity=2,
                     checkpoint_dir=str(tmp_path))
    rng = np.random.default_rng(5)
    x = rng.standard_normal(100).astype(np.float32)
    router.open("edge-7")
    k = router.shard_of("edge-7")
    r1 = router.feed([("edge-7", x[:64])])[0]
    router.evict("edge-7")
    assert not router.is_open("edge-7") and "edge-7" not in router
    assert (tmp_path / f"shard-{k:02d}" / "named_session-edge-7").is_dir()
    router.open("edge-7")
    assert router.session("edge-7").samples_seen == 64
    r2 = router.feed([("edge-7", x[64:])])[0]
    srv = port_server(capacity=2)
    srv.open("edge-7")
    want = [srv.feed([("edge-7", x[:64])])[0],
            srv.feed([("edge-7", x[64:])])[0]]
    assert [r1, r2] == want
    assert [s.id for s in router.sessions()] == ["edge-7"]


def test_router_backpressure_names_the_shard():
    router = _router(num_shards=2, capacity=1)
    by_shard: dict = {}
    for i in range(32):
        by_shard.setdefault(router.shard_of(f"x{i}"), []).append(f"x{i}")
    k, pair = next((k, v) for k, v in by_shard.items() if len(v) >= 2)
    router.open(pair[0])
    with pytest.raises(RuntimeError, match=rf"shard {k}: .*capacity"):
        router.open(pair[1])
    with pytest.raises(ValueError, match="num_shards"):
        StreamRouter(router.pipeline, num_shards=0)
