"""The port's StreamServer on the CPU: waves, splits, history, slots."""

import numpy as np
import pytest
import torch

from repro_torch.configs.esc10_mp import make_pipeline
from repro_torch.serving import FeedRequest, StreamServer, bucket_length
from repro_torch.serving.session import Decision, Session


def _audio(rows, n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, n)).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decisions_equal_apply_on_the_same_feeds(impl):
    """Each wave is one apply(chunk, state) on the padded (S, L_bucket)
    batch with per-slot valid counts; the server must return exactly
    those decisions."""
    pipe = make_pipeline(smoke=True, device="cpu", stream_impl=impl)
    S = 4
    server = StreamServer(pipe, capacity=S, max_chunk=64, min_chunk=16)
    for sid in ("a", "b", "c"):
        server.open(sid)
    x = _audio(3, 400)
    rounds = [[("a", x[0, 0:40]), ("b", x[1, 0:7]), ("c", x[2, 0:100])],
              [("b", x[1, 7:71]), ("c", x[2, 100:101])],
              [("a", x[0, 40:200]), ("c", x[2, 101:140])]]
    state = pipe.init_session(S, active=[True, True, True, False])
    for feeds in rounds:
        results = server.feed(feeds)
        pending = {sid: [c[i:i + 64] for i in range(0, len(c), 64)]
                   for sid, c in feeds}
        last = {}
        while any(pending.values()):
            segs = {sid: p.pop(0) for sid, p in pending.items() if p}
            L = bucket_length(max(len(s) for s in segs.values()), 16, 64)
            batch = np.zeros((S, L), np.float32)
            valid = np.zeros(S, np.int32)
            for sid, seg in segs.items():
                slot = server.session(sid).slot
                batch[slot, :len(seg)] = seg
                valid[slot] = len(seg)
            p, state = pipe.apply(batch, state, valid=torch.from_numpy(valid))
            last.update({sid: p[server.session(sid).slot] for sid in segs})
        for fr in results:
            row = last[fr.session_id]
            assert fr.label == int(torch.argmax(row))
            assert fr.confidence == float(row[fr.label])
    for a, b in zip((*state.delays, state.acc, state.amax),
                    (*server.state.delays, server.state.acc,
                     server.state.amax)):
        assert torch.equal(a, b)
    assert server.session("a").samples_seen == 200
    assert server.stats()["steps_run"] == 6


def test_long_chunks_split_and_requests_keep_order():
    pipe = make_pipeline(smoke=True, device="cpu")
    server = StreamServer(pipe, capacity=2, max_chunk=32, min_chunk=16)
    server.open("a")
    x = _audio(1, 100)[0]
    res = server.feed([FeedRequest("a", x[:70]), ("a", x[70:])])
    assert [r.samples_seen for r in res] == [70, 100]
    assert server.stats()["buckets"] == {16: 1, 32: 3}
    assert int(server.state.count[0]) == 100
    history = server.session("a").history
    assert [(d.samples_seen, d.label, d.confidence) for d in history] == \
        [(r.samples_seen, r.label, r.confidence) for r in res]
    assert server.session("a").last_decision == history[-1]


def test_session_history_keeps_the_newest_decisions():
    n = 64                      # the default max_history
    sess = Session(id="a", slot=0, opened_at=0.0, last_fed=0.0)
    assert sess.last_decision is None
    for k in range(n + 6):
        sess.record(Decision(k + 1, k % 3, 0.5), now=float(k))
    assert len(sess.history) == n
    assert sess.history[0].samples_seen == 7
    assert sess.last_decision == Decision(n + 6, (n + 5) % 3, 0.5)
    assert (sess.samples_seen, sess.last_fed) == (n + 6, n + 5.0)
    short = Session(id="b", slot=1, opened_at=0.0, last_fed=0.0,
                    max_history=2)
    short.load_meta(sess.meta())
    assert short.history == sess.history and short.samples_seen == n + 6


def test_bucket_ladder_validation():
    assert [bucket_length(n, 16, 256) for n in (1, 16, 17, 160, 300)] == \
        [16, 16, 32, 256, 256]
    pipe = make_pipeline(smoke=True, device="cpu")
    for kw in (dict(min_chunk=24), dict(max_chunk=100),
               dict(min_chunk=64, max_chunk=32)):
        with pytest.raises(ValueError):
            StreamServer(pipe, capacity=2, **kw)
    with pytest.raises(ValueError, match="positive"):
        bucket_length(0, 16, 64)


def test_unknown_session_keyerror_shape():
    server = StreamServer(make_pipeline(smoke=True, device="cpu"),
                          capacity=2)
    msg = "session 'ghost' is not open"
    for call in (lambda: server.feed([("ghost", np.zeros(4))]),
                 lambda: server.close("ghost"),
                 lambda: server.session("ghost")):
        with pytest.raises(KeyError, match=msg):
            call()
    server.open("a")
    with pytest.raises(ValueError, match="already open"):
        server.open("a")
    with pytest.raises(ValueError, match="empty chunk"):
        server.feed([("a", np.zeros(0))])


def test_slot_reuse_after_close_starts_fresh():
    pipe = make_pipeline(smoke=True, device="cpu")
    server = StreamServer(pipe, capacity=2, max_chunk=64)
    x = _audio(2, 128, seed=3)
    server.open("a")
    server.open("b")
    server.feed([("a", x[0, :64]), ("b", x[1, :64])])
    slot_a = server.session("a").slot
    server.close("a")
    assert server.stats()["free_slots"] == 1
    server.open("c")
    assert server.session("c").slot == slot_a
    assert int(server.state.count[slot_a]) == 0
    assert float(server.state.acc[slot_a].abs().sum()) == 0.0
    got = server.feed([("c", x[1, :64])])[0]
    fresh = StreamServer(pipe, capacity=2, max_chunk=64)
    fresh.open("z")
    want = fresh.feed([("z", x[1, :64])])[0]
    assert (got.label, got.confidence) == (want.label, want.confidence)
    with pytest.raises(RuntimeError, match="capacity"):
        server.open("d")
        server.open("e")
