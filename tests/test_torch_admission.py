"""StreamServer's slot admissions (``kernels.admission``): ``open`` and
``close`` leave a code per slot on the host, and the next wave applies
them in one ``slot_admit`` call before its step. On the CPU the served
decisions and registers are held bit for bit against the eager slot
writes (``pl.clear_slots`` / ``pl.set_active`` at each open and close) on
a replica that runs the same session step, over a seeded sequence of
feeds, closes, opens and evictions and over the cases one at a time,
float and fixed, both stream impls; the counters count the applies. On a
card, the kernel is held against its plain version."""

import numpy as np
import pytest
import torch

from repro_torch.configs.esc10_mp import make_pipeline
from repro_torch.core import pipeline as pl
from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.admission import OFF, RESET, slot_admit
from repro_torch.serving import StreamServer, bucket_length

S, MAX_CHUNK, MIN_CHUNK = 4, 64, 16
_PIPES: dict = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small torch ops in loops, under several test workers: one thread
    keeps them at their one-process time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(params=[("float", "xla"), ("float", "pallas"),
                        ("fixed", "xla"), ("fixed", "pallas")],
                ids=lambda p: "-".join(p))
def pipe(request):
    numerics, impl = request.param
    if request.param not in _PIPES:
        _PIPES[request.param] = make_pipeline(
            smoke=True, device="cpu", stream_impl=impl, numerics=numerics,
            fixed_amax=3.0 if numerics == "fixed" else None)
    return _PIPES[request.param]


class Eager:
    """The registers as the eager slot writes leave them: the server's
    session step on a state of its own, each open, close, park and
    restore written at once."""

    def __init__(self, p):
        self.p = p
        self.state = p.init_session(S, active=np.zeros(S, bool))
        self.parked: dict = {}

    def open(self, slot: int, sid: str) -> None:
        pl.clear_slots(self.state, [slot])
        if sid in self.parked:
            pl.put_slot(self.state, slot, self.parked.pop(sid))
        pl.set_active(self.state, [slot], True)

    def close(self, slot: int, sid: str, park: bool) -> None:
        if park:
            self.parked[sid] = pl.take_slot(self.state, slot)
        else:
            self.parked.pop(sid, None)
        pl.set_active(self.state, [slot], False)

    def feed(self, rows: dict) -> np.ndarray:
        """One wave: ``rows`` slot -> chunk; the decisions (S, C)."""
        L = bucket_length(max(len(c) for c in rows.values()), MIN_CHUNK,
                          MAX_CHUNK)
        chunk = torch.zeros((S, L), dtype=torch.float32)
        valid = torch.zeros((S,), dtype=torch.int32)
        for slot, c in rows.items():
            chunk[slot, :len(c)] = torch.from_numpy(c)
            valid[slot] = len(c)
        self.state, p, _ = self.p._session_step(self.state, chunk, valid)
        return p.numpy()


class Pair:
    """A server (deferred admissions) and its eager replica, driven by the
    same calls; each wave's decisions and registers compared."""

    def __init__(self, p, tmp_path):
        self.now = 0.0
        self.srv = StreamServer(p, capacity=S, max_chunk=MAX_CHUNK,
                                min_chunk=MIN_CHUNK,
                                checkpoint_dir=str(tmp_path),
                                clock=lambda: self.now)
        self.eager = Eager(p)

    def slot(self, sid: str) -> int:
        return self.srv.session(sid).slot

    def open(self, sid: str) -> int:
        self.now += 1.0
        slots = {s.id: s.slot for s in self.srv.sessions()}
        slot = self.srv.open(sid).slot
        for gone in set(slots) - {s.id for s in self.srv.sessions()}:
            self.eager.close(slots[gone], gone, park=True)   # evicted
        self.eager.open(slot, sid)
        return slot

    def close(self, sid: str, park: bool = False) -> None:
        slot = self.slot(sid)
        self.srv.close(sid, checkpoint=park)
        self.eager.close(slot, sid, park)

    def feed(self, reqs: list) -> list:
        """One wave (every chunk at most MAX_CHUNK, one per session)."""
        self.now += 1.0
        got = self.srv.feed(reqs)
        p = self.eager.feed({self.slot(sid): c for sid, c in reqs})
        for r, (sid, _) in zip(got, reqs):
            row = p[self.slot(sid)]
            label = int(np.argmax(row))
            assert (r.label, r.confidence) == (label, float(row[label])), sid
        self.check()
        return got

    def check(self) -> None:
        for k, (a, b) in enumerate(zip(self.srv.state.tensors(),
                                       self.eager.state.tensors())):
            assert a.dtype == b.dtype and torch.equal(a, b), f"register {k}"


def chunks(rng, n: int) -> np.ndarray:
    return (rng.standard_normal(n) * 2.0).astype(np.float32)


def test_seeded_lifecycle_matches_eager_writes(pipe, tmp_path):
    rng = np.random.default_rng(29)
    pair = Pair(pipe, tmp_path)
    ids = [f"s{k}" for k in range(6)]
    for sid in ids[:3]:
        pair.open(sid)
    for _ in range(24):
        live = [s.id for s in pair.srv.sessions()]
        op = rng.choice(["feed", "feed", "close", "open", "evict"])
        if op == "feed" and live:
            pick = rng.choice(live, int(rng.integers(1, len(live) + 1)),
                              replace=False)
            pair.feed([(str(sid), chunks(rng, int(rng.choice([7, 16, 40,
                                                              64]))))
                       for sid in pick])
        elif op == "close" and live:
            pair.close(str(rng.choice(live)))
        elif op == "evict" and live:
            pair.close(str(rng.choice(live)), park=True)
        else:
            shut = [sid for sid in ids if sid not in live]
            if shut:
                pair.open(str(rng.choice(shut)))    # may evict, or restore
    pair.check()                 # what is pending, applied by the read
    st = pair.srv.stats()
    assert 0 < st["admission_applies"] <= st["steps_run"] + 24


def test_closed_slot_is_inert_in_the_next_wave(pipe, tmp_path):
    rng = np.random.default_rng(1)
    pair = Pair(pipe, tmp_path)
    pair.open("a")
    pair.open("b")
    pair.feed([("a", chunks(rng, 40)), ("b", chunks(rng, 40))])
    slot = pair.slot("a")
    before = [t[slot].clone() for t in pair.srv.state.tensors()]
    pair.close("a")
    pair.feed([("b", chunks(rng, 64))])
    after = [t[slot] for t in pair.srv.state.tensors()]
    for k, (x, y) in enumerate(zip(before[:-1], after[:-1])):
        assert torch.equal(x, y), f"register {k} of the closed slot moved"
    assert before[-1] and not after[-1]


def test_close_and_open_of_one_id_before_a_wave(pipe, tmp_path):
    rng = np.random.default_rng(2)
    pair = Pair(pipe, tmp_path)
    pair.open("a")
    pair.feed([("a", chunks(rng, 40))])
    slot = pair.slot("a")
    pair.close("a")
    assert pair.open("a") == slot
    assert pair.srv._codes[slot] == RESET       # close then open: a reset
    x = chunks(rng, 16)
    got = pair.feed([("a", x)])[0]
    fresh = StreamServer(pipe, capacity=S, max_chunk=MAX_CHUNK,
                         min_chunk=MIN_CHUNK)
    fresh.open("a")
    want = fresh.feed([("a", x)])[0]
    assert got == want              # as a fresh server's first decision


def test_slot_handed_to_another_id(pipe, tmp_path):
    rng = np.random.default_rng(3)
    pair = Pair(pipe, tmp_path)
    pair.open("a")
    pair.open("c")
    pair.feed([("a", chunks(rng, 64)), ("c", chunks(rng, 7))])
    slot = pair.slot("a")
    pair.close("a")
    assert pair.open("b") == slot
    pair.feed([("b", chunks(rng, 40)), ("c", chunks(rng, 40))])


def test_restored_session_is_not_wiped_by_a_pending_reset(pipe, tmp_path):
    rng = np.random.default_rng(4)
    pair = Pair(pipe, tmp_path)
    pair.open("a")
    pair.feed([("a", chunks(rng, 64))])
    slot = pair.slot("a")
    pair.close("a", park=True)
    parked = pair.eager.parked["a"]
    assert pair.open("z") == slot                 # a reset pending
    pair.close("z")                               # reset and clear
    assert pair.srv._codes[slot] == RESET | OFF
    applies = pair.srv.stats()["admission_applies"]
    assert pair.open("a") == slot                 # restored over it
    assert pair.srv.stats()["admission_applies"] == applies + 1
    row = pl.take_slot(pair.srv.state, slot)
    for k, (x, y) in enumerate(zip(row.tensors()[:-1],
                                   parked.tensors()[:-1])):
        assert torch.equal(x, y), f"register {k} of the restored row"
    assert bool(row.active)
    pair.check()
    pair.feed([("a", chunks(rng, 16))])


def test_state_read_between_open_and_wave_shows_cleared_registers(
        pipe, tmp_path):
    rng = np.random.default_rng(5)
    pair = Pair(pipe, tmp_path)
    pair.open("a")
    pair.feed([("a", chunks(rng, 64))])
    slot = pair.slot("a")
    assert any(t[slot].any() for t in pair.srv.state.tensors()[:-1])
    pair.close("a")
    assert pair.open("b") == slot
    applies = pair.srv.stats()["admission_applies"]
    st = pair.srv.state
    assert pair.srv.stats()["admission_applies"] == applies + 1
    for k, t in enumerate(st.tensors()[:-1]):
        assert not t[slot].any(), f"register {k} not cleared"
    assert bool(st.active[slot])
    pair.check()
    pair.feed([("b", chunks(rng, 40))])


def test_stats_count_one_apply_per_wave_with_admissions(pipe, tmp_path):
    rng = np.random.default_rng(6)
    pair = Pair(pipe, tmp_path)

    def counts():
        st = pair.srv.stats()
        return st["admission_applies"], st["slots_admitted"]

    pair.open("a")
    pair.open("b")
    assert counts() == (0, 0)                     # nothing on the card yet
    pair.feed([("a", chunks(rng, 40)), ("b", chunks(rng, 16))])
    assert counts() == (1, 2)
    pair.feed([("a", chunks(rng, 40))])
    assert counts() == (1, 2)                     # no admission, no apply
    pair.close("a")
    pair.open("a")
    pair.close("b")
    # two waves (100 samples split at 64): the first one applies
    waves = pair.srv.steps_run
    pair.srv.feed([("a", chunks(rng, 100))])
    assert pair.srv.steps_run == waves + 2
    assert counts() == (2, 4)
    pair.srv.feed([("a", chunks(rng, 16))])
    assert counts() == (2, 4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_slot_admit_kernel_matches_plain(dev, dtype):
    """The kernel against ``ref.slot_admit`` at S = 256 on random register
    bits, the session's shapes (6 delay lines, 6 counters, acc, amax,
    count): the slots with a code written, every other row (their
    neighbours among them) untouched."""
    Sk = 256
    g = torch.Generator().manual_seed(29)
    shapes = [((Sk, 15), dtype)] * 6 + [((Sk,), torch.int32)] * 6 + [
        ((Sk, 30), dtype), ((Sk,), dtype), ((Sk,), torch.int32)]
    regs = [torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                          dtype=torch.int32).view(dt)
            for shape, dt in shapes]
    active = torch.randint(0, 2, (Sk,), generator=g).bool()
    codes = torch.zeros((Sk,), dtype=torch.uint8)
    picks = torch.randperm(Sk, generator=g)[:40]
    codes[picks] = torch.randint(1, 4, (40,), generator=g,
                                 dtype=torch.uint8)
    codes[[0, 1, 2, Sk - 1]] = torch.tensor([RESET, 0, RESET | OFF, OFF],
                                            dtype=torch.uint8)
    want = [t.clone() for t in regs]
    want_active = active.clone()
    ref.slot_admit(want, want_active, codes)
    got = [t.to(dev) for t in regs]
    got_active = active.to(dev)
    n = LAUNCHES["slot_admit"]
    slot_admit(got, got_active, codes.to(dev))
    torch.cuda.synchronize()
    assert LAUNCHES["slot_admit"] == n + 1
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 \
        else t                                               # noqa: E731
    untouched = codes == 0
    for k, (a, w, r) in enumerate(zip(got, want, regs)):
        a = a.cpu()
        assert torch.equal(bits(a), bits(w)), f"register {k}"
        assert torch.equal(bits(a[untouched]), bits(r[untouched])), k
        assert not a[(codes & RESET) > 0].view(torch.int32).any(), k
    assert torch.equal(got_active.cpu(), want_active)
    assert torch.equal(got_active.cpu()[untouched], active[untouched])
