"""StreamServer: many sensor streams, one captured session step per wave.

Slot model: the server owns ONE slot-batched ``SessionState`` of fixed
capacity S on the pipeline's device. ``open()`` pins a session to a free
slot (evicting the least-recently-fed idle session to the checkpoint store
when full; a parked session resumes bit for bit), ``feed()`` absorbs
chunks for any subset of resident sessions, and ``close()`` / ``evict()``
release the slot. ``open`` and ``close`` do not touch the card: each
leaves an admission code for its slot on the host (:mod:`kernels.admission`:
close clears the slot's mask, a fresh open zeroes its registers and sets
it, a later call on a slot overrides or adds to an earlier one), and the
next wave stages the codes beside its chunk and applies them all in one
``slot_admit`` launch before its step. Whatever reads or writes the
registers outside a wave (``state``, parking, a restore) applies the
pending codes first. Per wave, every pending segment is padded into one
(S, L_bucket) batch with per-slot valid counts; absent slots ride along
inertly. Packet lengths pad up to the next power of two in
``[min_chunk, max_chunk]`` (longer packets split), so the step sees at
most ``log2(max_chunk / min_chunk) + 1`` distinct lengths.

The step (:func:`make_batched_step`) writes the new registers into the
server's state tensors in place; ``self._state`` is never rebound. On the
card each (server, bucket) runs as one CUDA graph, captured after a
warm-up run and replayed once per wave over static input buffers; on the
CPU the same object runs the step eagerly into the same buffers.

Async feed pipeline: ``feed()`` is ``submit()`` + ``drain()``.
``submit()`` validates and queues requests (dispatching on a coalescing
watermark or deadline); dispatch stages each wave into one of two pinned
host buffers per bucket, copies it to the step's static inputs without
blocking, replays the step and copies the decisions of a wave that
finishes a request out of the graph's output buffer (the next replay of
the bucket overwrites it), then records a CUDA event. A staging buffer is
rewritten only after the event of the wave that last read it; ``poll()``
resolves tickets once every such event has completed, and ``drain()``
blocks once and resolves every ticket in submit order. Decisions are bit
for bit those of the synchronous path.

Tracing (``repro_torch.tracing``): the server's calls and each wave's
stage, launch and copy-out are spans, keyed by the ``FeedTicket``'s
serial. While the tracer records on the card, each wave also takes two
timed CUDA events, before its first copy and after its decisions are
copied out, and ``_resolve`` reads each wave's time on the card and the
card's time since the wave before it (``tracing.record_wave``).
``stats()`` counts the valid and padded samples per bucket and the waits.

A step that raises, or a card that fails while running one, poisons the
server: the registers may be half written (and a failed replay can leave
a sticky CUDA error), so every later call raises ``RuntimeError`` naming
the wave, the bucket and the sessions. Nothing falls back to an eager step
on the card. For N servers behind one admission API see
``repro_torch.serving.router.StreamRouter``.

Scale-out: ``mesh=`` (a ``DeviceMesh``, one process per rank, every rank
making the same calls) shards the slot axis over the mesh's data axes
(``sharding.session_specs``). Each rank holds and steps only its own
slots, as local tensors: the step and its graph never see a ``DTensor`` or
a collective. The host's slot table is the same on every rank; after each
wave the decisions are gathered (``sharding.gather_ranks``), so every rank
resolves the same ``FeedResult``s as a server without a mesh. What reads a
rank's own clock is decided once: the eviction victim by the first rank,
and a coalescing deadline is not taken. Parking a session gathers its row
from the rank that owns it; the first rank writes the named checkpoints.
A step that raises on one rank poisons every rank at the end of that
dispatch. A capacity the data axes do not divide replicates.
"""

from __future__ import annotations

import itertools
import time
import weakref
from typing import Iterable, List, Optional, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import pipeline as pl
from repro_torch.core.pipeline import InFilterPipeline, SessionState
from repro_torch.distributed import sharding as sh
from repro_torch.kernels._wrap import add_launches, take_captured
from repro_torch.kernels.admission import OFF, RESET, slot_admit
from repro_torch.serving.session import (Decision, FeedRequest, FeedResult,
                                         FeedTicket, Session)

__all__ = ["StreamServer", "BatchedStep", "bucket_length",
           "make_batched_step"]


# FeedTicket serials, process-wide: the key of each batch's spans
_TICKETS = itertools.count(1)


def bucket_length(n: int, min_chunk: int, max_chunk: int) -> int:
    """Next power of two >= n, clamped to [min_chunk, max_chunk]."""
    if n <= 0:
        raise ValueError(f"chunk length must be positive, got {n}")
    b = min_chunk
    while b < n:
        b <<= 1
    return min(b, max_chunk)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A register's values as flat int32 words, bit for bit (float32
    reinterpreted, int32 as is, bool as 0 / 1)."""
    t = t.reshape(-1)
    return t.view(torch.int32) if t.dtype == torch.float32 \
        else t.to(torch.int32)


def _unbits(flat: torch.Tensor, like: SessionState) -> SessionState:
    """The inverse of :func:`_bits` over every register of ``like``."""
    out, k = [], 0
    for t in like.tensors():
        w = flat[k:k + t.numel()]
        k += t.numel()
        w = w.view(torch.float32) if t.dtype == torch.float32 \
            else w.to(t.dtype)
        out.append(w.reshape(t.shape).clone())
    nd, nc = len(like.delays), len(like.consumed)
    return SessionState(tuple(out[:nd]), tuple(out[nd:nd + nc]),
                        *out[nd + nc:])


class _Bucket:
    """One bucket length of one bound state: the static inputs, the
    decision output and, on the card, the captured graph with the kernel
    launches each replay makes."""

    __slots__ = ("chunk", "valid", "p", "graph", "launches")

    def __init__(self, chunk, valid, p):
        self.chunk, self.valid, self.p = chunk, valid, p
        self.graph = None
        self.launches: dict = {}


class _Bound:
    """A state bound to the step: its buckets, the memory pool its graphs
    share, and what ran."""

    __slots__ = ("state", "buckets", "pool", "captures", "replays",
                 "eager_runs")

    def __init__(self, state: SessionState):
        self.state = state
        self.buckets: dict = {}
        self.pool = None
        self.captures = self.replays = self.eager_runs = 0


class BatchedStep:
    """The served session step of one pipeline, for any server (or router
    shard) that binds its state to it.

    ``step(pipe, state, chunk, valid) -> (state, p)``: ``chunk`` and
    ``valid`` must be the static inputs from ``step.inputs(state, L)``;
    the new registers are written into ``state``'s tensors in place (the
    same ``state`` comes back) and ``p`` is the bucket's static (S, C)
    output, overwritten by the bucket's next run. On the card the first
    call for a bucket runs the step once eagerly on a scratch copy of the
    registers, on a side stream (this builds what the step makes lazily:
    kernel libraries, launch plans, device tables and constants), then
    captures it as a ``torch.cuda.CUDAGraph`` into the state's graph pool
    and replays it; every later call replays it. A capture or replay that
    fails raises. On the CPU the step runs eagerly.
    """

    def __init__(self, pipeline: InFilterPipeline):
        self.pipeline = pipeline
        if pipeline.config.numerics == "fixed":
            pipeline.fixed_program()       # compiled on the host, once
        self._bound: dict = {}             # id(state) -> _Bound

    # -- binding --------------------------------------------------------------

    def bind(self, state: SessionState) -> None:
        """Register ``state`` (a server's one state) with the step."""
        self._bound.setdefault(id(state), _Bound(state))

    def release(self, state_id: int) -> None:
        """Drop a bound state's buffers and graphs (its server is gone)."""
        self._bound.pop(state_id, None)

    def _of(self, state: SessionState) -> _Bound:
        b = self._bound.get(id(state))
        if b is None or b.state is not state:
            raise ValueError("this state is not bound to the step: call "
                             "step.bind(state) first")
        return b

    def inputs(self, state: SessionState, L: int) -> tuple:
        """The static (chunk (S, L) f32, valid (S,) int32) inputs of
        ``state``'s bucket ``L`` on its device."""
        b = self._of(state)
        bk = b.buckets.get(L)
        if bk is None:
            S, dev = state.capacity, state.acc.device
            C = self.pipeline.clf.params.b_pos.shape[0]
            bk = b.buckets[L] = _Bucket(
                torch.zeros((S, L), dtype=torch.float32, device=dev),
                torch.zeros((S,), dtype=torch.int32, device=dev),
                None if dev.type == "cuda" else
                torch.zeros((S, C), dtype=torch.float32))
        return bk.chunk, bk.valid

    def counts(self, state: SessionState) -> dict:
        """What ran for ``state``: graphs captured, replays, eager runs
        and the bucket lengths that have a graph."""
        b = self._of(state)
        return {"captures": b.captures, "replays": b.replays,
                "eager_runs": b.eager_runs,
                "graphs": sorted(L for L, bk in b.buckets.items()
                                 if bk.graph is not None)}

    # -- running --------------------------------------------------------------

    def _run(self, state: SessionState, chunk, valid) -> torch.Tensor:
        """The session step, its new registers copied into ``state``."""
        new, p, _ = self.pipeline._session_step(state, chunk, valid)
        for dst, src in zip(state.tensors(), new.tensors()):
            if src is not dst:
                dst.copy_(src)
        return p

    def _capture(self, b: _Bound, bk: _Bucket) -> None:
        side = torch.cuda.Stream(device=b.state.acc.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            scratch = SessionState(*(
                tuple(t.clone() for t in f) if isinstance(f, tuple)
                else f.clone() for f in b.state))
            self._run(scratch, bk.chunk, bk.valid)
        torch.cuda.current_stream().wait_stream(side)
        del scratch
        take_captured()
        if b.pool is None:
            b.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=b.pool):
            p = self._run(b.state, bk.chunk, bk.valid)
        bk.graph, bk.p, bk.launches = graph, p, take_captured()
        b.captures += 1

    def __call__(self, pipe: InFilterPipeline, state: SessionState,
                 chunk: torch.Tensor, valid: torch.Tensor):
        if pipe is not self.pipeline:
            raise ValueError("this step was made for another pipeline")
        b = self._of(state)
        bk = b.buckets.get(chunk.shape[-1])
        if bk is None or chunk is not bk.chunk or valid is not bk.valid:
            raise ValueError("the step reads its static inputs: copy the "
                             "wave into step.inputs(state, L)")
        if state.acc.device.type == "cuda":
            if bk.graph is None:
                with tracing.span("step.capture"):
                    self._capture(b, bk)
            bk.graph.replay()
            add_launches(bk.launches)
            b.replays += 1
        else:
            bk.p.copy_(self._run(state, bk.chunk, bk.valid))
            b.eager_runs += 1
        return state, bk.p


def make_batched_step(pipeline: InFilterPipeline) -> BatchedStep:
    """The served step of ``pipeline`` (see :class:`BatchedStep`). A
    ``StreamServer`` makes one unless given ``step_fn=``; pass one step to
    several servers to share it, as ``StreamRouter``'s shards do (each
    server still captures its own graphs: a graph is bound to its
    server's buffers)."""
    return BatchedStep(pipeline)


class _StageBuffer:
    """One host staging buffer of a bucket's pair (pinned on the card).
    ``inflight`` is the event recorded after the last wave that read it:
    it must complete before the rows are rewritten. ``admit`` holds the
    admission codes of a wave that carries any, written whole over the
    rank's slots by that wave (no other wave reads it)."""

    __slots__ = ("batch", "valid", "admit", "batch_np", "valid_np",
                 "admit_np", "dirty", "inflight")

    def __init__(self, capacity: int, length: int, pin: bool):
        self.batch = torch.zeros((capacity, length), dtype=torch.float32,
                                 pin_memory=pin)
        self.valid = torch.zeros((capacity,), dtype=torch.int32,
                                 pin_memory=pin)
        self.admit = torch.zeros((capacity,), dtype=torch.uint8,
                                 pin_memory=pin)
        self.batch_np = self.batch.numpy()
        self.valid_np = self.valid.numpy()
        self.admit_np = self.admit.numpy()
        self.dirty: list = []          # slots written by the last wave
        self.inflight = None


class _Pending:
    """One submitted request riding the coalescing queue."""

    __slots__ = ("ticket", "pos", "sid", "segs", "total", "label", "conf")

    def __init__(self, ticket, pos, sid, segs, total):
        self.ticket = ticket
        self.pos = pos                 # index within the ticket
        self.sid = sid
        self.segs = segs               # max_chunk-bounded segments
        self.total = total             # the chunk's length in samples
        self.label = None
        self.conf = None


class StreamServer:
    """Multiplex sensor streams onto ``capacity`` slots of one pipeline.

    Parameters
    ----------
    pipeline:       the ``InFilterPipeline``; ``config.stream_impl`` picks
                    the step's octave cascade ("pallas" = the CUDA stream
                    kernel, "xla" = torch ops; the same decisions) and
                    ``config.numerics`` the engine ("float", or "fixed",
                    the bit-true int32 twin).
    capacity:       slots S (streams resident at once).
    max_chunk:      largest per-wave chunk; longer packets split. A power
                    of two.
    min_chunk:      smallest pad bucket. A power of two.
    evict_after:    seconds of idleness before a resident session may be
                    evicted to make room; ``None``: any idle session.
    checkpoint_dir: where evicted sessions are parked; without it a full
                    server raises.
    max_history:    decisions kept per session.
    clock:          injectable monotonic clock (tests).
    coalesce_watermark: ``submit()`` dispatches the queue once this many
                    requests are pending (no readback); ``None``: only at
                    ``drain()`` or the deadline.
    coalesce_deadline: seconds a queued request may wait before the next
                    ``submit()`` / ``poll()`` dispatches the queue
                    (checked on API calls; there is no thread).
    step_fn:        a step from :func:`make_batched_step` for this
                    pipeline, to share it with other servers.
    mesh:           a ``torch.distributed`` ``DeviceMesh``: shard the slot
                    axis over its data axes (see the module docstring).
    """

    def __init__(self, pipeline: InFilterPipeline, capacity: int = 64, *,
                 max_chunk: int = 4096, min_chunk: int = 16,
                 evict_after: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 max_history: int = 64, clock=None,
                 coalesce_watermark: Optional[int] = None,
                 coalesce_deadline: Optional[float] = None,
                 step_fn: Optional[BatchedStep] = None, mesh=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not (0 < min_chunk <= max_chunk):
            raise ValueError("need 0 < min_chunk <= max_chunk")
        # both bounds powers of two, or the O(log) bucket bound breaks
        for bname, v in (("min_chunk", min_chunk), ("max_chunk", max_chunk)):
            if v & (v - 1):
                raise ValueError(
                    f"{bname} must be a power of two, got {v} (the pad-"
                    "bucket ladder doubles from min_chunk to max_chunk)")
        if pipeline.config.stream_impl == "pallas" \
                and pipeline.config.mode != "mp":
            raise ValueError(
                "stream_impl='pallas' requires an MP-mode pipeline "
                f"(got mode={pipeline.config.mode!r})")
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh= takes a torch DeviceMesh, got "
                                f"{type(mesh).__name__}")
            if mesh.device_type not in ("cpu", pipeline.device.type):
                raise ValueError(f"a {mesh.device_type} mesh cannot serve "
                                 f"a pipeline on {pipeline.device}")
            if coalesce_deadline is not None:
                raise ValueError("coalesce_deadline reads each rank's own "
                                 "clock: under a mesh use "
                                 "coalesce_watermark")
        if step_fn is not None and step_fn.pipeline is not pipeline:
            raise ValueError("step_fn was made for another pipeline")
        self.pipeline = pipeline
        self.capacity = capacity
        self.max_chunk = max_chunk
        self.min_chunk = min_chunk
        self.evict_after = evict_after
        self._clock = clock if clock is not None else time.monotonic
        self._cuda = pipeline.device.type == "cuda"
        self._mesh = mesh
        self._state = pipeline.init_session(
            capacity, active=np.zeros((capacity,), bool))
        # this rank's slots [lo, lo + n) of the capacity's n_shards shards
        self._lo, self._n, self._n_shards = 0, capacity, 1
        self._lead = True          # writes the named checkpoints
        if mesh is not None:
            self._specs = sh.session_specs(self._state, mesh)
            if self._specs.acc[0] is not None:
                index, self._n_shards = sh.data_shard(mesh)
                self._n = capacity // self._n_shards
                self._lo = index * self._n
            lo, hi = self._lo, self._lo + self._n
            self._state = SessionState(*(
                tuple(t[lo:hi].clone() for t in f) if isinstance(f, tuple)
                else f[lo:hi].clone() for f in self._state))
            self._lead = not any(mesh.get_coordinate())
        # admission codes of this rank's slots not yet applied (any
        # non-zero code is pending)
        self._codes = np.zeros((self._n,), np.uint8)
        self._admit_dev = torch.zeros((self._n,), dtype=torch.uint8,
                                      device=self._state.acc.device) \
            if self._cuda else None    # their copy on the card
        self.admission_applies = 0     # slot_admit calls
        self.slots_admitted = 0        # slots they wrote
        self._batched = step_fn if step_fn is not None \
            else make_batched_step(pipeline)
        self._batched.bind(self._state)
        weakref.finalize(self, self._batched.release, id(self._state))
        self._step = self._batched
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0
        self._sessions: dict[str, Session] = {}
        self._manager = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointManager
            self._manager = CheckpointManager(checkpoint_dir,
                                              async_save=False)
        self._max_history = max_history
        self.bucket_counts: dict[int, int] = {}
        # per bucket, the staged segments' samples and their padding
        self.bucket_valid: dict[int, int] = {}
        self.bucket_padded: dict[int, int] = {}
        self.steps_run = 0
        self.waits = 0                 # _wait calls on an event
        # set when a step raised or the card failed: names the wave
        self._poisoned: Optional[str] = None
        # -- async feed pipeline --
        self.coalesce_watermark = coalesce_watermark
        self.coalesce_deadline = coalesce_deadline
        self._staging: dict[int, list] = {}   # bucket L -> [_StageBuffer]*2
        self._stage_flip: dict[int, int] = {}
        self._queue: List[_Pending] = []      # submitted, not dispatched
        self._queue_since: Optional[float] = None
        self._dispatched: List[_Pending] = []  # dispatched, not resolved
        # per wave that finishes a request: (its decisions on the host,
        # the event after them, [(pending, slot), ...], the wave's name)
        self._inflight: list = []
        # -- wave timing, while the tracer records on the card --
        self._timing_pool: list = []   # timed CUDA events to reuse
        # per timed wave not yet read: (wave, key, start event, end event,
        # host ns of the start, whether the wave before it was timed)
        self._timed: list = []
        self._last_end = None          # the end event of the last one read
        self._last_timed = False       # whether the last wave was timed

    # -- introspection --------------------------------------------------------

    @property
    def state(self) -> SessionState:
        """The slot-batched registers (this rank's, under a mesh), with
        every admission applied."""
        self._admit_now()
        return self._state

    def session(self, session_id: str) -> Session:
        try:
            return self._sessions[session_id]
        except KeyError:
            raise KeyError(f"session {session_id!r} is not open") from None

    def sessions(self) -> list:
        return sorted(self._sessions.values(), key=lambda s: s.slot)

    def is_open(self, session_id: str) -> bool:
        return session_id in self._sessions

    def __contains__(self, session_id: str) -> bool:
        return session_id in self._sessions

    def step_counts(self) -> dict:
        """This server's graphs captured, replays and eager runs (see
        ``BatchedStep.counts``); under a mesh, this rank's."""
        return self._batched.counts(self._state)

    @property
    def local_slots(self) -> tuple:
        """The slots ``[lo, hi)`` this rank holds and steps (all of them
        without a mesh, or where the data axes do not divide them)."""
        return self._lo, self._lo + self._n

    @property
    def sharded_state(self) -> SessionState:
        """The slot-batched state as ``DTensor`` views of every rank's
        slots, placed by ``sharding.session_specs`` (the mesh's state;
        without a mesh, ``state``)."""
        self._admit_now()
        if self._mesh is None:
            return self._state
        from torch.distributed.tensor import DTensor
        return sh.map_specs(lambda t, spec: DTensor.from_local(
            t, self._mesh, sh.to_placements(spec, self._mesh),
            run_check=False), self._state, self._specs)

    # -- slots under a mesh ---------------------------------------------------

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s index in this rank's state, None if another rank
        holds it."""
        i = slot - self._lo
        return i if 0 <= i < self._n else None

    def _sync(self) -> None:
        """Under a mesh, wait for every rank (after the first rank wrote
        or deleted a named checkpoint the others read)."""
        if self._mesh is not None:
            sh.gather_ranks(torch.zeros(1), self._mesh)

    def _take_slot(self, slot: int) -> SessionState:
        """One slot's registers (copies), from the rank that holds it."""
        self._admit_now()
        i = self._local(slot)
        if self._n_shards == 1:
            return pl.take_slot(self._state, i)
        row = pl.take_slot(self._state, 0 if i is None else i)
        flat = torch.cat([_bits(t) for t in row.tensors()])
        if i is None:
            flat = torch.zeros_like(flat)
        every = sh.gather_ranks(flat, self._mesh)
        coord, shard = [0] * self._mesh.ndim, slot // self._n
        names = list(self._mesh.mesh_dim_names)
        for a in reversed(sh.data_axes(self._mesh)):
            size = self._mesh.size(names.index(a))
            coord[names.index(a)], shard = shard % size, shard // size
        return _unbits(every[tuple(coord)], row)

    def stats(self) -> dict:
        total = sum(self.bucket_counts.values())
        return {
            "capacity": self.capacity,
            "resident": len(self._sessions),
            "free_slots": len(self._free),
            "steps_run": self.steps_run,
            "stream_impl": self.pipeline.config.stream_impl,
            "numerics": self.pipeline.config.numerics,
            "device": str(self.pipeline.device),
            "buckets": dict(sorted(self.bucket_counts.items())),
            "bucket_valid_samples": dict(sorted(self.bucket_valid.items())),
            "bucket_padded_samples": dict(sorted(
                self.bucket_padded.items())),
            "bucket_steps_total": total,
            "bucket_hit_rate": {L: round(c / total, 4) for L, c in
                                sorted(self.bucket_counts.items())}
            if total else {},
            # None = healthy, else the diagnosis naming the failed wave
            "poisoned": self._poisoned,
            "queued_requests": len(self._queue),
            "unresolved_requests": len(self._dispatched),
            "inflight_waves": len(self._inflight),
            "coalesce_watermark": self.coalesce_watermark,
            "coalesce_deadline": self.coalesce_deadline,
            "waits": self.waits,
            "admission_applies": self.admission_applies,
            "slots_admitted": self.slots_admitted,
        }

    # -- admission ------------------------------------------------------------

    def open(self, session_id: str) -> Session:
        """Admit a stream: from its parked checkpoint if there is one
        (bit-exact resume, float or int32 registers), else from cleared
        registers. Flushes the queue first: admission may evict, and the
        victim and its parked registers must reflect every submitted
        feed."""
        self._check_poisoned()
        with tracing.span("server.open"):
            self._flush_pending()
            if session_id in self._sessions:
                raise ValueError(f"session {session_id!r} already open")
            if not session_id or not all(ch.isalnum() or ch in "-_."
                                         for ch in session_id):
                raise ValueError(
                    f"session id {session_id!r}: use [A-Za-z0-9._-]")
            slot = self._acquire_slot()
            try:
                now = self._clock()
                sess = Session(id=session_id, slot=slot, opened_at=now,
                               last_fed=now, max_history=self._max_history)
                i = self._local(slot)
                name = self._ckpt_name(session_id)
                if self._manager is not None \
                        and self._manager.has_named(name):
                    # a pending reset of the slot must not wipe the row
                    self._admit_now()
                    with tracing.span("server.restore"):
                        row, meta = self._manager.restore_named(
                            name, pl.take_slot(self._state, 0))
                        if i is not None:
                            pl.put_slot(self._state, i, row)
                            pl.set_active(self._state, [i], True)
                    if meta:
                        sess.load_meta(meta)
                elif i is not None:
                    self._codes[i] = RESET
            except Exception:
                self._free.append(slot)  # a failed admission keeps no slot
                raise
            self._sessions[session_id] = sess
            return sess

    def close(self, session_id: str, *, checkpoint: bool = False) -> Session:
        """Release a session's slot after absorbing its queued feeds.
        ``checkpoint=True`` parks its registers and history for a later
        ``open`` (as eviction does); otherwise a parked copy is discarded
        and a later ``open`` of the id starts fresh."""
        with tracing.span("server.close"):
            self._flush_pending()
            if session_id not in self._sessions:
                raise KeyError(f"session {session_id!r} is not open")
            sess = self._sessions.pop(session_id)
            if checkpoint:
                with tracing.span("server.park"):
                    self._park(sess)
            elif self._manager is not None:
                if self._lead:
                    self._manager.delete_named(self._ckpt_name(session_id))
                self._sync()
            i = self._local(sess.slot)
            if i is not None:
                self._codes[i] |= OFF
            self._free.append(sess.slot)
            return sess

    def evict(self, session_id: str) -> Session:
        """Park a resident session in the checkpoint store and free its
        slot (needs ``checkpoint_dir``; an unknown id raises KeyError
        first)."""
        if session_id not in self._sessions:
            raise KeyError(f"session {session_id!r} is not open")
        if self._manager is None:
            raise RuntimeError("evict() needs checkpoint_dir")
        return self.close(session_id, checkpoint=True)

    def _park(self, sess: Session) -> None:
        if self._manager is None:
            raise RuntimeError("session checkpointing needs checkpoint_dir")
        row = self._take_slot(sess.slot)
        if self._lead:
            self._manager.save_named(self._ckpt_name(sess.id), row,
                                     meta=sess.meta())
        self._sync()

    def _admit_now(self) -> None:
        """Apply the pending admission codes before the registers are read
        or written outside a wave (not on a poisoned server, whose
        registers no one may trust)."""
        if self._poisoned is None and self._codes.any():
            with tracing.span("server.slot_write"):
                self._apply_admissions(torch.from_numpy(self._codes))

    def _apply_admissions(self, codes: torch.Tensor) -> None:
        """Write the pending admission codes, given as this rank's (n,)
        row on the host, into the registers: one ``slot_admit`` launch
        on the card after a copy that does not block the host (a pageable
        row is copied before the copy returns), torch ops on the CPU."""
        if self._cuda:
            self._admit_dev.copy_(codes, non_blocking=True)
            codes = self._admit_dev
        slot_admit(self._state.registers(), self._state.active, codes)
        self.admission_applies += 1
        self.slots_admitted += int(np.count_nonzero(self._codes))
        self._codes[:] = 0

    def _check_poisoned(self) -> None:
        if self._poisoned is not None:
            raise RuntimeError(
                f"server is poisoned: {self._poisoned}. The failed step may "
                "have left the slot-batched registers half written (and "
                "the card with a sticky CUDA error), so no resident "
                "session's registers can be trusted: build a new "
                "StreamServer and reopen sessions from their checkpoints")

    def _poison(self, what: str) -> RuntimeError:
        """Mark the server poisoned by ``what``; the error to raise."""
        self._poisoned = what
        return RuntimeError(f"feed() failed: {what}; the server is now "
                            "poisoned")

    @staticmethod
    def _ckpt_name(session_id: str) -> str:
        return f"session-{session_id}"

    def _acquire_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if self._manager is None:
            raise RuntimeError(
                f"server at capacity ({self.capacity}) and no "
                "checkpoint_dir to evict into")
        now = self._clock()
        lru = min(self._sessions.values(), key=lambda s: s.last_fed)
        refuse = self.evict_after is not None and \
            now - lru.last_fed < self.evict_after
        if self._mesh is not None:
            # the victim by the first rank's clock, the same on every rank
            mine = torch.tensor([-1 if refuse else lru.slot])
            pick = sh.gather_ranks(mine, self._mesh).reshape(-1)[0].item()
            refuse = pick < 0
            if not refuse:
                lru = next(s for s in self._sessions.values()
                           if s.slot == pick)
        if refuse:
            raise RuntimeError(
                f"server at capacity ({self.capacity}); least-recent "
                f"session {lru.id!r} idle {now - lru.last_fed:.1f}s < "
                f"evict_after={self.evict_after}s")
        self.evict(lru.id)
        return self._free.pop()

    # -- the hot path ---------------------------------------------------------

    def feed(self, requests: Iterable[Union[FeedRequest, tuple]]) -> list:
        """Absorb one chunk per request; one ``FeedResult`` per request,
        in request order.

        A request is a ``FeedRequest`` or ``(session_id, chunk)`` with a
        1-D float chunk; requests for one session apply in order. Chunks
        longer than ``max_chunk`` split; per wave every pending segment
        (one per session) is padded into one (S, L_bucket) batch. A fixed
        server quantizes onto its static ADC grid inside the step. This is
        ``submit(requests)`` + ``drain()``, so it also resolves requests
        queued earlier."""
        ticket = self.submit(requests)
        self.drain()
        return ticket.results

    def feed_async(self, requests: Iterable[Union[FeedRequest, tuple]]
                   ) -> FeedTicket:
        """Alias of :meth:`submit`, the asynchronous ``feed()``."""
        return self.submit(requests)

    def submit(self,
               requests: Iterable[Union[FeedRequest, tuple]]) -> FeedTicket:
        """Queue one chunk per request; the ``FeedTicket`` resolves at the
        next drain point. Every request is checked (open session, 1-D
        non-empty chunk) before any is queued. The queue dispatches at
        ``coalesce_watermark`` pending requests, when its oldest request
        is older than ``coalesce_deadline``, or in ``drain()``."""
        self._check_poisoned()
        key = next(_TICKETS)
        with tracing.span("server.submit", key):
            entries = []
            for r in requests:
                sid, chunk = ((r.session_id, r.chunk)
                              if isinstance(r, FeedRequest) else r)
                if sid not in self._sessions:
                    raise KeyError(f"session {sid!r} is not open")
                chunk = np.asarray(chunk, dtype=np.float32)
                if chunk.ndim != 1:
                    raise ValueError(
                        f"chunk for {sid!r} must be 1-D (samples,), got "
                        f"shape {chunk.shape}")
                if chunk.shape[0] == 0:
                    raise ValueError(f"empty chunk for session {sid!r}")
                segs = [chunk[i:i + self.max_chunk]
                        for i in range(0, chunk.shape[0], self.max_chunk)]
                entries.append((sid, segs, chunk.shape[0]))
            ticket = FeedTicket(n_requests=len(entries), key=key)
            if not entries:
                ticket.results = []
                return ticket
            for pos, (sid, segs, total) in enumerate(entries):
                self._queue.append(_Pending(ticket, pos, sid, segs, total))
            if self._queue_since is None:
                self._queue_since = self._clock()
            if (self.coalesce_watermark is not None
                    and len(self._queue) >= self.coalesce_watermark) \
                    or self._deadline_expired():
                self._dispatch()
            return ticket

    def poll(self, ticket: FeedTicket) -> Optional[list]:
        """The ticket's results if ready, else ``None``; never waits for
        the card. It dispatches the queue when the deadline has passed and
        resolves every dispatched request once the events of all waves
        that finish one have completed."""
        if ticket.done:
            return ticket.results
        self._check_poisoned()
        if self._deadline_expired():
            self._dispatch()
        if self._inflight and all(self._ready(ev, what) for _, ev, _, what
                                  in self._inflight):
            self._resolve()
        return ticket.results if ticket.done else None

    def drain(self) -> list:
        """Dispatch everything queued, wait once for the card and resolve
        every open ticket. Returns the ``FeedResult``s this drain
        resolved, in submit order."""
        self._check_poisoned()
        self._dispatch()
        return self._resolve()

    def _deadline_expired(self) -> bool:
        return (self.coalesce_deadline is not None
                and self._queue_since is not None
                and self._clock() - self._queue_since
                >= self.coalesce_deadline)

    def _flush_pending(self) -> None:
        """Absorb and resolve everything outstanding before a lifecycle
        change. A no-op on a poisoned server (the caller's own check owns
        the error)."""
        if self._poisoned is not None:
            return
        if self._queue or self._dispatched or self._inflight:
            with tracing.span("server.flush"):
                self._dispatch()
                self._resolve()

    def _ready(self, event, what: str) -> bool:
        if event is None:
            return True
        try:
            return event.query()
        except Exception as e:
            raise self._poison(f"the card failed running {what} "
                               f"({type(e).__name__})") from e

    def _wait(self, event, what: str) -> None:
        if event is None:
            return
        self.waits += 1
        try:
            with tracing.span("server.wait"):
                event.synchronize()
        except Exception as e:
            raise self._poison(f"the card failed running {what} "
                               f"({type(e).__name__})") from e

    def _stage_buffer(self, L: int) -> _StageBuffer:
        """Flip to the bucket's other staging buffer, wait for the event
        of the wave that last read it (the card is then two waves behind)
        and clear the slots that wave wrote."""
        ring = self._staging.get(L)
        if ring is None:
            ring = self._staging[L] = [
                _StageBuffer(self.capacity, L, self._cuda) for _ in range(2)]
            self._stage_flip[L] = 0
        k = self._stage_flip[L]
        self._stage_flip[L] = k ^ 1
        buf = ring[k]
        if buf.inflight is not None:
            self._wait(*buf.inflight)
            buf.inflight = None
        if buf.dirty:
            buf.batch_np[buf.dirty] = 0
            buf.valid_np[buf.dirty] = 0
            buf.dirty = []
        return buf

    def _dispatch(self) -> None:
        """Run the queued requests' waves without reading decisions back:
        one segment per session per wave, sessions coalesced, bucket = the
        power-of-two pad of the wave's longest segment."""
        if not self._queue:
            return
        reqs, self._queue = self._queue, []
        self._queue_since = None
        key = reqs[-1].ticket.key
        with tracing.span("server.dispatch", key):
            pending = [list(r.segs) for r in reqs]
            wave_no = 0
            failed = None       # (what, error) of this rank's failed step
            while any(pending):
                wave_no += 1
                with tracing.span("server.wave", key):
                    failed, last = self._wave(reqs, pending, wave_no,
                                              failed, key)
            self._dispatched.extend(reqs)
            if self._mesh is not None:
                self._agree(failed, *last)

    def _wave(self, reqs: list, pending: list, wave_no: int, failed,
              key) -> tuple:
        """Stage, launch and copy out the dispatch's next wave: the next
        segment of each request whose session has none in the wave yet.
        Returns (``failed``, (decisions on the host, event, name))."""
        with tracing.span("server.stage", key):
            wave, seen, finals = [], set(), []
            for i, r in enumerate(reqs):
                if pending[i] and r.sid not in seen:
                    wave.append((r, pending[i].pop(0)))
                    seen.add(r.sid)
                    if not pending[i]:
                        finals.append(r)
            L = bucket_length(max(seg.shape[0] for _, seg in wave),
                              self.min_chunk, self.max_chunk)
            buf = self._stage_buffer(L)
            valid = 0
            for r, seg in wave:
                slot = self._sessions[r.sid].slot
                n = seg.shape[0]
                buf.batch_np[slot, :n] = seg
                buf.valid_np[slot] = n
                buf.dirty.append(slot)
                valid += n
        what = (f"wave {wave_no} of a feed() call (bucket {L}, sessions "
                f"{sorted(r.sid for r, _ in wave)})")
        p = start = None
        if failed is None:
            try:
                with tracing.span("server.launch", key):
                    chunk_dev, valid_dev = self._batched.inputs(self._state,
                                                                L)
                    if self._cuda and tracing.recording():
                        start = self._timing_event()
                        t_start = time.perf_counter_ns()
                    lo, hi = self._lo, self._lo + self._n
                    chunk_dev.copy_(buf.batch[lo:hi], non_blocking=True)
                    valid_dev.copy_(buf.valid[lo:hi], non_blocking=True)
                    if self._codes.any():
                        with tracing.span("server.slot_write"):
                            buf.admit_np[lo:hi] = self._codes
                            self._apply_admissions(buf.admit[lo:hi])
                    _, p = self._step(self.pipeline, self._state, chunk_dev,
                                      valid_dev)
            except Exception as e:
                failed = (f"step raised {type(e).__name__} on {what}", e)
                if self._mesh is None:
                    raise self._poison(failed[0]) from e
        try:
            with tracing.span("server.copy_out", key):
                if self._mesh is not None:
                    # every rank joins every wave's gather, a failed one
                    # with its flag up, so no rank waits on another
                    p = self._gather_wave(p, failed is not None)
                p_host = (self._copy_out(p)
                          if finals or self._mesh is not None else None)
                if start is not None:
                    end = self._timing_event()
                event = self._record()
        except Exception as e:
            raise self._poison(f"step raised {type(e).__name__} on "
                               f"{what}") from e
        self.steps_run += 1
        self.bucket_counts[L] = self.bucket_counts.get(L, 0) + 1
        self.bucket_valid[L] = self.bucket_valid.get(L, 0) + valid
        self.bucket_padded[L] = self.bucket_padded.get(L, 0) \
            + L * len(wave) - valid
        if start is not None:
            self._timed.append((self.steps_run, key, start, end, t_start,
                                self._last_timed))
        self._last_timed = start is not None
        buf.inflight = (event, what) if event is not None else None
        if finals:
            # slots are taken now: a session cannot move before the
            # resolve (close() flushes first)
            self._inflight.append(
                (p_host, event,
                 [(r, self._sessions[r.sid].slot) for r in finals], what))
        return failed, (p_host, event, what)

    def _gather_wave(self, p: Optional[torch.Tensor],
                     failed: bool) -> torch.Tensor:
        """Every rank's decisions of a wave as (S + 1, C): a row per global
        slot, then a row of ones if any rank's step failed in this dispatch
        (``failed`` on this rank; ``p`` is then None), else zeros."""
        C = self.pipeline.clf.params.b_pos.shape[0]
        dev = self._state.acc.device
        if p is None:
            p = torch.zeros((self._n, C), dtype=torch.float32, device=dev)
        local = torch.cat([p, torch.full((self._n, 1), float(failed),
                                         dtype=p.dtype, device=dev)], 1)
        every = sh.gather_ranks(local, self._mesh)
        # the slot shards in order: the data axes' coordinates, the rest 0
        dp = sh.data_axes(self._mesh) if self._n_shards > 1 else ()
        rows = every[tuple(slice(None) if a in dp else 0
                           for a in self._mesh.mesh_dim_names)]
        flag = every[..., C].amax().reshape(1, 1).expand(1, C)
        return torch.cat([rows.reshape(-1, C + 1)[:, :C], flag], 0)

    def _agree(self, failed, p_host, event, what: str) -> None:
        """End of a dispatch under a mesh: wait for its last wave and
        poison this rank if its own step or another rank's failed."""
        self._wait(event, what)
        if failed is not None:
            raise self._poison(failed[0]) from failed[1]
        if p_host[-1, 0].item():
            raise self._poison(f"another rank's step failed in the waves "
                               f"up to {what}")

    def _copy_out(self, p: torch.Tensor) -> torch.Tensor:
        """The wave's decisions out of the step's output buffer, which the
        bucket's next run overwrites: into pinned host memory without
        blocking on the card, a copy on the CPU."""
        if not self._cuda:
            return p.clone()
        host = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
        host.copy_(p, non_blocking=True)
        return host

    def _record(self):
        if not self._cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _timing_event(self):
        """A timed CUDA event from the pool, recorded now."""
        event = self._timing_pool.pop() if self._timing_pool \
            else torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _read_timings(self) -> None:
        """Hand the timed waves' card times to the tracer (their events
        have completed: the stream runs in order and the last wave's event
        did) and return their events to the pool, but the last end."""
        prev = self._last_end
        for wave, key, start, end, t_start, chained in self._timed:
            gap = prev.elapsed_time(start) if chained else None
            tracing.record_wave(wave, key, t_start, start.elapsed_time(end),
                                gap)
            if prev is not None:
                self._timing_pool.append(prev)
            self._timing_pool.append(start)
            prev = end
        self._timed.clear()
        self._last_end = prev

    def _resolve(self) -> list:
        """Wait once (for the last wave's event; the stream runs in order)
        and resolve every dispatched request in submit order: per wave, the
        argmax over its finishing slots' decision rows."""
        if not self._dispatched:
            return []
        with tracing.span("server.resolve", self._dispatched[-1].ticket.key):
            if self._inflight:
                self._wait(self._inflight[-1][1], self._inflight[-1][3])
            if self._timed:
                self._read_timings()
            for p_host, _, finals, _ in self._inflight:
                rows = p_host.numpy()[np.asarray([s for _, s in finals])]
                labels = np.argmax(rows, axis=1)
                for (r, _), label, row in zip(finals, labels, rows):
                    r.label = int(label)
                    r.conf = float(row[label])
            self._inflight.clear()
            now = self._clock()
            results, tickets = [], []
            for r in self._dispatched:
                sess = self._sessions[r.sid]
                # samples_seen advances by the whole request, once
                total = sess.samples_seen + r.total
                sess.record(Decision(total, r.label, r.conf), now)
                fr = FeedResult(session_id=r.sid, label=r.label,
                                confidence=r.conf, samples_seen=total)
                results.append(fr)
                if r.ticket.results is None:
                    r.ticket.results = [None] * r.ticket.n_requests
                    tickets.append(r.ticket)
                r.ticket.results[r.pos] = fr
            self._dispatched.clear()
            # dispatch takes the whole queue, so every ticket resolved fully
            assert all(None not in t.results for t in tickets)
            return results
