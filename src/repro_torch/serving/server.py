"""StreamServer: many sensor streams, one session step per wave.

The server owns a slot-batched ``SessionState`` of fixed capacity S on the
pipeline's device. ``open()`` pins a session to a free slot (registers
cleared), ``feed()`` absorbs chunks for any subset of resident sessions —
per wave, every pending segment is padded into ONE (S, L_bucket) batch
with per-slot valid counts, and absent slots ride along inertly — and
``close()`` frees the slot. Packet lengths pad up to the next power of two
in ``[min_chunk, max_chunk]`` (longer packets split), so the step sees at
most ``log2(max_chunk / min_chunk) + 1`` distinct lengths.

This is the synchronous core. Eviction to checkpoints, the async
``submit``/``poll``/``drain`` pipeline, the router and the poisoned-server
contract come with the serving slice (ROADMAP.md §1, "Serving").
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.pipeline import InFilterPipeline, SessionState
from repro_torch.serving.session import (Decision, FeedRequest, FeedResult,
                                         Session)

__all__ = ["StreamServer", "bucket_length"]


def bucket_length(n: int, min_chunk: int, max_chunk: int) -> int:
    """Next power of two >= n, clamped to [min_chunk, max_chunk]."""
    if n <= 0:
        raise ValueError(f"chunk length must be positive, got {n}")
    b = min_chunk
    while b < n:
        b <<= 1
    return min(b, max_chunk)


class StreamServer:
    """Multiplex sensor streams onto ``capacity`` slots of one pipeline.

    ``pipeline.config.stream_impl`` picks the step's octave cascade ("pallas"
    = the CUDA stream kernel, "xla" = torch ops; the same decisions).
    ``max_chunk`` and ``min_chunk`` must be powers of two.
    """

    def __init__(self, pipeline: InFilterPipeline, capacity: int = 64, *,
                 max_chunk: int = 4096, min_chunk: int = 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not (0 < min_chunk <= max_chunk):
            raise ValueError("need 0 < min_chunk <= max_chunk")
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
        self.pipeline = pipeline
        self.capacity = capacity
        self.max_chunk = max_chunk
        self.min_chunk = min_chunk
        self._state = pipeline.init_session(
            capacity, active=np.zeros((capacity,), bool))
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0
        self._sessions: dict[str, Session] = {}
        self.bucket_counts: dict[int, int] = {}
        self.steps_run = 0

    # -- introspection --------------------------------------------------------

    @property
    def state(self) -> SessionState:
        return self._state

    def session(self, session_id: str) -> Session:
        try:
            return self._sessions[session_id]
        except KeyError:
            raise KeyError(f"session {session_id!r} is not open") from None

    def __contains__(self, session_id: str) -> bool:
        return session_id in self._sessions

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
            "bucket_steps_total": total,
            "bucket_hit_rate": {L: round(c / total, 4) for L, c in
                                sorted(self.bucket_counts.items())}
            if total else {},
        }

    # -- admission ------------------------------------------------------------

    def open(self, session_id: str) -> Session:
        """Admit a stream into a free slot, from cleared registers."""
        if session_id in self._sessions:
            raise ValueError(f"session {session_id!r} already open")
        if not session_id or not all(ch.isalnum() or ch in "-_."
                                     for ch in session_id):
            raise ValueError(
                f"session id {session_id!r}: use [A-Za-z0-9._-]")
        if not self._free:
            raise RuntimeError(f"server at capacity ({self.capacity})")
        slot = self._free.pop()
        sess = Session(id=session_id, slot=slot)
        pl.clear_slots(self._state, [slot])
        pl.set_active(self._state, [slot], True)
        self._sessions[session_id] = sess
        return sess

    def close(self, session_id: str) -> Session:
        """Release a session's slot; a later ``open`` of any id starts
        from cleared registers."""
        if session_id not in self._sessions:
            raise KeyError(f"session {session_id!r} is not open")
        sess = self._sessions.pop(session_id)
        pl.set_active(self._state, [sess.slot], False)
        self._free.append(sess.slot)
        return sess

    # -- the hot path ---------------------------------------------------------

    def feed(self, requests: Iterable[Union[FeedRequest, tuple]]) -> list:
        """Absorb one chunk per request; one ``FeedResult`` per request, in
        request order.

        A request is a ``FeedRequest`` or ``(session_id, chunk)`` with a
        1-D float chunk. Every request is validated before any runs.
        Chunks longer than ``max_chunk`` split into segments; each wave
        takes at most one segment per session, in request order, and runs
        as one padded (S, L_bucket) step.
        """
        entries = []
        for r in requests:
            sid, chunk = ((r.session_id, r.chunk) if isinstance(r, FeedRequest)
                          else r)
            if sid not in self._sessions:
                raise KeyError(f"session {sid!r} is not open")
            chunk = np.asarray(chunk, dtype=np.float32)
            if chunk.ndim != 1:
                raise ValueError(
                    f"chunk for {sid!r} must be 1-D (samples,), got shape "
                    f"{chunk.shape}")
            if chunk.shape[0] == 0:
                raise ValueError(f"empty chunk for session {sid!r}")
            segs = [chunk[i:i + self.max_chunk]
                    for i in range(0, chunk.shape[0], self.max_chunk)]
            entries.append([sid, segs, chunk.shape[0], None])
        dev = self.pipeline.device
        while any(e[1] for e in entries):
            wave, seen = [], set()
            for e in entries:
                if e[1] and e[0] not in seen:
                    wave.append((e, e[1].pop(0)))
                    seen.add(e[0])
            L = bucket_length(max(seg.shape[0] for _, seg in wave),
                              self.min_chunk, self.max_chunk)
            batch = np.zeros((self.capacity, L), np.float32)
            valid = np.zeros((self.capacity,), np.int32)
            for e, seg in wave:
                slot = self._sessions[e[0]].slot
                batch[slot, :seg.shape[0]] = seg
                valid[slot] = seg.shape[0]
            self._state, p, _ = self.pipeline._session_step(
                self._state, torch.from_numpy(batch).to(dev),
                torch.from_numpy(valid).to(dev))
            self.steps_run += 1
            self.bucket_counts[L] = self.bucket_counts.get(L, 0) + 1
            finals = [e for e, _ in wave if not e[1]]
            if finals:
                p_host = p.cpu().numpy()
                for e in finals:
                    row = p_host[self._sessions[e[0]].slot]
                    e[3] = row
        results = []
        for sid, _, total, row in entries:
            sess = self._sessions[sid]
            label = int(np.argmax(row))
            seen_total = sess.samples_seen + total
            sess.record(Decision(seen_total, label, float(row[label])))
            results.append(FeedResult(sid, label, float(row[label]),
                                      seen_total))
        return results
