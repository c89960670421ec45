"""Routing tier: stream id -> server shard -> slot.

One admission API in front of N ``StreamServer`` shards. A stream's shard
is a stable hash of its id (crc32, not Python's salted ``hash``), so a
session lands on the same shard across processes and restarts, and an
evicted session finds its parked checkpoint again: each shard parks into
its own ``checkpoint_dir`` subdirectory (``shard-00``, ``shard-01``, ...).

The shards share one step (:func:`repro_torch.serving.server.
make_batched_step`), as the reference's shards share one compile; each
still captures its own CUDA graph per bucket, because a graph is bound to
its server's buffers. The slot-batched step is row-parallel, so a
stream's registers and decisions do not depend on its co-tenants, its
slot or its shard: sharded serving is bit for bit one server holding the
same sessions.

Backpressure is per shard: a full shard evicts its own least-recently-fed
idle session, or raises naming the shard when it has nowhere to park;
``stats()`` shows each shard's residency and queue.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Iterable, List, Optional, Union

import numpy as np

from repro_torch.core.pipeline import InFilterPipeline
from repro_torch.serving.server import StreamServer, make_batched_step
from repro_torch.serving.session import FeedRequest, FeedResult, Session

__all__ = ["StreamRouter", "RouterTicket", "shard_of"]


def shard_of(session_id: str, num_shards: int) -> int:
    """Stream id -> shard, stable across runs."""
    return zlib.crc32(session_id.encode("utf-8")) % num_shards


@dataclasses.dataclass
class RouterTicket:
    """Handle for one router ``submit()``: the shards' tickets with the
    request positions each covers, assembled in request order."""
    n_requests: int
    parts: list                       # [(shard, FeedTicket, [pos, ...])]
    results: Optional[List[FeedResult]] = None

    @property
    def done(self) -> bool:
        return self.results is not None

    def _try_assemble(self) -> None:
        if self.results is not None \
                or not all(t.done for _, t, _ in self.parts):
            return
        out: list = [None] * self.n_requests
        for _, ticket, positions in self.parts:
            for res, pos in zip(ticket.results, positions):
                out[pos] = res
        self.results = out


class StreamRouter:
    """N ``StreamServer`` shards behind one admission and feed API.

    ``capacity`` and the other server parameters apply per shard (total
    residency ``num_shards * capacity``); ``checkpoint_dir`` fans out into
    one subdirectory per shard.
    """

    def __init__(self, pipeline: InFilterPipeline, num_shards: int = 2,
                 capacity: int = 64, *,
                 checkpoint_dir: Optional[str] = None, **server_kw):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self.pipeline = pipeline
        step = server_kw.pop("step_fn", None) or make_batched_step(pipeline)
        self._shards = []
        for k in range(num_shards):
            ck = None
            if checkpoint_dir is not None:
                ck = os.path.join(checkpoint_dir, f"shard-{k:02d}")
                os.makedirs(ck, exist_ok=True)
            self._shards.append(StreamServer(pipeline, capacity,
                                             checkpoint_dir=ck, step_fn=step,
                                             **server_kw))
        self._tickets: List[RouterTicket] = []   # outstanding

    # -- admission / lifecycle ------------------------------------------------

    def shard_of(self, session_id: str) -> int:
        return shard_of(session_id, self.num_shards)

    def shard(self, k: int) -> StreamServer:
        return self._shards[k]

    @property
    def shards(self) -> list:
        return list(self._shards)

    def open(self, session_id: str) -> Session:
        k = self.shard_of(session_id)
        try:
            return self._shards[k].open(session_id)
        except RuntimeError as e:
            # a full shard is THIS shard: the id is pinned to its hash
            raise RuntimeError(f"shard {k}: {e}") from e

    def close(self, session_id: str, *, checkpoint: bool = False) -> Session:
        return self._shards[self.shard_of(session_id)].close(
            session_id, checkpoint=checkpoint)

    def evict(self, session_id: str) -> Session:
        return self._shards[self.shard_of(session_id)].evict(session_id)

    def session(self, session_id: str) -> Session:
        return self._shards[self.shard_of(session_id)].session(session_id)

    def sessions(self) -> list:
        return [s for srv in self._shards for s in srv.sessions()]

    def is_open(self, session_id: str) -> bool:
        return session_id in self._shards[self.shard_of(session_id)]

    def __contains__(self, session_id: str) -> bool:
        return self.is_open(session_id)

    def stats(self) -> dict:
        per = [s.stats() for s in self._shards]

        def per_bucket(key: str) -> dict:
            out: dict = {}
            for p in per:
                for L, n in p[key].items():
                    out[L] = out.get(L, 0) + n
            return dict(sorted(out.items()))

        return {
            "num_shards": self.num_shards,
            "capacity": sum(p["capacity"] for p in per),
            "resident": sum(p["resident"] for p in per),
            "steps_run": sum(p["steps_run"] for p in per),
            "queued_requests": sum(p["queued_requests"] for p in per),
            "bucket_valid_samples": per_bucket("bucket_valid_samples"),
            "bucket_padded_samples": per_bucket("bucket_padded_samples"),
            "waits": sum(p["waits"] for p in per),
            "poisoned": {k: p["poisoned"] for k, p in enumerate(per)
                         if p["poisoned"] is not None} or None,
            "shards": per,
        }

    # -- feeding --------------------------------------------------------------

    def _split(self, requests) -> list:
        """Group requests by shard, keeping per-shard submit order and each
        request's position. Checks every request (open session, 1-D
        non-empty chunk) before any shard queues one."""
        by_shard: dict[int, list] = {}
        for pos, r in enumerate(requests):
            sid, chunk = ((r.session_id, r.chunk) if isinstance(r, FeedRequest)
                          else r)
            k = self.shard_of(sid)
            srv = self._shards[k]
            srv._check_poisoned()
            if sid not in srv:
                raise KeyError(f"session {sid!r} is not open")
            arr = np.asarray(chunk)
            if arr.ndim != 1:
                raise ValueError(
                    f"chunk for {sid!r} must be 1-D (samples,), got shape "
                    f"{arr.shape}")
            if arr.shape[0] == 0:
                raise ValueError(f"empty chunk for session {sid!r}")
            by_shard.setdefault(k, []).append((pos, sid, chunk))
        return sorted(by_shard.items())

    def feed(self, requests: Iterable[Union[FeedRequest, tuple]]) -> list:
        """Synchronous feed across shards; results in request order."""
        ticket = self.submit(requests)
        self.drain()
        return ticket.results

    def feed_async(self, requests) -> RouterTicket:
        return self.submit(requests)

    def submit(self,
               requests: Iterable[Union[FeedRequest, tuple]]) -> RouterTicket:
        """Queue each request on its shard; the ``RouterTicket`` resolves
        to one ``FeedResult`` per request, in request order, at the next
        ``drain()`` or ready ``poll()``."""
        requests = list(requests)
        parts = [(k, self._shards[k].submit([(sid, chunk)
                                             for _, sid, chunk in batch]),
                  [pos for pos, _, _ in batch])
                 for k, batch in self._split(requests)]
        ticket = RouterTicket(n_requests=len(requests), parts=parts)
        if not parts:
            ticket.results = []
        else:
            self._tickets.append(ticket)
        return ticket

    def poll(self, ticket: RouterTicket) -> Optional[list]:
        if ticket.done:
            return ticket.results
        for k, sub, _ in ticket.parts:
            self._shards[k].poll(sub)
        ticket._try_assemble()
        if ticket.done:
            self._tickets = [t for t in self._tickets if not t.done]
            return ticket.results
        return None

    def drain(self) -> list:
        """Drain every shard, then assemble every outstanding ticket.
        Returns the results this drain resolved, shard by shard (the
        tickets hold them in request order)."""
        out = []
        for srv in self._shards:
            out.extend(srv.drain())
        for t in self._tickets:
            t._try_assemble()
        self._tickets = [t for t in self._tickets if not t.done]
        return out
