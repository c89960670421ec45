"""Session bookkeeping for the stream server.

A *session* is one long-lived sensor stream pinned to a slot of the
slot-batched ``SessionState`` while resident. Only classified data leaves
the device, so the decision history is the session's whole output: every
feed appends a :class:`Decision`, and the history goes with the session's
registers when it is parked in the named-checkpoint store
(:meth:`Session.meta` / :meth:`Session.load_meta`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

__all__ = ["Decision", "Session", "FeedRequest", "FeedResult", "FeedTicket"]


@dataclasses.dataclass(frozen=True)
class Decision:
    """One classifier readout: the decision from all evidence so far."""
    samples_seen: int
    label: int
    confidence: float


@dataclasses.dataclass
class Session:
    """Host-side record of a resident stream (its registers live in the
    slot-batched ``SessionState`` on the device). ``max_history`` bounds
    the decisions kept, newest last."""
    id: str
    slot: int
    opened_at: float
    last_fed: float
    samples_seen: int = 0
    history: List[Decision] = dataclasses.field(default_factory=list)
    max_history: int = 64

    def record(self, decision: Decision, now: float) -> None:
        self.samples_seen = decision.samples_seen
        self.last_fed = now
        self.history.append(decision)
        if len(self.history) > self.max_history:
            del self.history[: len(self.history) - self.max_history]

    @property
    def last_decision(self) -> Optional[Decision]:
        return self.history[-1] if self.history else None

    def meta(self) -> dict:
        """JSON-serializable side data parked with an evicted session (the
        reference's layout, so either package reads the other's)."""
        return {
            "samples_seen": int(self.samples_seen),
            "history": [[int(d.samples_seen), int(d.label),
                         float(d.confidence)] for d in self.history],
        }

    def load_meta(self, meta: dict) -> None:
        self.samples_seen = int(meta.get("samples_seen", 0))
        self.history = [Decision(int(s), int(lb), float(c))
                        for s, lb, c in meta.get("history", [])]


@dataclasses.dataclass(frozen=True)
class FeedRequest:
    """One chunk of one session's audio. ``chunk`` is 1-D (samples,)."""
    session_id: str
    chunk: Any


@dataclasses.dataclass(frozen=True)
class FeedResult:
    """Per-request readout after the session absorbed the chunk."""
    session_id: str
    label: int
    confidence: float
    samples_seen: int


@dataclasses.dataclass
class FeedTicket:
    """Handle for one ``submit()`` / ``feed_async()`` batch.

    ``results`` flips from ``None`` to one :class:`FeedResult` per request,
    in request order, when the server resolves it (``drain()``, a
    ``poll()`` that finds the device done, or a lifecycle call that
    flushes the queue). A result is the decision after ALL of the
    request's chunks, splits and coalesced co-tenants included: bit for
    bit what a synchronous ``feed()`` of the same requests returns.
    """
    n_requests: int
    results: Optional[List[FeedResult]] = None
    # the process-wide serial that keys this batch's spans
    # (``repro_torch.tracing``)
    key: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.results is not None
