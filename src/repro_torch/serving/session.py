"""Session bookkeeping for the stream server.

A *session* is one long-lived sensor stream pinned to a slot of the
slot-batched ``SessionState`` while resident. Only classified data leaves
the device, so the decision history is the session's whole output: every
feed appends a :class:`Decision`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

__all__ = ["Decision", "Session", "FeedRequest", "FeedResult", "HISTORY_LEN"]

HISTORY_LEN = 64    # decisions kept per session, newest last


@dataclasses.dataclass(frozen=True)
class Decision:
    """One classifier readout: the decision from all evidence so far."""
    samples_seen: int
    label: int
    confidence: float


@dataclasses.dataclass
class Session:
    """Host-side record of a resident stream (its registers live in the
    slot-batched ``SessionState`` on the device)."""
    id: str
    slot: int
    samples_seen: int = 0
    history: List[Decision] = dataclasses.field(default_factory=list)

    def record(self, decision: Decision) -> None:
        self.samples_seen = decision.samples_seen
        self.history.append(decision)
        del self.history[:-HISTORY_LEN]

    @property
    def last_decision(self) -> Optional[Decision]:
        return self.history[-1] if self.history else None


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
