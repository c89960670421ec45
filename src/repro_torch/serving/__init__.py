"""Session-oriented stream serving for the in-filter classifier.

``StreamServer`` multiplexes many sensor streams onto the slot capacity of
one slot-batched ``SessionState``: one session step per wave, on the card
one CUDA graph replay per wave (``make_batched_step``). ``submit()`` /
``feed_async()`` queue requests for coalesced dispatch and ``drain()`` is
the sync point; ``StreamRouter`` spreads residency over N shards behind
one admission API (stream id -> shard -> slot).
"""

from repro_torch.serving.session import (Decision, FeedRequest, FeedResult,
                                         FeedTicket, Session)
from repro_torch.serving.server import (StreamServer, bucket_length,
                                        make_batched_step)
from repro_torch.serving.router import RouterTicket, StreamRouter, shard_of

__all__ = ["StreamServer", "StreamRouter", "Session", "Decision",
           "FeedRequest", "FeedResult", "FeedTicket", "RouterTicket",
           "bucket_length", "make_batched_step", "shard_of"]
