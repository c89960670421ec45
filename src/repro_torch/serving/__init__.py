"""Stream serving over the slot-batched session step."""

from repro_torch.serving.server import StreamServer, bucket_length  # noqa: F401
from repro_torch.serving.session import (  # noqa: F401
    Decision,
    FeedRequest,
    FeedResult,
    Session,
)
