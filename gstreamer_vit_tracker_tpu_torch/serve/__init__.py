"""Multi-stream tracking service: batch-serving the tracker over TCP.

Port of ``gstreamer_vit_tracker_tpu/serve``: the SlotEngine (one
static-shape batched step, dynamic streams as masked slots) exposed through
a dependency-free wire protocol.  ``python -m
gstreamer_vit_tracker_tpu_torch.serve`` starts it on the card.
"""

from .client import TrackClient, TrackServiceError
from .engine import PackedTick, SlotEngine
from .server import TrackServer

__all__ = ["SlotEngine", "PackedTick", "TrackServer", "TrackClient",
           "TrackServiceError"]
