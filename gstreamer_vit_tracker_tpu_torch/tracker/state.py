"""TrackState: the per-target state carried between frames, on the device.

Port of ``gstreamer_vit_tracker_tpu/tracker/state.py``.  Every field is a
tensor on the tracker's device, so an update step reads nothing back to
the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TrackState(NamedTuple):
    """State carried between frames for one tracked target."""

    z_tok: torch.Tensor       # (Nz, D) cached template tokens (current)
    z_tok_init: torch.Tensor  # (Nz, D) template tokens captured at init
    bbox: torch.Tensor        # (4,) float32 (x, y, w, h) in frame pixels
    score: torch.Tensor       # () float32 last confidence
    frame_idx: torch.Tensor   # () int32 frames since init
    # () int32 consecutive low-confidence frames; drives the re-detection
    # search-window growth and resets to 0 on any confident frame.
    lost_frames: torch.Tensor
