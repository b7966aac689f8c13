"""TrackState: the per-target state carried between frames, on the device.

Port of ``gstreamer_vit_tracker_tpu/tracker/state.py``.  Every field is a
tensor on the tracker's device, so an update step reads nothing back to
the host.  A batched state carries leading dimensions on every field:
(N,) for the objects of one frame, (S, M) for streams and their objects.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..device import resolve_device


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


def zeros_state(cfg: ModelConfig, dtype=torch.float32,
                device="cuda") -> TrackState:
    """An inert state (the fill of a slot that holds no track)."""
    dev = resolve_device(device)
    nz, d = cfg.num_template_tokens, cfg.embed_dim
    tok_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else dtype
    return TrackState(
        z_tok=torch.zeros((nz, d), dtype=tok_dtype, device=dev),
        z_tok_init=torch.zeros((nz, d), dtype=tok_dtype, device=dev),
        bbox=torch.zeros((4,), dtype=torch.float32, device=dev),
        score=torch.zeros((), dtype=torch.float32, device=dev),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
        lost_frames=torch.zeros((), dtype=torch.int32, device=dev),
    )


def stack_states(states) -> TrackState:
    """Stack per-target states into a batched TrackState (leading axis)."""
    return TrackState(*(torch.stack(leaves) for leaves in zip(*states)))
