"""Sequence tracking: a whole clip, or ``reps`` steps over a frame pool, in
one call that reads nothing back until the end.

Port of ``gstreamer_vit_tracker_tpu/tracker/scan.py``.  JAX's ``lax.scan``
becomes a Python loop: every step only enqueues device work (the state and
the per-step results stay tensors on the device), and the per-step results
come back stacked, one host read for the whole run.  Frames are stacked
over the clip in any of the three formats: RGB (N, H, W, 3), NV12 planes
((N, H, W), (N, H/2, W/2, 2)) or YUY2 (N, H, W*2).  The HUD variant
(``update_scan_hud_pool``) comes with the overlay modules.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import ModelConfig
from ..device import resolve_device
from . import core, multi
from .state import TrackState

Params = Dict[str, Any]


def _pool(frames, frame_format: str, dev: torch.device):
    """The frame pool's planes on the device, and its length."""
    planes = core._frame_on(frames, frame_format, dev)
    return planes, planes[0].shape[0]


def _pick(planes, i):
    """Frame ``i`` (an index or a slice) of a pool's planes."""
    return tuple(p[i] for p in planes)


def update_scan(params: Params, state: TrackState, frames, cfg: ModelConfig,
                frame_format: str = "rgb", device="cuda"
                ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Track a whole clip.  ``frames``: stacked over frames (module
    docstring).

    Returns (final_state, bboxes (N, 4), scores (N,)).
    """
    dev = resolve_device(device)
    planes, n = _pool(frames, frame_format, dev)
    bboxes, scores = [], []
    for i in range(n):
        state, bbox, conf = core.update(params, state, _pick(planes, i), cfg,
                                        frame_format, dev)
        bboxes.append(bbox)
        scores.append(conf)
    return state, torch.stack(bboxes), torch.stack(scores)


def update_scan_pool(params: Params, state: TrackState, frames, reps: int,
                     cfg: ModelConfig, frame_format: str = "nv12",
                     fused_prep=False, device="cuda"
                     ) -> Tuple[TrackState, torch.Tensor]:
    """Benchmark variant: ``reps`` tracked frames cycling through a small
    device-resident frame pool by index.  Returns (state, scores (reps,)).
    ``fused_prep`` routes the NV12 step through the one-kernel preprocess +
    embed (``core.update``)."""
    dev = resolve_device(device)
    planes, pool = _pool(frames, frame_format, dev)
    scores = []
    for i in range(reps):
        state, _bbox, conf = core.update(
            params, state, _pick(planes, i % pool), cfg, frame_format,
            dev, fused_prep=fused_prep)
        scores.append(conf)
    return state, torch.stack(scores)


def update_streams_scan_pool(params: Params, state: TrackState, frames,
                             active, reps: int, cfg: ModelConfig,
                             frame_format: str = "nv12", device="cuda"
                             ) -> Tuple[TrackState, torch.Tensor]:
    """``reps`` batched multi-stream steps in one call.

    S independent streams advance together, each stream s reading pool
    frame ``(i + s) % P``, so content differs across streams without
    duplicating the pool on the device.  ``state`` is a (S, M)-leading
    TrackState from ``multi.init_streams``; ``active`` (S, M) bool is
    constant across the run.  Returns (state, scores (reps, S, M)).

    As in JAX, a step's frames are one contiguous slice of a cyclically
    extended pool (built once per call), not a row gather.
    """
    dev = resolve_device(device)
    planes, pool = _pool(frames, frame_format, dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    n_streams = active.shape[0]
    need = pool + n_streams          # slice start < pool, length n_streams
    tiles = -(-need // pool)

    def extend(x):
        return torch.cat([x] * tiles, dim=0)[:need]

    planes = tuple(extend(p) for p in planes)
    scores = []
    for i in range(reps):
        start = i % pool
        fr = _pick(planes, slice(start, start + n_streams))
        state, _bx, sc = multi.update_streams(params, state, fr, active, cfg,
                                              frame_format, device=dev)
        scores.append(sc)
    return state, torch.stack(scores)


def update_objects_scan_pool(params: Params, state: TrackState, frames,
                             active, reps: int, cfg: ModelConfig,
                             frame_format: str = "nv12", device="cuda"
                             ) -> Tuple[TrackState, torch.Tensor]:
    """``reps`` multi-object steps (N targets, one shared frame per step)
    in one call, cycling the frame pool.  Returns (state, scores
    (reps, N))."""
    dev = resolve_device(device)
    planes, pool = _pool(frames, frame_format, dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    scores = []
    for i in range(reps):
        state, _bx, sc = multi.update_objects(
            params, state, _pick(planes, i % pool), active, cfg,
            frame_format, device=dev)
        scores.append(sc)
    return state, torch.stack(scores)
