"""Batched tracking: multi-object and multi-stream in one step.

Port of ``gstreamer_vit_tracker_tpu/tracker/multi.py``:

* ``update_objects``: N targets in ONE shared frame;
* ``update_streams``: S independent streams, each with its own frame and
  M targets, in one batched inference step.

Where JAX lifts ``core.update`` with ``vmap``, ``core.update`` here takes
the leading dimensions written out, so these functions call it once on the
whole batch.  They carry per-slot ``active`` masks (an inactive slot keeps
its state bit for bit: a ``where`` on every leaf, no arithmetic blend) and
return bbox and score tensors on the device.  The batched callers pass
``fused=False``: the encoder runs per block, with its attention in the
CUDA attention kernels on the card.

The ``*_jit`` names are the compiled entry points (``utils/graph.py``), as
JAX's ``jax.jit`` programs: one CUDA graph per key, replayed; the two
updates donate the state (the call returns the graph's static state
buffers, updated in place), the inits return fresh tensors.  Under a mesh
in context they are compiled for it (the mesh is part of the key), as
``parallel/serving.py::ShardedStreamTracker`` calls ``init_streams_jit``;
on the tensor-parallel route the encoder's collectives go into the graph.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..utils import graph
from . import core
from .state import TrackState

Params = Dict[str, Any]


@functools.lru_cache(maxsize=None)
def _batched_cfg(cfg: ModelConfig) -> ModelConfig:
    """Config for batched updates: banding off, as in JAX.

    Each slot's resample products run over the whole frame.  For frames no
    larger than the band the batched and the unbatched step compute the
    same crop.  When a crop window EXCEEDS the band (a huge target, or the
    lost-ramp expansion on a large frame) they differ by design: the banded
    unbatched step zero-pads the out-of-band fringe while this full-width
    path samples the real pixels."""
    if cfg.preprocess_band is None:
        return cfg
    return dataclasses.replace(cfg, preprocess_band=None)


def _pairwise_iou(b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xywh -> (..., N, N) IoU matrices."""
    x1, y1 = b[..., 0], b[..., 1]
    x2, y2 = b[..., 0] + b[..., 2], b[..., 1] + b[..., 3]
    ix = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]))
    iy = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]))
    inter = torch.clamp_min(ix, 0.0) * torch.clamp_min(iy, 0.0)
    area = b[..., 2] * b[..., 3]
    return inter / (area[..., :, None] + area[..., None, :] - inter + 1e-9)


def _suppress_duplicates(new: TrackState, old: TrackState,
                         bboxes: torch.Tensor, scores: torch.Tensor,
                         active: torch.Tensor, thr: float
                         ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Exclusive slots: when two slots' boxes collapse onto one target, the
    lower-confidence duplicate is treated as a lost measurement: its bbox
    reverts to the pre-update box, its confidence is zeroed and
    ``lost_frames`` increments, which engages the window freeze and the
    re-detection ramp.  Higher confidence wins a pair; ties go to the lower
    slot index.  The objects are the last leading dimension; slots of
    different streams never interact.  No host read."""
    n = scores.shape[-1]
    m = _pairwise_iou(bboxes)
    idx = torch.arange(n, device=scores.device)
    rival, own = scores[..., None, :], scores[..., :, None]
    rival_wins = (rival > own) | ((rival == own) & (idx[None, :] < idx[:, None]))
    both = (active[..., :, None] & active[..., None, :]
            & (idx[:, None] != idx[None, :]))
    loser = ((m > thr) & rival_wins & both).any(dim=-1)

    bboxes = torch.where(loser[..., None], old.bbox, bboxes)
    scores = torch.where(loser, torch.zeros_like(scores), scores)
    new = new._replace(
        bbox=torch.where(loser[..., None], old.bbox, new.bbox),
        score=torch.where(loser, torch.zeros_like(new.score), new.score),
        lost_frames=torch.where(loser, old.lost_frames + 1, new.lost_frames),
        # The loser measured the RIVAL's target, so a template update taken
        # this frame (it runs inside core.update, before suppression) would
        # have blended the rival's appearance into the loser's template.
        z_tok=torch.where(loser[..., None, None], old.z_tok, new.z_tok))
    return new, bboxes, scores


def _mask_state(new: TrackState, old: TrackState,
                active: torch.Tensor) -> TrackState:
    """Per-slot select: keep ``old`` wherever ``active`` is False."""

    def sel(n, o):
        a = active.reshape(active.shape + (1,) * (n.dim() - active.dim()))
        return torch.where(a, n, o)

    return TrackState(*(sel(n, o) for n, o in zip(new, old)))


def _update_batch(params: Params, state: TrackState, frames, active,
                  cfg: ModelConfig, frame_format: str, exclusive: bool,
                  device) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    # fused=False: the physical batch is the slot count, where the encoder
    # runs per block (see models/vit.py::encode).
    new_state, bboxes, scores = core.update(
        params, state, frames, _batched_cfg(cfg), frame_format, dev,
        fused=False)
    new_state = _mask_state(new_state, state, active)
    bboxes = torch.where(active[..., None], bboxes, state.bbox)
    scores = torch.where(active, scores, state.score)
    if exclusive:
        new_state, bboxes, scores = _suppress_duplicates(
            new_state, state, bboxes, scores, active,
            cfg.exclusive_overlap_threshold)
    return new_state, bboxes, scores


# ---------------------------------------------------------------------------
# Multi-object (one frame, N targets)
# ---------------------------------------------------------------------------

def init_objects(params: Params, frame, bboxes, cfg: ModelConfig,
                 frame_format: str = "rgb", device="cuda") -> TrackState:
    """bboxes (N, 4) -> batched TrackState with leading axis N."""
    return core.init(params, frame, bboxes, _batched_cfg(cfg), frame_format,
                     device)


def update_objects(params: Params, state: TrackState, frame, active,
                   cfg: ModelConfig, frame_format: str = "rgb",
                   exclusive: bool = False, device="cuda"
                   ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """One frame, N targets.  active: (N,) bool.  Returns
    (state, bboxes (N, 4), scores (N,)).

    ``exclusive`` enables cross-slot duplicate suppression (see
    :func:`_suppress_duplicates`): slots sharing one frame refuse to
    collapse onto the same target after a lookalike crossing."""
    return _update_batch(params, state, frame, active, cfg, frame_format,
                         exclusive, device)


# ---------------------------------------------------------------------------
# Multi-stream (S frames, M targets each)
# ---------------------------------------------------------------------------

def init_streams(params: Params, frames, bboxes, cfg: ModelConfig,
                 frame_format: str = "rgb", device="cuda") -> TrackState:
    """frames batched on axis 0 (S, ...); bboxes (S, M, 4)."""
    return core.init(params, frames, bboxes, _batched_cfg(cfg), frame_format,
                     device)


def update_streams(params: Params, state: TrackState, frames, active,
                   cfg: ModelConfig, frame_format: str = "rgb",
                   exclusive: bool = False, device="cuda"
                   ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """S streams x M targets in one step.  frames batched on axis 0;
    active (S, M) bool.  Returns (state, bboxes (S, M, 4), scores (S, M)).
    ``exclusive`` suppresses duplicate locks per stream (objects sharing a
    frame; slots in different streams never interact)."""
    return _update_batch(params, state, frames, active, cfg, frame_format,
                         exclusive, device)


# ---------------------------------------------------------------------------
# Compiled entry points (donated state)
# ---------------------------------------------------------------------------

init_objects_jit = graph.Compiled(init_objects, "multi.init_objects_jit",
                                  static=("cfg", "frame_format"))
init_streams_jit = graph.Compiled(init_streams, "multi.init_streams_jit",
                                  static=("cfg", "frame_format"))
update_objects_jit = graph.Compiled(
    update_objects, "multi.update_objects_jit",
    static=("cfg", "frame_format", "exclusive"), donate={"state": (0,)})
update_streams_jit = graph.Compiled(
    update_streams, "multi.update_streams_jit",
    static=("cfg", "frame_format", "exclusive"), donate={"state": (0,)})
