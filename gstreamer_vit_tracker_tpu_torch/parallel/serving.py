"""Multi-rank serving: N video streams sharded across the data axis.

Port of ``gstreamer_vit_tracker_tpu/parallel/serving.py``.  BASELINE.json
config 4 (16 concurrent 1080p streams in one batched step), scaled past
one card: every rank of the mesh runs a tracker with the same arguments
and makes the same calls; frames and per-stream ``TrackState`` shard their
leading axis over the mesh ``data`` axis, params replicate, and each rank
steps its slice of the streams with NO cross-stream communication.  The
one collective a tick is the gather of the results, so every rank returns
them whole.

As in JAX, ``init`` runs ``multi.init_streams_jit`` and a tick is one
compiled program (``utils/graph.py``): the step, then the gather of the
boxes and scores, the state donated (the tracker's state is the graph's
static buffers, updated in place).  On NCCL ranks the gather is captured
into the graph; on gloo ranks that share a card the eager bodies run by
name (``graph.compiles_under``).  ``recover`` re-uploads the params, so
the next tick misses its key on every rank together.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.weights import tree_to
from ..tracker import multi
from ..tracker.state import TrackState
from ..utils import graph
from .mesh import DATA_AXIS, current_mesh, use_mesh
from .sharding import replicate, shard_batch
from .tensor import all_gather_cat

Params = Dict[str, Any]


def _sharded_step(params: Params, state: TrackState, frames, active,
                  cfg: ModelConfig, frame_format: str, device):
    """One tick of this rank's streams, then every rank's boxes and scores
    gathered over the mesh's ``data`` axis (JAX's ``_step`` under the
    mesh): (state, bboxes (S, M, 4), scores (S, M))."""
    state, bboxes, scores = multi.update_streams(
        params, state, frames, active, cfg, frame_format, device=device)
    group = current_mesh().get_group(DATA_AXIS)
    return (state, all_gather_cat(bboxes, 0, group),
            all_gather_cat(scores, 0, group))


class ShardedStreamTracker:
    """Mesh-wide multi-stream tracker.

    Usage (on every rank):
        t = ShardedStreamTracker(mesh, params, cfg, frame_format="nv12")
        t.init(frames, bboxes)                  # (S, ...) , (S, M, 4)
        bboxes, scores = t.update(frames)       # one batched step per tick
    """

    def __init__(self, mesh, params: Params, cfg: ModelConfig,
                 frame_format: str = "rgb", snapshot_every: int = 60,
                 device="cuda"):
        self.mesh = mesh
        self.cfg = cfg
        self.frame_format = frame_format
        self.device = resolve_device(device)
        # Host-side copies for device-loss recovery: params re-upload from
        # this copy, live TrackState from the periodic snapshot (the
        # contract of the single-stream TorchTrackerBackend.recover).
        self._host_params = tree_to(params, "cpu", copy=True)
        self.params = tree_to(replicate(params, mesh), self.device)
        self.state: TrackState | None = None
        self.snapshot_every = snapshot_every
        self._snapshot = None          # (host TrackState, host active)
        self._ticks = 0
        self.compiled = graph.compiles_under(mesh, self.device)
        self._step = graph.Compiled(_sharded_step,
                                    "parallel.ShardedStreamTracker.update",
                                    static=("cfg", "frame_format"),
                                    donate={"state": (0,)})

    def _shard_frames(self, frames):
        if self.frame_format != "nv12":
            frames = (frames,)
        planes = tuple(torch.as_tensor(p).to(self.device)
                       for p in shard_batch(tuple(frames), self.mesh))
        return planes if self.frame_format == "nv12" else planes[0]

    def _take_snapshot(self) -> None:
        cpu = torch.device("cpu")
        self._snapshot = (TrackState(*(t.to(cpu, copy=True)
                                       for t in self.state)),
                          self.active.to(cpu, copy=True))

    def init(self, frames, bboxes) -> None:
        frames = self._shard_frames(frames)
        bboxes = torch.as_tensor(shard_batch(torch.as_tensor(
            bboxes, dtype=torch.float32), self.mesh), device=self.device)
        init = multi.init_streams_jit if self.compiled else multi.init_streams
        with use_mesh(self.mesh):
            self.state = init(self.params, frames, bboxes, self.cfg,
                              self.frame_format, self.device)
        self.active = torch.ones(bboxes.shape[:2], dtype=torch.bool,
                                 device=self.device)
        self._ticks = 0
        # Immediate first snapshot: recovery works from tick one.
        if self.snapshot_every:
            self._take_snapshot()

    def update(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """One tick: (bboxes (S, M, 4), scores (S, M)) of every stream."""
        if self.state is None:
            raise RuntimeError("call init first")
        self._ticks += 1
        if self.snapshot_every and self._ticks % self.snapshot_every == 0:
            self._take_snapshot()
        frames = self._shard_frames(frames)
        step = self._step if self.compiled else _sharded_step
        with use_mesh(self.mesh):
            self.state, bboxes, scores = step(
                self.params, self.state, frames, self.active, self.cfg,
                self.frame_format, self.device)
        return bboxes, scores

    def recover(self) -> None:
        """Rebuild device state after a device fault: params re-replicate
        from the host copy; live per-stream state restores from the latest
        snapshot (or drops to None, requiring re-init, when none was taken
        yet).  One call, then the next ``update`` tick proceeds
        normally."""
        self._step.drop(self.params)
        multi.init_streams_jit.drop(self.params)
        self.params = tree_to(replicate(self._host_params, self.mesh),
                              self.device)
        if self._snapshot is not None:
            state, active = self._snapshot
            self.state = TrackState(*(t.to(self.device, copy=True)
                                      for t in state))
            self.active = active.to(self.device, copy=True)
        else:
            self.state = None
