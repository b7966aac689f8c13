"""Slot engine: a fixed pool of tracking slots over ONE batched step.

Port of ``gstreamer_vit_tracker_tpu/serve/engine.py``.  The serving tick is
the batched multi-stream update (``tracker/multi.py::update_streams``) with
a static slot count S: dynamic arrival and departure of clients is data
(the per-tick ``active`` mask and a write into one row of the state), never
a new shape.  An idle slot costs a masked row.

Fault story: params keep a host-side master copy, live slot state snapshots
to the host every ``snapshot_every`` ticks, and :meth:`SlotEngine.recover`
rebuilds the device state after a device fault.  Slots initialised after
the last snapshot come back dead: their clients must re-init (the server
reports this).

Frames come in any of the protocol's formats (``nv12``, ``yuy2``, ``rgb``),
one per engine.

The tick and the slot write are compiled entry points
(``utils/graph.py``), JAX's ``_step_packed`` and ``_write_slot``: each a
CUDA graph captured once and replayed, the state donated (the engine's
state is the tick graph's static buffers, updated in place), the frames,
the active mask and the slot index copied into static buffers, the slot
a device scalar so one graph serves every slot.  Each engine holds its
own graphs; :meth:`SlotEngine.recover` drops them.

Serving over several ranks (``mesh=``, as in JAX): every rank of the mesh
runs an engine with the same arguments and makes the same calls.  The slot
axis shards over the mesh ``data`` axis: a rank holds and steps the state
of its slice of the slots, and :meth:`SlotEngine.step` gathers the packed
rows, so every rank returns the full (S, 5) result.  On a pure-data mesh
the params are replicated (no collective inside the tick); on a dp x tp
mesh they take the Megatron layout (``parallel/sharding.py``) and the
encoder's blocks run tensor-parallel over ``model``
(``models/vit.py::_tp_block``).  The slot count must tile the data axis.
Under a mesh the tick's program holds the gather of the packed rows (on
NCCL captured with the rest), and the slot write runs on the ranks that
hold the slot only, so its body holds no collective
(``parallel/tensor.py::no_collectives`` raises if one comes in).  On gloo
ranks that share a card both run their eager bodies by name
(``graph.compiles_under``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..parallel import mesh as pmesh
from ..parallel import sharding
from ..parallel.tensor import all_gather_cat, no_collectives
from ..tracker import core, multi
from ..tracker.multi import _batched_cfg
from ..tracker.state import TrackState, zeros_state
from ..utils import graph
from . import protocol

Params = Dict[str, Any]


def _tree_to(tree: Any, device: torch.device, dtype=None) -> Any:
    """A copy of a param tree on ``device`` (always new storage, so the
    copy survives whatever happens to the original), floating leaves cast
    to ``dtype`` if one is given."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.detach().to(device, dtype if tree.is_floating_point() else None,
                            copy=True)


def _step_packed(params: Params, state: TrackState, frames, active,
                 cfg: ModelConfig, frame_format: str, device) -> tuple:
    """One serving tick: S streams -> (new_state, packed (S, 5)), the
    packed [x, y, w, h, score] rows one tensor for one host read.  Under
    a mesh this rank steps its rows and the packed rows of every rank are
    gathered over ``data``."""
    state, bboxes, scores = multi.update_streams(params, state, frames,
                                                 active, cfg, frame_format,
                                                 device=device)
    packed = torch.cat([bboxes[:, 0, :], scores], dim=1)
    mesh = pmesh.current_mesh()
    if mesh is not None:
        packed = all_gather_cat(packed, 0, mesh.get_group(pmesh.DATA_AXIS))
    return state, packed


def _write_slot(state: TrackState, params: Params, frame, bbox, slot,
                cfg: ModelConfig, frame_format: str, device) -> TrackState:
    """``core.init`` one target (the batched config: band off), written
    into row ``slot`` ((1,) int64 on the device) of the (S, 1, ...)
    state in place."""
    new = core.init(params, frame, bbox, _batched_cfg(cfg), frame_format,
                    device)
    for batched, leaf in zip(state, new):
        batched.index_copy_(0, slot, leaf[None, None].to(batched.dtype))
    return state


class PackedTick:
    """The packed (S, 5) [x, y, w, h, score] result of one tick, not yet
    read.  ``packed`` is the tensor on the engine's device; ``np.asarray``
    of this object waits for that tick alone and gives the host copy.

    On the card the copy into pinned host memory is enqueued right behind
    the tick and an event recorded behind the copy, so a reader on another
    thread neither reads early nor waits for ticks enqueued later."""

    def __init__(self, packed: torch.Tensor):
        self.packed = packed
        self._event: Optional[torch.cuda.Event] = None
        if packed.is_cuda:
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(packed.device))
        else:
            self._host = packed

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype)


class SlotEngine:
    """S tracking slots, one batched step, host-snapshot recovery.

    Not thread-safe by itself: the server serialises all calls (``lock``).
    The engine's state is updated in place by :meth:`init_slot`; what it
    keeps of a caller's frame or bbox is a copy.  Under a mesh ``state``
    holds this rank's slots only (``rows`` of the S)."""

    def __init__(self, params: Params, cfg: ModelConfig, slots: int,
                 frame_format: str = "nv12", snapshot_every: int = 60,
                 device="cuda", mesh=None):
        if frame_format not in protocol.FORMATS:
            raise ValueError(f"unknown frame format {frame_format!r}")
        self.cfg = cfg
        self.slots = slots
        self.frame_format = frame_format
        self.snapshot_every = snapshot_every
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rows = range(slots)
        if mesh is not None:
            # Slots tile the DATA axis (the model axis does not split them).
            dp = pmesh.axis_size(mesh, pmesh.DATA_AXIS)
            if slots % dp != 0:
                raise ValueError(f"slots={slots} must be a multiple of the "
                                 f"mesh data-axis size {dp}")
            r, n = mesh.get_local_rank(pmesh.DATA_AXIS), slots // dp
            self.rows = range(r * n, (r + 1) * n)
        self._host_params = _tree_to(params, torch.device("cpu"))
        self.params = self._place_params()
        # This engine's compiled tick and slot write.
        self.compiled = graph.compiles_under(mesh, self.device)
        self._tick = graph.Compiled(_step_packed, "engine.step_packed",
                                    static=("cfg", "frame_format"),
                                    donate={"state": (0,)})
        self._write = graph.Compiled(_write_slot, "engine.write_slot",
                                     static=("cfg", "frame_format"),
                                     donate={"state": ()})
        self.state: TrackState = self._zero_state()
        # Host-side occupancy: which slots hold a live track.  Device-side
        # liveness is the per-tick active mask built from this.
        self.occupied = np.zeros(slots, bool)
        self._ticks = 0
        self._snapshot = None    # (host TrackState, occupancy at snapshot)
        self.lock = threading.Lock()

    def _place_params(self) -> Params:
        """The host master params on the device (this rank's shards on a
        mesh with a model axis wider than 1).  The blocks, which the model
        casts to its compute dtype at every use, are cast here once (the
        same rounding, 144 fewer copies a tick for the flagship)."""
        host = self._host_params
        if self.mesh is not None and pmesh.axis_size(
                self.mesh, pmesh.MODEL_AXIS) > 1:
            host = sharding.shard_params(host, self.mesh)
        params = _tree_to(host, self.device)
        backbone = dict(params["backbone"])
        backbone["blocks"] = _tree_to(
            host["backbone"]["blocks"], self.device,
            torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32)
        params["backbone"] = backbone
        return params

    def _zero_state(self) -> TrackState:
        z = zeros_state(self.cfg, device=self.device)
        return TrackState(*(torch.zeros((len(self.rows), 1) + t.shape,
                                        dtype=t.dtype, device=self.device)
                            for t in z))

    # -- slot lifecycle ----------------------------------------------------

    def alloc(self) -> int:
        """Reserve a free slot index; raises RuntimeError when full."""
        free = np.flatnonzero(~self.occupied)
        if free.size == 0:
            raise RuntimeError(f"all {self.slots} slots busy")
        self.occupied[free[0]] = True
        return int(free[0])

    def init_slot(self, slot: int, frame, bbox) -> None:
        """Start a track in ``slot``: ``core.init`` with the batched config
        (band off), written into row ``slot`` of the (S, 1, ...) state (on
        a mesh, by the ranks that hold that slot)."""
        if slot in self.rows:
            row = np.asarray([slot - self.rows.start], np.int64)
            write = self._write
            if not self.compiled:
                write, row = _write_slot, torch.as_tensor(row,
                                                          device=self.device)
            with pmesh.use_mesh(self.mesh), no_collectives(self._write.name):
                self.state = write(self.state, self.params, frame, bbox, row,
                                   self.cfg, self.frame_format, self.device)
        self.occupied[slot] = True
        if self._snapshot is None:
            self.snapshot()

    def release(self, slot: int) -> None:
        self.occupied[slot] = False

    # -- the tick ------------------------------------------------------------

    def step_async(self, frames, tick_active: np.ndarray) -> PackedTick:
        """Enqueue one batched tick WITHOUT reading the result: returns a
        :class:`PackedTick` whose ``packed`` is the (S, 5) [x, y, w, h,
        score] tensor on the device; the caller materialises it later with
        ``np.asarray``.

        The next tick may be enqueued at once (the state chain runs in
        stream order), so a server overlaps the read of tick N with the
        device work of tick N+1."""
        self._ticks += 1
        if self.snapshot_every and self._ticks % self.snapshot_every == 0:
            self.snapshot()
        rows = slice(self.rows.start, self.rows.stop)
        active = (tick_active & self.occupied)[rows, None]
        if self.compiled:
            # The frames and the mask go straight into the graph's static
            # buffers (from pinned memory the upload is asynchronous).
            tick, frames = self._tick, self._host_frames(frames)
        else:
            tick, frames = _step_packed, self._place_frames(frames)
            active = torch.as_tensor(active, device=self.device)
        with pmesh.use_mesh(self.mesh):
            self.state, packed = tick(self.params, self.state, frames,
                                      active, self.cfg, self.frame_format,
                                      self.device)
        return PackedTick(packed)

    def step(self, frames, tick_active: np.ndarray) -> np.ndarray:
        """One SYNCHRONOUS batched tick.  ``frames`` are full (S, ...) host
        buffers (a (Y, UV) pair for nv12, one array for yuy2 and rgb);
        ``tick_active`` (S,) bool marks slots with a FRESH frame this tick
        (stale slots' state is held bit for bit by the masked update).
        Returns packed (S, 5) [x, y, w, h, score] float32."""
        return np.asarray(self.step_async(frames, tick_active))

    def _host_frames(self, frames):
        """(S, ...) planes, this rank's rows of them, where they lie."""
        if self.frame_format != "nv12" and not isinstance(frames, tuple):
            frames = (frames,)
        rows = slice(self.rows.start, self.rows.stop)
        return tuple(torch.as_tensor(p)[rows] for p in frames)

    def _place_frames(self, frames):
        """Host (S, ...) planes onto the device (this rank's rows of them);
        from pinned memory the upload is asynchronous."""
        return tuple(p.to(self.device, non_blocking=True)
                     for p in self._host_frames(frames))

    # -- fault recovery ------------------------------------------------------

    def snapshot(self) -> None:
        cpu = torch.device("cpu")
        self._snapshot = (TrackState(*(t.detach().to(cpu, copy=True)
                                       for t in self.state)),
                          self.occupied.copy())

    def recover(self) -> list:
        """Rebuild device state after a device fault, from the host master
        params and the last snapshot.  Returns the slot indices that could
        NOT be restored (initialised after the last snapshot, or never
        snapshotted): the server reports these to their clients as
        re-init-required."""
        self._tick.drop(self.params)
        self._write.drop(self.params)
        self.params = self._place_params()
        if self._snapshot is None:
            lost = np.flatnonzero(self.occupied)
            self.state = self._zero_state()
            self.occupied[:] = False
            return [int(i) for i in lost]
        state, occ = self._snapshot
        self.state = TrackState(*(t.to(self.device, copy=True) for t in state))
        lost = np.flatnonzero(self.occupied & ~occ)
        self.occupied = occ.copy()
        return [int(i) for i in lost]
