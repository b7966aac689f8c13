"""Tracking-session state machine: Selecting -> Tracking -> Lost.

Faithful port of the reference's TrackerContext
(reference tracker_context.rs) over a pluggable tracker backend:

* two-phase corner confirm (latch start corner, then init on second
  confirm, tracker_context.rs:70-112);
* init is validated by an immediate ``update`` accepted only if
  ``success && score > 0.25`` (rs:90-98);
* per-frame tracking publishes bbox+score while ``score > 0.25`` (rs:122),
  else transitions to Lost;
* Lost counts frames and auto-resets to selection once the counter
  *exceeds* 60 — i.e. on its 62nd lost frame (rs:142-152);
* Cancel resets to selection at any time (rs:53-58); Quit is a no-op at
  this layer (rs:59).

The backend abstraction lets the machine run against the port's tracker
(single- or multi-object) or deterministic stubs in tests.  The port's own
copy of ``gstreamer_vit_tracker_tpu/session/machine.py``: the machine is
the original's, ``TorchTrackerBackend`` replaces ``JaxTrackerBackend``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, Tuple

import torch

from ..config import SessionConfig
from ..device import resolve_device, true_float32
from ..models import vittrack
from ..models.weights import tree_to
from ..tracker import core
from .commands import Kind, UserCommand
from .selection import SelectionPhase, SelectionState

BBox = Tuple[float, float, float, float]


class TrackerBackend(Protocol):
    def init(self, frame: Any, bbox: BBox) -> None: ...

    def update(self, frame: Any) -> Tuple[BBox, float, bool]:
        """Returns (bbox, score, success)."""


@dataclasses.dataclass
class Lost:
    frames: int = 0


class SessionState:
    SELECTING = "selecting"
    TRACKING = "tracking"
    LOST = "lost"


class TrackerSession:
    """Owns the tracker backend + UI state (TrackerContext analog)."""

    def __init__(self, tracker: TrackerBackend, width: int, height: int,
                 cfg: SessionConfig = SessionConfig(),
                 log: Callable[[str], None] = lambda s: print(s + "\r")):
        self.tracker = tracker
        self.cfg = cfg
        self.frame_width = width
        self.frame_height = height
        self.state: str = SessionState.SELECTING
        self.lost = Lost()
        self.selection = SelectionState.new(width, height, cfg)
        self.current_bbox: Optional[BBox] = None
        self.current_score: float = 0.0
        self.pending_confirm = False
        self.log = log

    # -- command plane (tracker_context.rs:36-61) --------------------------

    def handle_command(self, cmd: UserCommand) -> None:
        k = cmd.kind
        if k == Kind.MOVE_UP:
            self.selection.move_cursor(0, -1, cmd.fast, self.frame_width,
                                       self.frame_height)
        elif k == Kind.MOVE_DOWN:
            self.selection.move_cursor(0, 1, cmd.fast, self.frame_width,
                                       self.frame_height)
        elif k == Kind.MOVE_LEFT:
            self.selection.move_cursor(-1, 0, cmd.fast, self.frame_width,
                                       self.frame_height)
        elif k == Kind.MOVE_RIGHT:
            self.selection.move_cursor(1, 0, cmd.fast, self.frame_width,
                                       self.frame_height)
        elif k == Kind.CONFIRM:
            self.pending_confirm = True
        elif k == Kind.CANCEL:
            self.state = SessionState.SELECTING
            self.selection = SelectionState.new(self.frame_width,
                                                self.frame_height, self.cfg)
            self.current_bbox = None
            self.log("Reset to selection mode")
        elif k == Kind.QUIT:
            pass

    # -- frame plane (tracker_context.rs:64-155) ---------------------------

    def process_frame(self, frame: Any) -> Optional[BBox]:
        if self.state == SessionState.SELECTING:
            return self._process_selecting(frame)
        if self.state == SessionState.TRACKING:
            return self._process_tracking(frame)
        return self._process_lost(frame)

    def _process_selecting(self, frame: Any) -> Optional[BBox]:
        if not self.pending_confirm:
            return None
        self.pending_confirm = False

        if self.selection.phase == SelectionPhase.MOVING_TO_START:
            self.selection.start_x = self.selection.cursor_x
            self.selection.start_y = self.selection.cursor_y
            self.selection.phase = SelectionPhase.SELECTING_AREA
            self.log(f"*** Start point set at ({self.selection.start_x}, "
                     f"{self.selection.start_y}) ***")
            self.log("Now move to the SECOND corner and press Enter")
            return None

        bbox = self.selection.get_bbox(self.cfg.min_bbox)
        self.log(f"*** Initializing tracker with bbox: x={bbox[0]}, "
                 f"y={bbox[1]}, w={bbox[2]}, h={bbox[3]} ***")
        try:
            self.tracker.init(frame, bbox)
            result_bbox, score, success = self.tracker.update(frame)
        except Exception as e:  # tracker error path (rs:105-109)
            self.log(f"Tracker error: {e!r}")
            self._recover_backend()
            self.selection = SelectionState.new(self.frame_width,
                                                self.frame_height, self.cfg)
            return None

        self.log(f"Init result: score={score:.3f}")
        if success and score > self.cfg.score_threshold:
            self.current_bbox = result_bbox
            self.current_score = score
            self.state = SessionState.TRACKING
            self.log("*** TRACKING STARTED! ***")
            return self.current_bbox
        self.log("Low score - please try selecting a different area")
        self.selection = SelectionState.new(self.frame_width,
                                            self.frame_height, self.cfg)
        return None

    def _process_tracking(self, frame: Any) -> Optional[BBox]:
        self.pending_confirm = False
        try:
            bbox, score, success = self.tracker.update(frame)
        except Exception as e:
            self.log(f"Tracker error: {e!r}")
            self._recover_backend()
            if self.current_bbox is not None:
                # recover() drops TrackState (and with it the template);
                # re-seed from the last confirmed box on this frame so the
                # Lost ramp below can actually re-acquire.  Device faults
                # last a few frames, so the box is still live — without
                # this, every Lost-mode update raises 'tracker not
                # initialised' and the session limps to the auto-reset.
                try:
                    self.tracker.init(frame, self.current_bbox)
                except Exception as e2:
                    self.log(f"Re-init after recovery failed: {e2!r}")
            self.state = SessionState.LOST
            self.lost = Lost(0)
            return None
        if success and score > self.cfg.score_threshold:
            self.current_bbox = bbox
            self.current_score = score
            return bbox
        self.log(f"Track lost (score={score:.2f})")
        self.state = SessionState.LOST
        self.lost = Lost(0)
        self.current_score = 0.0
        return None

    def _recover_backend(self) -> None:
        """After a tracker exception, give the backend a chance to rebuild
        its device state (e.g. re-upload params after a device/relay
        reset).  Backends without a ``recover`` hook are left alone — the
        Lost/auto-reset path still re-arms the session."""
        recover = getattr(self.tracker, "recover", None)
        if recover is None:
            return
        try:
            recover()
        except Exception as e:
            self.log(f"Backend recovery failed: {e!r}")

    def force_lost(self) -> None:
        """Drop the session into Lost (fresh counter) after an external
        fault — e.g. the app loop recovering from a device/relay error.
        The normal Lost countdown then auto-resets to selection.  This
        exceeds the reference, which simply exits on pipeline errors
        (main.rs:56-65)."""
        self.state = SessionState.LOST
        self.lost = Lost(0)
        self.current_score = 0.0

    def _process_lost(self, frame: Any) -> Optional[BBox]:
        self.pending_confirm = False
        if self.lost.frames > self.cfg.lost_frames_max:
            self.log("Auto-reset to selection mode")
            self.state = SessionState.SELECTING
            self.selection = SelectionState.new(self.frame_width,
                                                self.frame_height, self.cfg)
            self.current_bbox = None
            return None
        # Keep updating while Lost: the core's frozen window + re-detection
        # ramp (tracker/core.py) only advance when the tracker sees frames,
        # so a target reappearing after occlusion is re-acquired here —
        # deliberately exceeding the reference, whose Lost state only
        # counts frames (tracker_context.rs:142-152).  The 60-frame
        # auto-reset above is preserved unchanged.
        try:
            bbox, score, success = self.tracker.update(frame)
        except Exception as e:
            self.log(f"Tracker error: {e!r}")
            self._recover_backend()
            self.lost = Lost(self.lost.frames + 1)
            return None
        if success and score > self.cfg.score_threshold:
            self.current_bbox = bbox
            self.current_score = score
            self.state = SessionState.TRACKING
            self.log(f"*** Target re-acquired (score={score:.2f}) ***")
            return bbox
        self.lost = Lost(self.lost.frames + 1)
        return None

    # -- status (tracker_context.rs:157-166) -------------------------------

    def state_name(self) -> str:
        if self.state == SessionState.SELECTING:
            if self.selection.phase == SelectionPhase.MOVING_TO_START:
                return "SELECT START"
            return "SELECT END"
        if self.state == SessionState.TRACKING:
            return "TRACKING"
        return "LOST"


class TorchTrackerBackend:
    """TrackerBackend over the port's tracker core (tracker/core.py), the
    counterpart of the JAX package's ``JaxTrackerBackend``.

    Keeps the TrackState on the device between calls; ``init`` runs
    ``core.init_jit`` and each ``update`` enqueues one
    ``core.update_packed_jit`` step (compiled entry points, the state
    donated: ``utils/graph.py``) and reads its five numbers (bbox and
    score) back in one device-to-host copy.

    ``pipelined=True`` trades one frame of latency for throughput: the
    step's result is copied into a pinned host buffer without blocking and
    a CUDA event is recorded behind the copy; ``update`` returns the
    *previous* frame's result, waiting on that frame's event, so the host
    never waits for the step it just enqueued (the reference's decoupled
    streaming threads and leaky display queue, pipeline_ir.rs:75-84, show
    slightly stale overlays the same way).  Two host buffers alternate: one
    being filled, one being read.
    """

    def __init__(self, params: Dict[str, Any], cfg, frame_format: str = "rgb",
                 pipelined: bool = False, device="cuda"):
        self.device = resolve_device(device)
        true_float32(self.device)
        self.params = vittrack.with_grouped_head(params)
        self.cfg = cfg
        self.frame_format = frame_format
        self.pipelined = pipelined
        self._pending = None
        self.state = None
        # Host-side copy for device-loss recovery (a dead device leaves
        # self.params pointing at unreachable memory).
        self._host_params = tree_to(self.params, "cpu", copy=True)
        on_card = self.device.type == "cuda"
        self._host = [torch.empty(5, dtype=torch.float32, pin_memory=on_card)
                      for _ in range(2)]
        self._events = [torch.cuda.Event() if on_card else None
                        for _ in range(2)]
        self._turn = 0

    def recover(self) -> None:
        """Rebuild device state after a device fault: re-upload the params
        from the host copy and drop the (possibly dead) TrackState, the
        pending result and the graphs captured against the old params.  The
        session re-inits on the next confirm."""
        core.init_jit.drop(self.params)
        core.update_packed_jit.drop(self.params)
        self.params = tree_to(self._host_params, self.device, copy=True)
        self.state = None
        self._pending = None

    def init(self, frame, bbox) -> None:
        self.state = core.init_jit(self.params, frame, bbox, self.cfg,
                                   self.frame_format, self.device)
        self._pending = None

    def update(self, frame):
        if self.state is None:
            raise RuntimeError("tracker not initialised")
        self.state, packed = core.update_packed_jit(
            self.params, self.state, frame, self.cfg, self.frame_format,
            self.device)
        if self.pipelined:
            buf, event = self._host[self._turn], self._events[self._turn]
            self._turn ^= 1
            buf.copy_(packed, non_blocking=True)
            if event is not None:
                event.record()
            prev, self._pending = self._pending, (buf, event)
            if prev is None:          # first frame: no previous result yet
                prev = self._pending
            buf, event = prev
            if event is not None:
                event.synchronize()
            vals = buf.numpy()
        else:
            vals = packed.cpu().numpy()   # ONE device->host read per frame
        return tuple(float(v) for v in vals[:4]), float(vals[4]), True
