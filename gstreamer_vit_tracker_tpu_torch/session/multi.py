"""Multi-target session: N objects, one batched device update per frame.

The reference tracks strictly one object (a single TrackerContext,
reference tracker_context.rs); this module deliberately exceeds
it by making the framework's batching story (tracker/multi.py,
BASELINE.json config 3) user-visible in the interactive app: targets are
selected one after another with the same two-phase cursor flow, then ALL
of them advance in one ``update_objects`` program per frame, with the
reference's per-target thresholds applied slot-by-slot (score 0.25,
60-frame lost auto-reset back to selectable, 20 px minimum box —
tracker_context.rs:93,122,144; selection_state.rs:42).  The port's own copy
of ``gstreamer_vit_tracker_tpu/session/multi.py``: the session is the
original's, ``TorchMultiTrackerBackend`` replaces the JAX backend.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SessionConfig
from ..device import resolve_device, true_float32
from ..models.weights import tree_to
from ..tracker import multi
from ..tracker.state import TrackState
from .commands import Kind, UserCommand
from .selection import SelectionPhase, SelectionState

BBox = Tuple[float, float, float, float]


class TorchMultiTrackerBackend:
    """Batched N-object tracker over tracker/multi.py, the counterpart of
    the JAX package's ``JaxMultiTrackerBackend``.

    Slots init independently (``init_slot`` writes a fresh single-object
    state from ``multi.init_objects_jit`` into row ``k`` of the batched
    TrackState); every ``update`` advances all active slots in one
    ``multi.update_objects_jit`` step (compiled, the state donated) and
    reads (N, 4) boxes and (N,) scores back in one device-to-host copy.
    Carries the same host-param-copy ``recover()`` contract as the
    single-object backend (session/machine.py).
    """

    def __init__(self, params: Dict[str, Any], cfg, n_objects: int,
                 frame_format: str = "rgb", exclusive: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        true_float32(self.device)
        self.params = params
        self.cfg = cfg
        self.n = n_objects
        self.frame_format = frame_format
        # Cross-slot duplicate suppression (tracker/multi.py): slots
        # sharing the frame refuse to collapse onto one target.
        self.exclusive = exclusive
        self.state = None
        self.active = np.zeros(n_objects, bool)
        self._host_params = tree_to(params, "cpu", copy=True)

    def init_slot(self, frame, k: int, bbox) -> None:
        bb = torch.as_tensor(bbox, dtype=torch.float32, device=self.device)
        if self.state is None:
            # First target: build the full batched state from this box
            # (inactive slots are masked out of every update).
            self.state = multi.init_objects_jit(
                self.params, frame, bb[None].repeat(self.n, 1), self.cfg,
                self.frame_format, self.device)
        else:
            one = multi.init_objects_jit(self.params, frame, bb[None],
                                         self.cfg, self.frame_format,
                                         self.device)
            self.state = TrackState(*(torch.cat([s[:k], o, s[k + 1:]])
                                      for s, o in zip(self.state, one)))
        self.active[k] = True

    def deactivate(self, k: int) -> None:
        self.active[k] = False

    def _step(self, frame, active: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.state is None:
            raise RuntimeError("no slot initialised")
        self.state, bboxes, scores = multi.update_objects_jit(
            self.params, self.state, frame, active, self.cfg,
            self.frame_format, exclusive=self.exclusive, device=self.device)
        out = torch.cat([bboxes, scores[:, None]], dim=1).cpu().numpy()
        return out[:, :4], out[:, 4]

    def update(self, frame) -> Tuple[np.ndarray, np.ndarray]:
        """(bboxes (N, 4), scores (N,)) — one batched step."""
        return self._step(frame, self.active)

    def update_slot(self, frame, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Advance ONLY slot ``k`` (one-hot active mask, the same step as
        :meth:`update`).  Used for init validation — a batched update there
        would advance every other slot a second time on the same frame
        (frame_idx and template-update schedule skew)."""
        mask = np.zeros(self.n, bool)
        mask[k] = True
        return self._step(frame, mask)

    def recover(self) -> None:
        multi.init_objects_jit.drop(self.params)
        multi.update_objects_jit.drop(self.params)
        self.params = tree_to(self._host_params, self.device, copy=True)
        self.state = None
        self.active[:] = False


class Slot:
    SELECTING = "selecting"
    TRACKING = "tracking"
    LOST = "lost"


class MultiObjectSession:
    """Session machine over N slots with per-slot Lost handling.

    Selection is sequential: the shared cursor arms slot after slot; the
    HUD names the slot being armed.  Cancel re-arms the slot currently
    being selected (or, when none is, the first tracked/lost slot — the
    cycle-and-replace gesture).  A slot whose Lost counter exceeds the
    reference bound returns to SELECTING and its backend slot deactivates.
    """

    def __init__(self, tracker: TorchMultiTrackerBackend, width: int,
                 height: int, cfg: SessionConfig = SessionConfig(),
                 log: Callable[[str], None] = lambda s: print(s + "\r")):
        self.tracker = tracker
        self.cfg = cfg
        self.frame_width = width
        self.frame_height = height
        self.n = tracker.n
        self.slots: List[str] = [Slot.SELECTING] * self.n
        self.lost_counts = [0] * self.n
        self.boxes: List[Optional[BBox]] = [None] * self.n
        self.scores = [0.0] * self.n
        self.selection = SelectionState.new(width, height, cfg)
        self.pending_confirm = False
        self.log = log

    # -- helpers -----------------------------------------------------------

    def _selecting_slot(self) -> Optional[int]:
        for k, s in enumerate(self.slots):
            if s == Slot.SELECTING:
                return k
        return None

    @property
    def current_score(self) -> float:
        tracked = [self.scores[k] for k, s in enumerate(self.slots)
                   if s == Slot.TRACKING]
        return float(min(tracked)) if tracked else 0.0

    @property
    def current_bbox(self) -> Optional[BBox]:
        for k, s in enumerate(self.slots):
            if s == Slot.TRACKING:
                return self.boxes[k]
        return None

    def tracked_boxes(self) -> List[Tuple[int, BBox, float]]:
        return [(k, self.boxes[k], self.scores[k])
                for k, s in enumerate(self.slots)
                if s == Slot.TRACKING and self.boxes[k] is not None]

    # -- command plane -----------------------------------------------------

    def handle_command(self, cmd: UserCommand) -> None:
        k = cmd.kind
        if k in (Kind.MOVE_UP, Kind.MOVE_DOWN, Kind.MOVE_LEFT,
                 Kind.MOVE_RIGHT):
            dx = (k == Kind.MOVE_RIGHT) - (k == Kind.MOVE_LEFT)
            dy = (k == Kind.MOVE_DOWN) - (k == Kind.MOVE_UP)
            self.selection.move_cursor(dx, dy, cmd.fast, self.frame_width,
                                       self.frame_height)
        elif k == Kind.CONFIRM:
            self.pending_confirm = True
        elif k == Kind.CANCEL:
            slot = self._selecting_slot()
            if slot is None:
                slot = 0
                self.slots[slot] = Slot.SELECTING
                self.tracker.deactivate(slot)
                self.boxes[slot] = None
            self.selection = SelectionState.new(self.frame_width,
                                                self.frame_height, self.cfg)
            self.log(f"Reset selection (object {slot + 1}/{self.n})")
        elif k == Kind.QUIT:
            pass

    # -- frame plane -------------------------------------------------------

    def process_frame(self, frame) -> Optional[BBox]:
        # After a backend recovery the device state is gone but the slot
        # statuses may still claim tracks — re-arm them for selection
        # instead of updating a stateless backend.
        if self.tracker.state is None and any(
                s != Slot.SELECTING for s in self.slots):
            self.log("Backend state lost - re-arming selection")
            self.slots = [Slot.SELECTING] * self.n
            self.boxes = [None] * self.n

        # 1. Advance every initialised slot in ONE batched step.
        if any(s != Slot.SELECTING for s in self.slots):
            bboxes, scores = self.tracker.update(frame)
            for k in range(self.n):
                if self.slots[k] == Slot.SELECTING:
                    continue
                score = float(scores[k])
                if score > self.cfg.score_threshold:
                    self.slots[k] = Slot.TRACKING
                    self.boxes[k] = tuple(float(v) for v in bboxes[k])
                    self.scores[k] = score
                    self.lost_counts[k] = 0
                elif self.slots[k] == Slot.TRACKING:
                    self.log(f"Track lost (object {k + 1}, "
                             f"score={score:.2f})")
                    self.slots[k] = Slot.LOST
                    self.lost_counts[k] = 0
                    self.scores[k] = 0.0
                else:                      # LOST countdown (rs:142-152)
                    if self.lost_counts[k] > self.cfg.lost_frames_max:
                        self.log(f"Auto-reset object {k + 1} to selection")
                        self.slots[k] = Slot.SELECTING
                        self.tracker.deactivate(k)
                        self.boxes[k] = None
                    else:
                        self.lost_counts[k] += 1

        # 2. Selection of the next un-armed slot.
        slot = self._selecting_slot()
        if slot is not None and self.pending_confirm:
            self.pending_confirm = False
            if self.selection.phase == SelectionPhase.MOVING_TO_START:
                self.selection.start_x = self.selection.cursor_x
                self.selection.start_y = self.selection.cursor_y
                self.selection.phase = SelectionPhase.SELECTING_AREA
                self.log(f"*** Object {slot + 1}: start point set at "
                         f"({self.selection.start_x}, "
                         f"{self.selection.start_y}) ***")
            else:
                bbox = self.selection.get_bbox(self.cfg.min_bbox)
                self.log(f"*** Initializing object {slot + 1} with bbox: "
                         f"x={bbox[0]}, y={bbox[1]}, w={bbox[2]}, "
                         f"h={bbox[3]} ***")
                try:
                    self.tracker.init_slot(frame, slot, bbox)
                    # Validate with a one-hot update: step 1 already
                    # advanced the other slots on this frame.
                    bboxes, scores = self.tracker.update_slot(frame, slot)
                    score = float(scores[slot])
                except Exception as e:     # backend fault path
                    self.log(f"Tracker error: {e!r}")
                    self._recover_backend()
                    self.selection = SelectionState.new(
                        self.frame_width, self.frame_height, self.cfg)
                    return self.current_bbox
                self.log(f"Init result: score={score:.3f}")
                if score > self.cfg.score_threshold:
                    self.slots[slot] = Slot.TRACKING
                    self.boxes[slot] = tuple(float(v) for v in bboxes[slot])
                    self.scores[slot] = score
                    self.log(f"*** TRACKING object {slot + 1}/{self.n} ***")
                else:
                    self.tracker.deactivate(slot)
                    self.log("Low score - please try selecting a "
                             "different area")
                self.selection = SelectionState.new(
                    self.frame_width, self.frame_height, self.cfg)
        else:
            self.pending_confirm = False
        return self.current_bbox

    def _recover_backend(self) -> None:
        recover = getattr(self.tracker, "recover", None)
        if recover is None:
            return
        try:
            recover()
            self.slots = [Slot.SELECTING] * self.n
            self.boxes = [None] * self.n
        except Exception as e:             # noqa: BLE001
            self.log(f"Backend recovery failed: {e!r}")

    def force_lost(self) -> None:
        for k in range(self.n):
            if self.slots[k] == Slot.TRACKING:
                self.slots[k] = Slot.LOST
                self.lost_counts[k] = 0
                self.scores[k] = 0.0

    # -- status ------------------------------------------------------------

    def state_name(self) -> str:
        # "N OF M" (not "N/M"): these strings render through the 41-glyph
        # HUD font, which has no '/' (ops/font.py mirrors the reference's
        # panic-on-unmapped-char contract, drawing.rs:99).
        slot = self._selecting_slot()
        n_trk = sum(s == Slot.TRACKING for s in self.slots)
        if slot is not None:
            phase = ("SELECT START"
                     if self.selection.phase == SelectionPhase.MOVING_TO_START
                     else "SELECT END")
            return f"{phase} {slot + 1} OF {self.n}"
        if n_trk:
            return f"TRACKING {n_trk} OF {self.n}"
        return "LOST"
