"""Interactive bbox selection geometry.

Port of reference selection_state.rs: cursor starts at frame
centre, moves in steps of 10 (50 fast) clamped to the frame, two-phase
corner selection, and a min-corner bbox with a 20px minimum edge.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

from ..config import SessionConfig


class SelectionPhase(enum.Enum):
    MOVING_TO_START = "moving_to_start"
    SELECTING_AREA = "selecting_area"


@dataclasses.dataclass
class SelectionState:
    cursor_x: int
    cursor_y: int
    start_x: int
    start_y: int
    phase: SelectionPhase
    step: int
    fast_step: int

    @staticmethod
    def new(width: int, height: int,
            cfg: SessionConfig = SessionConfig()) -> "SelectionState":
        # selection_state.rs:21-31 — cursor and start at frame centre.
        return SelectionState(
            cursor_x=width // 2, cursor_y=height // 2,
            start_x=width // 2, start_y=height // 2,
            phase=SelectionPhase.MOVING_TO_START,
            step=cfg.cursor_step, fast_step=cfg.cursor_fast_step,
        )

    def move_cursor(self, dx: int, dy: int, fast: bool,
                    width: int, height: int) -> None:
        # selection_state.rs:33-37 — clamp to [0, dim-1].
        step = self.fast_step if fast else self.step
        self.cursor_x = max(0, min(self.cursor_x + dx * step, width - 1))
        self.cursor_y = max(0, min(self.cursor_y + dy * step, height - 1))

    def get_bbox(self, min_edge: int = 20) -> Tuple[int, int, int, int]:
        # selection_state.rs:39-45 — min-corner rect, >= 20x20.
        x = min(self.start_x, self.cursor_x)
        y = min(self.start_y, self.cursor_y)
        w = max(abs(self.start_x - self.cursor_x), min_edge)
        h = max(abs(self.start_y - self.cursor_y), min_edge)
        return (x, y, w, h)
