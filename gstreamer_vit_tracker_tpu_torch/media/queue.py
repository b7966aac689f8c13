"""Bounded drop-oldest frame queue — the reference's leaky GStreamer queue.

Reproduces ``queue max-size-buffers=3 leaky=downstream``
(reference pipeline_ir.rs:75-78): when the consumer (display)
falls behind, *old* frames are dropped so the producer (tracking) never
stalls.  A C++ lock-free ring (runtime/native) backs the hot path when
built; this pure-Python implementation is the portable fallback with
identical semantics and is what the tests pin down.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional


class FrameQueue:
    """Thread-safe bounded queue; ``push`` drops the oldest item when full
    (leaky=downstream) and never blocks."""

    def __init__(self, max_buffers: int = 3):
        self.max_buffers = max_buffers
        self._dq: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.dropped = 0
        self.pushed = 0

    def push(self, item: Any) -> bool:
        """Returns False if an old frame was dropped to make room."""
        with self._lock:
            self.pushed += 1
            dropped = False
            while len(self._dq) >= self.max_buffers:
                self._dq.popleft()
                self.dropped += 1
                dropped = True
            self._dq.append(item)
            self._not_empty.notify()
            return not dropped

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocking pop (None on timeout)."""
        with self._not_empty:
            if not self._dq and not self._not_empty.wait_for(
                    lambda: len(self._dq) > 0, timeout=timeout):
                return None
            return self._dq.popleft()

    def try_pop(self) -> Optional[Any]:
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)
