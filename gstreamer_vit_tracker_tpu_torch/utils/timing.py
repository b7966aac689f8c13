"""Rolling performance telemetry.

Port of reference timing_stats.rs: three rolling 120-sample
windows (frame intervals, conversion time, track time);
``fps = 1e6 / mean_interval_us`` (rs:36-46), averages in ms (rs:48-60).
Extended with percentiles (the north star asks for p50 latency) while
keeping the reference's exact summary statistics.
"""

from __future__ import annotations

from collections import deque
from typing import Deque


class TimingStats:
    def __init__(self, window: int = 120):
        self.window = window
        self.intervals: Deque[float] = deque(maxlen=window)
        self.conv_times: Deque[float] = deque(maxlen=window)
        self.track_times: Deque[float] = deque(maxlen=window)

    def add_interval(self, us: float) -> None:
        self.intervals.append(us)

    def add_times(self, conv_us: float, track_us: float) -> None:
        self.conv_times.append(conv_us)
        self.track_times.append(track_us)

    def fps(self) -> float:
        if not self.intervals:
            return 0.0
        avg = sum(self.intervals) / len(self.intervals)
        return 1_000_000.0 / avg if avg > 0 else 0.0

    def avg_conv_ms(self) -> float:
        if not self.conv_times:
            return 0.0
        return sum(self.conv_times) / len(self.conv_times) / 1000.0

    def avg_track_ms(self) -> float:
        if not self.track_times:
            return 0.0
        return sum(self.track_times) / len(self.track_times) / 1000.0

    def p50_track_ms(self) -> float:
        if not self.track_times:
            return 0.0
        s = sorted(self.track_times)
        return s[len(s) // 2] / 1000.0

    def p99_track_ms(self) -> float:
        if not self.track_times:
            return 0.0
        s = sorted(self.track_times)
        return s[min(len(s) - 1, int(len(s) * 0.99))] / 1000.0
