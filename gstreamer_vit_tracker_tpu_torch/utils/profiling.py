"""Profiling/tracing hooks.

The reference instruments every phase of its hot loop with Instant::now()
brackets and prints rolling aggregates.  The port's counterpart of the JAX
package's ``utils/profiling.py``: host-side phase timers (utils.timing and
:class:`PhaseTimer`) plus a ``torch.profiler`` trace of the host and the
card for kernel-level views.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Trace the host and, when a card is present, CUDA activity with
    ``torch.profiler``; writes a Chrome trace (``trace.json``, viewable in
    Perfetto or chrome://tracing) into ``logdir``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def call_ms(fn: Callable[[], object], device) -> float:
    """Milliseconds of one call of ``fn``: CUDA events around it on a card
    (the device's time from the first enqueue to the last kernel's end),
    the host clock on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def marginal_ms(run: Callable[[int], object], lo: int, hi: int,
                device) -> float:
    """Per-step ms of ``run(n)`` (n steps) as the slope between ``lo`` and
    ``hi`` steps after a warm-up of both: what a step adds, free of the
    run's set-up and its final read.

    On a card the slope is of device time (:func:`device_slope`), as JAX's
    scripts difference two rep counts of one device program: the host's
    launch time of an eager loop does not enter it.  On the CPU it is the
    host clock, each count the best of two."""
    import torch

    if torch.device(device).type == "cuda":
        return device_slope(run, lo, hi)[0]
    run(lo)
    run(hi)
    a = min(call_ms(lambda: run(lo), device) for _ in range(2))
    b = min(call_ms(lambda: run(hi), device) for _ in range(2))
    return (b - a) / (hi - lo)


def device_slope(run: Callable[[int], object], lo: int, hi: int):
    """(marginal device ms a step between ``lo`` and ``hi`` steps, device
    ms a step over ``lo`` steps, the set-up included) of ``run(n)`` on the
    card, from two :func:`device_ms` runs at each count after a warm-up of
    both, the larger of each pair kept: the tracer may drop a window's
    records of a replayed CUDA graph (one H100 run read 1.6 ms for five
    steps of 0.8), and it never adds any."""
    run(lo)
    run(hi)
    a = max(device_ms(lambda: run(lo), 1) for _ in range(2))
    b = max(device_ms(lambda: run(hi), 1) for _ in range(2))
    return (b - a) / (hi - lo), a / lo


def device_ms(fn: Callable[[], object], per: int) -> float:
    """Device milliseconds of one call of ``fn`` divided by ``per``: the
    CUDA kernels and copies ``torch.profiler`` records, summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / per


class PhaseTimer:
    """Accumulating host-side phase timer (the map/view/track/draw
    micro-breakdown of pipeline_ir.rs:126-208 as a reusable utility)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def avg_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return 1000.0 * self.totals.get(name, 0.0) / n if n else 0.0

    def summary(self) -> str:
        return " | ".join(f"{k}:{self.avg_ms(k):.2f}ms"
                          for k in sorted(self.totals))
