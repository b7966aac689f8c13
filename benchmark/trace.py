"""The traced slice of a ``--trace 1`` run and its reduction.

After the measured window, the driver runs a fixed number of further steps
under ``torch.profiler`` (CUPTI on the card), marking its own calls into
the program with ``record_function`` spans (``upload``, ``call``,
``read``).  From the trace come every device operation (kernels, copies,
fills; those inside replayed CUDA graphs too) and those host spans, on one
clock.  The traced window runs from the first span's start to the later
of the last span's end and the last device operation's end.
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

SPANS = ("upload", "call", "read")
# Kineto's kinds of device activity that occupy the card.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class _NoMark:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOMARK = _NoMark()


def nomark(name: str) -> _NoMark:
    """The span context of an untraced step: nothing."""
    return _NOMARK


class Op(NamedTuple):
    name: str
    start: int   # ns
    end: int


class Trace(NamedTuple):
    ops: List[Op]              # device operations in the window, by start
    spans: List[Op]            # the driver's host spans
    window_s: float
    busy_s: float
    gaps: List[Tuple[str, float]]   # (host span during the gap, seconds)


def record(run: Callable[[Callable], None]) -> Trace:
    """Trace ``run(mark)``; ``mark(name)`` is the span context to wrap
    each call into the program in."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        run(record_function)
        if card:
            torch.cuda.synchronize()
    ops, spans, kinds = [], [], defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        op = Op(e.name(), start, start + int(e.duration_ns()))
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _kind(e)
            kinds[kind] += 1
            if kind in DEVICE_KINDS:
                ops.append(op)
        elif op.name in SPANS:
            spans.append(op)
    print(f"trace: device events by kind {dict(kinds)}, host spans "
          f"{len(spans)}", file=sys.stderr)
    return reduce(ops, spans)


def _kind(e) -> str:
    """Kineto's kind of a device event; where this torch does not say, the
    kind its name shows (CUDA events are kernels, copies and fills unless
    a synchronisation was traced)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if name in SPANS:
        return "gpu_user_annotation"   # a span's shadow on the device
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "cuda_sync" if "Sync" in name else "kernel"


def reduce(ops: List[Op], spans: List[Op]) -> Trace:
    spans = sorted(spans, key=lambda s: s.start)
    if not spans:
        return Trace([], [], 0.0, 0.0, [])
    lo = spans[0].start
    ops = sorted((o for o in ops if o.end > lo), key=lambda o: o.start)
    hi = max([spans[-1].end] + [o.end for o in ops])
    busy, gaps = 0, []
    cur_lo = cur_hi = lo
    for o in ops + [Op("", hi, hi)]:
        if o.start > cur_hi:
            busy += cur_hi - cur_lo
            gaps.append((cur_hi, o.start))
            cur_lo = o.start
        cur_hi = max(cur_hi, o.end)
    busy += cur_hi - cur_lo
    labelled = [(_during(spans, (a + b) // 2), (b - a) / 1e9)
                for a, b in gaps]
    return Trace(ops, spans, (hi - lo) / 1e9, busy / 1e9, labelled)


def _during(spans: List[Op], t: int) -> str:
    for s in spans:
        if s.start <= t < s.end:
            return s.name
    return "host between calls"


def short(name: str) -> str:
    """A kernel's name without ``void`` and its trailing argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i in range(len(name) - 1, 0, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i]
            break
    return name.strip()[:120]


def breakdown(tr: Trace) -> Dict[str, list]:
    """The ten device operations that took the most time (by name, summed)
    and the idle time by the host span it fell in, in seconds."""
    by_op: Dict[str, float] = defaultdict(float)
    for o in tr.ops:
        by_op[short(o.name)] += (o.end - o.start) / 1e9
    by_gap: Dict[str, float] = defaultdict(float)
    for label, sec in tr.gaps:
        by_gap[label] += sec
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def matching(tr: Trace, patterns) -> Tuple[float, int]:
    """Seconds and count of the device operations whose name matches one
    of ``patterns`` (regular expressions, searched)."""
    rx = re.compile("|".join(f"(?:{p})" for p in patterns))
    hit = [o for o in tr.ops if rx.search(o.name)]
    return sum(o.end - o.start for o in hit) / 1e9, len(hit)
