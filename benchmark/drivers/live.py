"""One camera, closed loop: the app's tracking step on every frame.

Set-up makes one clip on the device, keeps it in pinned host memory (the
frames a capture pipeline hands over), starts the track with
``core.init_jit`` on the clip's first frame at the target's box, and warms
the step.  Each step then copies the next frame (the clip forward, then
backward) to the card, enqueues ``core.update_packed_jit`` and reads its
five numbers back in one copy: the body of the app's
``TorchTrackerBackend.update`` (``pipelined=False``), on the serving head
it attaches (``vittrack.with_grouped_head``).  A frame's latency runs from
the start of its upload to its box on the host.

Mix parameters: ``clips`` (``benchmark/clips.py``), ``warm_steps``,
``check_steps`` (updates the correctness check samples from the window),
``trace_steps``.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from benchmark import check, clips
from benchmark.trace import nomark

FORMAT = "nv12"


class Driver:
    frames_per_step = 1

    def __init__(self, ctx):
        from gstreamer_vit_tracker_tpu_torch.models import vittrack
        from gstreamer_vit_tracker_tpu_torch.tracker import core

        self.core = core
        self.dev = ctx.device
        self.cfg = ctx.cfg
        self.band = ctx.cfg.preprocess_band
        self.threshold = ctx.cfg.window_freeze_threshold
        c = clips.make(ctx.traffic["clips"], 1, ctx.gen, self.dev)
        self.frames = c.y.shape[0]
        self.frame_wh = (c.y.shape[-1], c.y.shape[-2])
        self.y, self.uv = c.y[:, 0].cpu(), c.uv[:, 0].cpu()
        if self.dev.type == "cuda":
            self.y, self.uv = self.y.pin_memory(), self.uv.pin_memory()
        self.box0 = [float(v) for v in c.boxes[0, 0]]
        self.params = vittrack.with_grouped_head(ctx.params)
        self.state = core.init_jit(self.params, (c.y[0, 0], c.uv[0, 0]),
                                   self.box0, self.cfg, FORMAT, self.dev)
        del c
        self.k = 0
        self.rows: List[np.ndarray] = []
        self.lat: List[float] = []
        self.calls: List[float] = []
        for _ in range(int(ctx.traffic["warm_steps"])):
            self.step()

    def step(self, mark=None) -> None:
        mark = mark or nomark
        i = clips.pingpong(self.k + 1, self.frames)
        t0 = time.perf_counter()
        with mark("upload"):
            planes = (self.y[i].to(self.dev, non_blocking=True),
                      self.uv[i].to(self.dev, non_blocking=True))
        t1 = time.perf_counter()
        with mark("call"):
            self.state, packed = self.core.update_packed_jit(
                self.params, self.state, planes, self.cfg, FORMAT, self.dev)
        t2 = time.perf_counter()
        with mark("read"):
            row = packed.cpu().numpy()
        t3 = time.perf_counter()
        self.k += 1
        self.rows.append(row)
        self.lat.append(t3 - t0)
        self.calls.append(t2 - t1)

    # -- what the correctness check reads -------------------------------------

    def tracks(self) -> List[check.Track]:
        return [check.Track(self.y[0], self.uv[0], self.box0)]

    def served_template(self) -> torch.Tensor:
        return self.state.z_tok.detach().clone()[None]

    def steps(self, ks) -> List[check.Step]:
        rows = np.stack(self.rows)
        lost = check.lost_counts(rows[:, 4], self.threshold)
        out = []
        for k in ks:
            i = clips.pingpong(k + 1, self.frames)
            prev = self.box0 if k == 0 else rows[k - 1, :4].tolist()
            out.append(check.Step(0, self.y[i], self.uv[i], prev,
                                  int(lost[k]), rows[k].tolist()))
        return out

    def finite(self) -> bool:
        return bool(np.isfinite(np.stack(self.rows)).all())

    def release(self) -> None:
        """Drop the program's state and compiled graphs."""
        self.core.update_packed_jit.drop(self.params)
        self.core.init_jit.drop(self.params)
        self.state = None
        self.params = None

