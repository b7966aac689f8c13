"""S streams, closed loop: the tracking service's batched tick.

Set-up makes one clip a stream on the device and keeps the clips there,
builds the service's ``SlotEngine`` with S slots, starts a track in every
slot with ``init_slot`` on its clip's first frame at its target's box, and
warms the tick.  Each step is one tick with every slot live:
``SlotEngine.step_async`` on the streams' next frames (each clip forward,
then backward), then the read that ``SlotEngine.step`` makes of the packed
(S, 5) rows.  Every caller waits for its box, so the S frames of a tick
share its latency: from the tick's call to its rows on the host.

Mix parameters: ``streams``, ``snapshot_every`` (the engine's host
snapshot period, the server's default), ``clips`` (``benchmark/
clips.py``), ``warm_steps``, ``check_steps`` (ticks the correctness check
samples from the window, every slot of each), ``trace_steps``.
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

    def __init__(self, ctx):
        from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine

        tr = ctx.traffic
        self.dev = ctx.device
        self.band = None          # the batched step runs without the band
        self.threshold = ctx.cfg.window_freeze_threshold
        self.slots = int(tr["streams"])
        self.frames_per_step = self.slots
        c = clips.make(tr["clips"], self.slots, ctx.gen, self.dev)
        self.y, self.uv = c.y, c.uv
        self.frames = c.y.shape[0]
        self.frame_wh = (c.y.shape[-1], c.y.shape[-2])
        self.box0 = c.boxes[0].tolist()
        self.eng = SlotEngine(ctx.params, ctx.cfg, slots=self.slots,
                              frame_format=FORMAT,
                              snapshot_every=int(tr["snapshot_every"]),
                              device=self.dev)
        for s in range(self.slots):
            self.eng.init_slot(self.eng.alloc(), (c.y[0, s], c.uv[0, s]),
                               self.box0[s])
        self.active = np.ones(self.slots, bool)
        self.k = 0
        self.rows: List[np.ndarray] = []
        self.lat: List[float] = []
        self.calls: List[float] = []
        for _ in range(int(tr["warm_steps"])):
            self.step()

    def step(self, mark=None) -> None:
        mark = mark or nomark
        i = clips.pingpong(self.k + 1, self.frames)
        t0 = time.perf_counter()
        with mark("call"):
            tick = self.eng.step_async((self.y[i], self.uv[i]), self.active)
        t1 = time.perf_counter()
        with mark("read"):
            rows = np.asarray(tick)
        t2 = time.perf_counter()
        self.k += 1
        self.rows.append(rows.copy())
        self.lat.append(t2 - t0)
        self.calls.append(t1 - t0)

    # -- what the correctness check reads -------------------------------------

    def tracks(self) -> List[check.Track]:
        return [check.Track(self.y[0, s], self.uv[0, s], self.box0[s])
                for s in range(self.slots)]

    def served_template(self) -> torch.Tensor:
        return self.eng.state.z_tok[:, 0].detach().clone()

    def steps(self, ks) -> List[check.Step]:
        rows = np.stack(self.rows)                     # (K, S, 5)
        out = []
        for s in range(self.slots):
            lost = check.lost_counts(rows[:, s, 4], self.threshold)
            for k in ks:
                i = clips.pingpong(k + 1, self.frames)
                prev = self.box0[s] if k == 0 else rows[k - 1, s, :4].tolist()
                out.append(check.Step(s, self.y[i, s], self.uv[i, s], prev,
                                      int(lost[k]), rows[k, s].tolist()))
        return out

    def finite(self) -> bool:
        return bool(np.isfinite(np.stack(self.rows)).all())

    def release(self) -> None:
        """Drop the engine: its state, its params and its graphs."""
        self.eng = None
