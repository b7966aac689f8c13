"""Entry point: one flagship tracking update on a 1080p NV12 frame.

Counterpart of ``__graft_entry__.py::entry`` at the root of the repo.
``entry()`` returns ``(fn, args)``: ``fn(*args)`` runs one
``tracker.core.update`` of the flagship ``vittrack-t`` model (D=192,
depth 12, bf16, grouped conv head) with its shipped weights, on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import functools

import numpy as np

from .config import PRESETS
from .device import resolve_device
from .models import vittrack, weights
from .tracker import core

FRAME_H, FRAME_W = 1080, 1920
INIT_BBOX = (900.0, 500.0, 120.0, 90.0)


def entry(device="cuda"):
    """Returns (fn, example_args) for one NV12 1080p update step."""
    dev = resolve_device(device)
    cfg = PRESETS["vittrack-t"]
    params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("vittrack-t"), cfg, device=dev))
    rng = np.random.default_rng(0)
    y_plane = rng.integers(0, 256, (FRAME_H, FRAME_W), dtype=np.uint8)
    uv_plane = rng.integers(0, 256, (FRAME_H // 2, FRAME_W // 2, 2),
                            dtype=np.uint8)
    frame = core._frame_on((y_plane, uv_plane), "nv12", dev)
    state = core.init(params, frame, INIT_BBOX, cfg, frame_format="nv12",
                      device=dev)
    fn = functools.partial(core.update, cfg=cfg, frame_format="nv12",
                           device=dev)
    return fn, (params, state, frame)
