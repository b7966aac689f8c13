"""Profile the 16-stream batched step (BASELINE config 4) on the card.

Port of ``scripts/profile_streams.py``, with its flags, defaults and prints:
where the per-stream cost goes (batched NV12 preprocess, ViT encode +
heads, the rest: decode and the state).  The JAX script differences two
rep counts inside scanned programs, so its slope is device time; here each
stage's ms a step is the slope of device time (``torch.profiler``,
``utils/profiling.py::marginal_ms``) between ``--reps`` and twice as many
steps, and ``device_ms`` is the device's ms a step over ``--reps`` steps.
The XLA cost analysis becomes the step's FLOP count from
``utils/flops.py``.

Usage:
    python -m gstreamer_vit_tracker_tpu_torch.scripts.profile_streams \
        [--streams 16] [--band 1152] [--reps 64] [--cpu]

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU
(host clock, no device time).  Without ``--cpu`` and without a card it
exits 1 with a message.  Prints the JAX script's lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..config import PRESETS
from ..device import resolve_device, true_float32
from ..models import vittrack
from ..ops import preprocess as pp
from ..tracker import core, multi
from ..utils import flops
from ..utils.profiling import device_slope, marginal_ms

# The profiled configuration: the flagship (seeded weights, as in JAX) on
# 1080p NV12 frames.
PRESET = "vittrack-t"
FRAME_HW = (1080, 1920)
BBOX0 = (900.0, 500.0, 120.0, 90.0)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--band", type=int, default=0,
                    help="override preprocess_band (0 = config default)")
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    true_float32(dev)
    cfg = PRESETS[PRESET]
    if args.band:
        cfg = dataclasses.replace(cfg, preprocess_band=args.band)
    params = vittrack.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=dev)

    s = args.streams
    h, w = FRAME_HW
    rng = np.random.default_rng(0)
    ys = torch.as_tensor(rng.integers(0, 256, (s, h, w), dtype=np.uint8),
                         device=dev)
    uvs = torch.as_tensor(rng.integers(0, 256, (s, h // 2, w // 2, 2),
                                       dtype=np.uint8), device=dev)
    bbs = torch.tensor(BBOX0, device=dev).reshape(1, 1, 4).repeat(s, 1, 1)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_of = {}

    def timed(label, step, key):
        """ms a step of ``step()`` (it returns a tensor to read), as the
        slope between --reps and 2 x --reps steps (device time on a
        card)."""
        def run(n):
            return float(torch.stack([step() for _ in range(n)]).sum())

        if dev.type == "cuda":
            ms, device_of[key] = device_slope(run, args.reps, 2 * args.reps)
        else:
            ms = marginal_ms(run, args.reps, 2 * args.reps, dev)
        print(f"{label:34s} {ms:8.3f} ms/step   "
              f"({ms / s * 1000:7.1f} us/stream)")
        return ms

    # Full batched step.
    st = multi.init_streams(params, (ys, uvs), bbs, cfg, device=dev,
                            frame_format="nv12")
    active = torch.ones((s, 1), dtype=torch.bool, device=dev)
    carry = [st]

    def full_step():
        carry[0], _bx, sc = multi.update_streams(params, carry[0], (ys, uvs),
                                                 active, cfg, "nv12",
                                                 device=dev)
        return sc.sum()

    total = timed("full 16-stream step", full_step, "full")

    # Preprocess only: the batched search-window crop of each stream's
    # frame, in the batched config (band off, tracker/multi.py::
    # _batched_cfg), the stage the full step above runs.
    bcfg = multi._batched_cfg(cfg)

    def prep_step():
        win = pp.crop_window(bbs[:, 0], bcfg.search_factor)
        x = core._prep_nv12((ys, uvs), win, bcfg.search_size, bcfg)
        return x.float().mean()

    prep = timed("preprocess (batched NV12 crop)", prep_step, "prep")

    # ViT forward only on ready crops (batch = s).
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x_img = torch.zeros((s, cfg.search_size, cfg.search_size, 3), dtype=dt,
                        device=dev)
    z_tok = st.z_tok.reshape((s,) + tuple(st.z_tok.shape[2:]))

    def vit_step():
        maps = vittrack.forward(params, z_tok, x_img, cfg)
        return maps.score.float().mean()

    vit = timed("ViT encode+heads (batch 16)", vit_step, "vit")

    print(f"\ntotal {total:.3f} = prep {prep:.3f} + vit {vit:.3f} "
          f"+ other {total - prep - vit:.3f} ms")
    step_flops = s * flops.update_gflops(bcfg, h, w, "nv12",
                                         grouped_head=False) * 1e9
    print(f"flops (utils/flops.py, one step) = {step_flops:.3e}")
    print(json.dumps({
        "device": name, "preset": PRESET, "frame": f"nv12 {w}x{h}",
        "streams": s, "reps": args.reps,
        "band": cfg.preprocess_band,
        "full_ms": total, "prep_ms": prep, "vit_ms": vit,
        "other_ms": total - prep - vit, "us_per_stream": total / s * 1000,
        "flops": step_flops,
        "device_ms": device_of if dev.type == "cuda" else None,
        "timing": ("device-time slope and device_ms from torch.profiler"
                   if dev.type == "cuda" else "host clock"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
