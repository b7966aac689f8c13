"""Back-to-back A/B of the derived grouped head on the headline loop.

Port of ``scripts/ab_grouped_head.py``, with its flags and prints: the
tower head and the grouped head (``vittrack.with_grouped_head``) of the
shipped flagship run interleaved in one process on
``scan.update_scan_pool`` over a pool of 1080p NV12 frames, each as the
slope between ``--reps`` and 5 x ``--reps`` steps, the best of three
interleaved rounds.  On the card the slope is of device time (the kernels
and copies ``torch.profiler`` records), as JAX's is a slope inside one
scanned program; with ``--cpu`` it is of the host clock.

Usage:
    python -m gstreamer_vit_tracker_tpu_torch.scripts.ab_grouped_head \
        [--reps 100] [--cpu]

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU.
Without ``--cpu`` and without a card it exits 1 with a message.  Prints the
JAX script's lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import PRESETS
from ..device import resolve_device, true_float32
from ..models import vittrack, weights
from ..tracker import core, scan
from ..utils.profiling import call_ms, device_ms

# The A/B's configuration: the shipped flagship on 1080p NV12 frames.
PRESET = "vittrack-t"
FRAME_HW = (1080, 1920)
POOL = 16
BBOX0 = (900.0, 500.0, 120.0, 90.0)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
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
    params = weights.load_npz(weights.checkpoint_path(PRESET), cfg,
                              device=dev)
    grouped = vittrack.with_grouped_head(params)

    rng = np.random.default_rng(0)
    (h, w), pool = FRAME_HW, POOL
    ys = torch.as_tensor(rng.integers(0, 256, (pool, h, w), dtype=np.uint8),
                         device=dev)
    uvs = torch.as_tensor(rng.integers(0, 256, (pool, h // 2, w // 2, 2),
                                       dtype=np.uint8), device=dev)
    bbox0 = torch.tensor(BBOX0, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lo, hi = args.reps, args.reps * 5
    print(f"backend={dev.type} ({name}) reps={lo}/{hi}")

    def runner(p):
        def run(reps):
            st = core.init_jit(p, (ys[0], uvs[0]), bbox0, cfg,
                               frame_format="nv12", device=dev)
            _, sc = scan.update_scan_pool(p, st, (ys, uvs), reps, cfg,
                                          "nv12", device=dev)
            return float(sc.sum())
        return run

    def ms(run, n):
        if dev.type == "cuda":
            return device_ms(lambda: run(n), 1)
        return call_ms(lambda: run(n), dev)

    run_t, run_g = runner(params), runner(grouped)
    for f in (run_t, run_g):          # warm both heads at both counts
        f(lo), f(hi)
    # Interleaved sampling: tower / grouped alternate so a drift in the
    # card's clocks mid-measurement biases both equally.
    ts, gs = [], []
    for _ in range(3):
        ts.append((ms(run_t, lo), ms(run_t, hi)))
        gs.append((ms(run_g, lo), ms(run_g, hi)))
    t_ms = (min(b for _, b in ts) - min(a for a, _ in ts)) / (hi - lo)
    g_ms = (min(b for _, b in gs) - min(a for a, _ in gs)) / (hi - lo)

    def fps(step_ms):
        return 1000.0 / step_ms if step_ms > 0 else float("nan")

    print(f"tower head:   {t_ms:.4f} ms/step  ({fps(t_ms):.0f} fps)")
    print(f"grouped head: {g_ms:.4f} ms/step  ({fps(g_ms):.0f} fps)")
    print(f"delta: {t_ms - g_ms:+.4f} ms/step")
    print(json.dumps({
        "device": name, "preset": PRESET, "frame": f"nv12 {w}x{h}",
        "reps": [lo, hi], "tower_ms": t_ms, "grouped_ms": g_ms,
        "delta_ms": t_ms - g_ms,
        "timing": ("device-time slope (torch.profiler)"
                   if dev.type == "cuda" else "host clock"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
