"""Profile the pooled serving loops on the card.

Port of ``scripts/profile_scan.py``, with its flags, defaults and prints.
It isolates:

  1. the single-stream headline step (full update vs preprocess-only vs
     preprocess + encode + heads): where the step budget goes;
  2. the 16-stream step: the pool pick of ``scan.update_streams_scan_pool``
     vs fixed frames vs a per-call loop timed on the host clock.

The JAX script differences two rep counts inside scanned programs, so its
slope is device time.  Here the marginal ms a step of each variant is the
slope of device time (the kernels and copies ``torch.profiler`` records,
``utils/profiling.py::marginal_ms``) between ``--reps`` and ``--reps-hi``
steps, and ``device_ms`` is the device's ms a step over ``--reps`` steps,
the run's set-up included (so a marginal lies at or a little below it).
The per-call ``python_loop`` line stays on the host clock; as in JAX it
calls the compiled ``multi.update_streams_jit`` (a CUDA graph replayed a
call), and the states come from ``core.init_jit`` /
``multi.init_streams_jit``.  JAX's other variants are scanned programs of
their own; here they stay eager loops, timed by device time.

Usage:
    python -m gstreamer_vit_tracker_tpu_torch.scripts.profile_scan \
        [--streams 16] [--reps 25] [--reps-hi 125] [--cpu]

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU
(host clock, no device time).  Without ``--cpu`` and without a card it
exits 1 with a message.  Prints the JAX script's lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import PRESETS
from ..device import resolve_device, true_float32
from ..models import vittrack, weights
from ..ops import preprocess as pp
from ..tracker import core, multi, scan
from ..utils.profiling import device_slope, marginal_ms

# The profiled configuration: the flagship on 1080p NV12 frames.
PRESET = "vittrack-t"
FRAME_HW = (1080, 1920)
POOL = 16
BBOX0 = (900.0, 500.0, 120.0, 90.0)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--reps-hi", type=int, default=0,
                    help="high rep count for differencing (default 5x reps)")
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    reps_hi = args.reps_hi or args.reps * 5
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    true_float32(dev)
    cfg = PRESETS[PRESET]
    params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path(PRESET), cfg, device=dev))

    rng = np.random.default_rng(0)
    (h, w), s, pool = FRAME_HW, args.streams, POOL
    ys = torch.as_tensor(rng.integers(0, 256, (pool, h, w), dtype=np.uint8),
                         device=dev)
    uvs = torch.as_tensor(rng.integers(0, 256, (pool, h // 2, w // 2, 2),
                                       dtype=np.uint8), device=dev)
    bbox0 = torch.tensor(BBOX0, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} ({name}) streams={s} "
          f"reps={args.reps}/{reps_hi}")
    lo, hi = args.reps, reps_hi
    device_of = {}

    def profiled(label, run):
        if dev.type != "cuda":
            return marginal_ms(run, lo, hi, dev)
        ms, device_of[label] = device_slope(run, lo, hi)
        return ms

    # ---- 1. headline step decomposition --------------------------------
    def pooled(step):
        """run(reps): ``reps`` steps over the pool from a fresh state, the
        per-step values read once at the end."""
        def run(reps):
            st = core.init_jit(params, (ys[0], uvs[0]), bbox0, cfg,
                               device=dev, frame_format="nv12")
            out = []
            for i in range(reps):
                st, v = step(st, (ys[i % pool], uvs[i % pool]))
                out.append(v)
            return float(torch.stack(out).sum())
        return run

    def full_step(st, frame):
        st, _bx, sc = core.update(params, st, frame, cfg, "nv12", dev)
        return st, sc

    def prep(st, frame):
        # Preprocess only: crop window from the carried bbox, banded NV12.
        win = pp.crop_window(st.bbox, cfg.search_factor)
        return core._prep_nv12(frame, win, cfg.search_size, cfg)

    def prep_step(st, frame):
        return st, prep(st, frame).float().mean()

    def encode_step(st, frame):
        # Preprocess + ViT encode + heads, no decode or state rebuild.
        maps = vittrack.forward(params, st.z_tok[None],
                                prep(st, frame)[None], cfg)
        return st, maps.score.float().mean()

    t_full = profiled("full", pooled(full_step))
    t_enc = profiled("prep_vit_heads", pooled(encode_step))
    t_prep = profiled("prep", pooled(prep_step))
    print(f"headline marginal ms/step: full={t_full:.4f} "
          f"prep+vit+heads={t_enc:.4f} prep={t_prep:.4f} "
          f"-> vit+heads={t_enc - t_prep:.4f} "
          f"decode+state={t_full - t_enc:.4f}")

    # ---- 2. multi-stream variants ---------------------------------------
    bbs = bbox0.reshape(1, 1, 4).repeat(s, 1, 1)
    active = torch.ones((s, 1), dtype=torch.bool, device=dev)
    first = (ys[:s], uvs[:s])

    def streams0():
        return multi.init_streams_jit(params, first, bbs, cfg, device=dev,
                                      frame_format="nv12")

    def run_scan_pool(reps):
        _, sc = scan.update_streams_scan_pool(params, streams0(), (ys, uvs),
                                              active, reps, cfg, "nv12", dev)
        return float(sc.sum())

    def run_scan_fixed(reps):
        st, out = streams0(), []
        for _ in range(reps):
            st, _bx, sc = multi.update_streams(params, st, first, active,
                                               cfg, "nv12", device=dev)
            out.append(sc)
        return float(torch.stack(out).sum())

    m_pool = profiled("scan_pool_gather", run_scan_pool)
    m_fixed = profiled("scan_fixed", run_scan_fixed)

    def run_loop(reps):
        st = streams0()
        st, _bx, sc = multi.update_streams_jit(params, st, first, active,
                                               cfg, "nv12", device=dev)
        float(sc.sum())
        t0 = time.perf_counter()
        for _ in range(reps):
            st, _bx, sc = multi.update_streams_jit(params, st, first, active,
                                                   cfg, "nv12", device=dev)
        float(sc.sum())
        return time.perf_counter() - t0

    run_loop(lo)
    loop = min(run_loop(lo) for _ in range(2)) / lo * 1000.0
    print(f"{s}-stream ms/step: scan_pool_gather={m_pool:.3f} "
          f"scan_fixed={m_fixed:.3f} (gather adds {m_pool - m_fixed:.3f}) "
          f"python_loop={loop:.3f} (incl. dispatch)")
    agg = s / m_pool * 1000.0
    print(f"{s}-stream aggregate (scan_pool): {agg:.0f} fps "
          f"({agg / s:.0f} per stream)")
    print(json.dumps({
        "device": name, "preset": PRESET, "frame": f"nv12 {w}x{h}",
        "streams": s, "reps": [lo, hi],
        "full_ms": t_full, "prep_vit_heads_ms": t_enc, "prep_ms": t_prep,
        "vit_heads_ms": t_enc - t_prep, "decode_state_ms": t_full - t_enc,
        "scan_pool_gather_ms": m_pool, "scan_fixed_ms": m_fixed,
        "python_loop_ms": loop, "aggregate_fps": agg,
        "per_stream_fps": agg / s,
        "device_ms": device_of if dev.type == "cuda" else None,
        "timing": ("device-time slope and device_ms from torch.profiler"
                   if dev.type == "cuda" else "host clock"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
