"""A/B the one-kernel NV12 preprocess + patch embed (TPU kernel 5, ported
as ``csrc/fused_prep_embed.cu``) against the unfused chain
``preprocess_nv12`` -> ``embed_search``, in one process.

Port of ``scripts/ab_fused_prep.py``, with its flags and prints.  It
measures:

  1. the full headline step (the flagship on 1080p NV12,
     ``scan.update_scan_pool``): plain vs fused;
  2. the isolated prep+embed stage for the same two arms.

JAX's ``loop`` and ``transpose`` modes are two Pallas formulations of one
computation; the port has one kernel-5 design, so the A/B has two arms.
Each arm is one compiled program of its rep loop (the full step through
``scan.update_scan_pool``, the stage through ``tracker/scan.py::
scanned``), as JAX's are scanned programs, and each ms a step is a slope
between ``--reps`` and ``--reps-hi`` steps (``utils/profiling.py::
marginal_ms``): of device time on the card, as JAX's slope inside one
scanned program is; of the host clock with ``--cpu``.

Usage:
    python -m gstreamer_vit_tracker_tpu_torch.scripts.ab_fused_prep \
        [--reps 50] [--reps-hi 250] [--cpu]

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU
(kernel 5's plain twin in the fused arm).  Without ``--cpu`` and without a
card it exits 1 with a message.  Prints the JAX script's lines, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import PRESETS
from ..device import resolve_device, true_float32
from ..models import vit, vittrack, weights
from ..ops import fused_prep_embed as fpe
from ..ops import preprocess as pp
from ..tracker import core, scan
from ..utils.profiling import marginal_ms

# The A/B's configuration: the shipped flagship on 1080p NV12 frames.
PRESET = "vittrack-t"
FRAME_HW = (1080, 1920)
POOL = 16
BBOX0 = (900.0, 500.0, 120.0, 90.0)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
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
    (h, w), pool = FRAME_HW, POOL
    ys = torch.as_tensor(rng.integers(0, 256, (pool, h, w), dtype=np.uint8),
                         device=dev)
    uvs = torch.as_tensor(rng.integers(0, 256, (pool, h // 2, w // 2, 2),
                                       dtype=np.uint8), device=dev)
    bbox0 = torch.tensor(BBOX0, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} ({name}) reps={args.reps}/{reps_hi}")
    lo, hi = args.reps, reps_hi

    def fresh():
        return core.init_jit(params, (ys[0], uvs[0]), bbox0, cfg,
                             frame_format="nv12", device=dev)

    # ---- 1. full step ---------------------------------------------------
    def run_full(fused_prep):
        def run(reps):
            _, sc = scan.update_scan_pool(params, fresh(), (ys, uvs), reps,
                                          cfg, "nv12", fused_prep=fused_prep,
                                          device=dev)
            return float(sc.sum())
        return run

    res = {}
    for arm, fused in (("plain", False), ("fused", True)):
        res[f"full_{arm}_ms"] = t = marginal_ms(run_full(fused), lo, hi, dev)
        print(f"full step ms ({arm}): {t:.4f}")

    # ---- 2. isolated prep+embed stage -----------------------------------
    def plain_tokens(st, frame):
        win = pp.crop_window(st.bbox, cfg.search_factor)
        x_img = core._prep_nv12(frame, win, cfg.search_size, cfg)
        return vit.embed_search(params["backbone"], x_img[None], cfg)

    def fused_tokens(st, frame):
        win = pp.crop_window(st.bbox, cfg.search_factor)
        return fpe.nv12_search_tokens(params, *frame, win, cfg)

    def stage(tokens, arm):
        def step(st, i):
            frame = scan._pick((ys, uvs), torch.remainder(i, pool))
            return st, tokens(st, frame).float().mean()

        program = scan.scanned(step, f"ab_fused_prep.stage_{arm}")

        def run(reps):
            return float(program(fresh(), reps, dev)[1].sum())
        return run

    for arm, tokens in (("plain", plain_tokens), ("fused", fused_tokens)):
        res[f"stage_{arm}_ms"] = t = marginal_ms(stage(tokens, arm), lo, hi,
                                                 dev)
        print(f"prep+embed stage ms ({arm}): {t:.4f}")
    print(json.dumps({
        "device": name, "preset": PRESET, "frame": f"nv12 {w}x{h}",
        "reps": [lo, hi], **res,
        "timing": ("device-time slope (torch.profiler)"
                   if dev.type == "cuda" else "host clock"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
