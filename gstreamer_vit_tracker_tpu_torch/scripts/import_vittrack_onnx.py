"""Convert a VitTrack ONNX checkpoint to the flat npz both packages load.

Port of ``scripts/import_vittrack_onnx.py``, with its flags, prints and exit
codes, over the port's ``models/import_onnx.py``.  The migration path for
users of the reference application, whose model is OpenCV Zoo's
``object_tracking_vittrack_2023sep`` ONNX artifact (main.rs:25).  Usage:

    python -m gstreamer_vit_tracker_tpu_torch.scripts.import_vittrack_onnx \
        --onnx object_tracking_vittrack_2023sep.onnx \
        --out weights_vittrack.npz [--preset small|vittrack-t]

If your export uses different tensor names, the strict-mode error lists
exactly which model parameters went unfilled and which checkpoint tensors
had no mapping; pass --no-strict to load the intersection.  The tensors are
placed on the card (``--cpu``: the CPU; without a card and without
``--cpu`` it exits 1 with a message) and saved from there.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import import_onnx, vittrack, weights


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--onnx", required=True, help="ONNX checkpoint path")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--preset", default="vittrack-t",
                    choices=["vittrack-t", "small"])
    ap.add_argument("--no-strict", action="store_true",
                    help="load whatever maps instead of failing on gaps")
    ap.add_argument("--cpu", action="store_true",
                    help="place the tensors on the CPU")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    if args.preset == "vittrack-t":
        cfg = ModelConfig()
    else:
        cfg = ModelConfig(template_size=64, search_size=128, patch_size=16,
                          embed_dim=96, depth=4, num_heads=2,
                          dtype="float32")
    like = vittrack.init_params(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    params = import_onnx.load_onnx(args.onnx, like,
                                   strict=not args.no_strict, device=dev)
    weights.save_npz(args.out, params)
    n = vittrack.count_params(params)
    print(f"imported {n:,} params -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
