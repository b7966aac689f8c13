"""CLI entry point: ``python -m gstreamer_vit_tracker_tpu_torch.serve``.

Starts the multi-stream tracking service on one NVIDIA GPU (``--cpu`` runs
the plain PyTorch versions on the CPU instead):

    python -m gstreamer_vit_tracker_tpu_torch.serve --model vittrack-t \\
        --slots 16 --format nv12 --width 1920 --height 1080 --port 7301
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gstreamer_vit_tracker_tpu_torch.serve")
    ap.add_argument("--model", default="vittrack-t")
    ap.add_argument("--checkpoint", default="",
                    help="weights npz; default: the preset's shipped asset, "
                         "if it has one (corr-tiny runs on seeded weights)")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--format", default="nv12",
                    choices=["nv12", "yuy2", "rgb"])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (loopback by default; set explicitly "
                         "to expose the service)")
    ap.add_argument("--port", type=int, default=7301)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="enqueued-but-unread ticks allowed in flight "
                         "(>=2 overlaps each tick's result read with the "
                         "next tick's device step; 1 = fully synchronous)")
    ap.add_argument("--snapshot-every", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from ..config import PRESETS
    from ..device import resolve_device, true_float32
    from ..models import vittrack, weights
    from . import SlotEngine, TrackServer

    if args.model not in PRESETS:
        print(f"unknown model {args.model!r}", file=sys.stderr)
        return 2
    cfg = PRESETS[args.model]
    dev = resolve_device("cpu" if args.cpu else "cuda")
    true_float32(dev)
    params = vittrack.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
    ckpt = args.checkpoint or weights.default_checkpoint(args.model)
    if ckpt:
        params = weights.load_npz(ckpt, cfg, device=dev)
        print(f"loaded checkpoint {ckpt}")

    engine = SlotEngine(params, cfg, args.slots, args.format,
                        snapshot_every=args.snapshot_every, device=dev)
    server = TrackServer(engine, args.height, args.width, host=args.host,
                         port=args.port,
                         batch_window_ms=args.batch_window_ms,
                         pipeline_depth=args.pipeline_depth)
    print(f"tracking service: {server.host}:{server.port} "
          f"({args.slots} slots, {args.format} {args.width}x{args.height}, "
          f"model {args.model}, device {dev})", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
