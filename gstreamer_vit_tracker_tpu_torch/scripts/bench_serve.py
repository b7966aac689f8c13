"""Service-level throughput bench: N loopback clients against the port's
tracking service (``serve/``).

Port of ``scripts/bench_serve.py``, with its flags, defaults and JSON line.
It measures the end-to-end serving stack (wire protocol, per-connection
handler threads, the linger-window batcher and the batched step on the
card), not the raw device step: the number is bound by the host's frame
serialisation, JSON and socket copies as much as by the card.

Frames are made before the timed region (the synthetic source would
otherwise dominate it).

Usage:
    python -m gstreamer_vit_tracker_tpu_torch.scripts.bench_serve \
        [--streams 8] [--frames 120] [--cpu] [--model corr-tiny] \
        [--format nv12] [--width 320 --height 256]

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU.
Without ``--cpu`` and without a card it exits 1 with a message.  Prints ONE
JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

from ..config import PRESETS
from ..device import resolve_device, true_float32
from ..media.source import SyntheticSource
from ..models import vittrack, weights
from ..serve import SlotEngine, TrackClient, TrackServer


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--model", default="corr-tiny")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--format", default="nv12",
                    choices=["nv12", "yuy2", "rgb"])
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
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

    cfg = PRESETS[args.model]
    params = vittrack.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
    ckpt = args.checkpoint or weights.default_checkpoint(args.model)
    if ckpt:
        params = weights.load_npz(ckpt, cfg, device=dev)

    engine = SlotEngine(params, cfg, slots=args.streams,
                        frame_format=args.format, device=dev)
    server = TrackServer(engine, args.height, args.width, port=0,
                         batch_window_ms=args.batch_window_ms)
    server.start()
    try:
        print(f"pre-generating {args.streams}x{args.frames + 1} "
              f"{args.format} {args.width}x{args.height} frames...",
              file=sys.stderr)
        seqs = []
        for s in range(args.streams):
            src = SyntheticSource(args.width, args.height, obj_size=48,
                                  seed=10 + s, speed=2.0, fmt=args.format)
            seqs.append(([src.frame(i) for i in range(args.frames + 1)],
                         src.bbox_at(0)))

        # Warm the kernels' builds and the step outside the timed region.
        with TrackClient(server.host, server.port) as warm:
            warm.init(seqs[0][0][0], seqs[0][1])
            warm.update(seqs[0][0][1])
            warm.release()

        lat_ms = [[] for _ in range(args.streams)]
        errors = []

        def run(k):
            frames, bbox0 = seqs[k]
            try:
                with TrackClient(server.host, server.port) as c:
                    c.init(frames[0], bbox0)
                    for i in range(1, args.frames + 1):
                        t0 = time.perf_counter()
                        c.update(frames[i])
                        lat_ms[k].append(1000.0 * (time.perf_counter() - t0))
                    c.release()
            except Exception as e:   # reported below, after every join
                errors.append(f"client {k}: {e!r}")

        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(args.streams)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            print("\n".join(errors), file=sys.stderr)
            return 1

        with TrackClient(server.host, server.port) as c:
            stats = c.stats()
    finally:
        server.stop()

    total = args.streams * args.frames
    lat = np.concatenate([np.asarray(v) for v in lat_ms])
    out = {
        "metric": "served_stream_fps_aggregate",
        "value": round(total / wall, 1),
        "unit": "fps",
        "streams": args.streams,
        "frames_per_stream": args.frames,
        "format": f"{args.format} {args.width}x{args.height}",
        "model": args.model,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ticks": stats["ticks"],
        "mean_tick_batch": round(total / max(1, stats["ticks"] - 1), 2),
        "client_lat_p50_ms": round(float(np.percentile(lat, 50)), 2),
        "client_lat_p99_ms": round(float(np.percentile(lat, 99)), 2),
        "host_bound_note": "end-to-end service stack incl. socket+JSON on "
                           "the host's cores; the batched step alone is "
                           "profile_streams",
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
