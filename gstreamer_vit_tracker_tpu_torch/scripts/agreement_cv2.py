"""Cross-implementation trajectory agreement against cv2.TrackerVit, with the
residual decomposed one pipeline stage at a time.

Port of ``scripts/agreement_cv2.py``, with its flags, prints and JSON line,
over the port's ``compat/`` and ``models/export_onnx.py``.  For each seed,
OpenCV 5's own TrackerVit tracks the exported graph; then a ladder of
trackers, from the bit-exact replica down to the production tracker,
tracks the same frames, and each rung's mean IoU against cv2's trajectory
attributes one stage of the residual:

  replica        Cv2VitReplica, cv2.dnn forward      -> 1.000 (bit-exact)
  matched        the port's forward, cv2-exact crop/decode/int-Rect
                 feedback (the residual is float32 arithmetic)
  float-window   + the production float crop and resample
  float-feedback + the float rect carried between frames
  production     the port's tracker/core.py step (plain route, compiled:
                 JAX's jitted ``use_pallas=False, fused=False`` update)

    python -m gstreamer_vit_tracker_tpu_torch.scripts.agreement_cv2 \
        --frames 400 --seeds 5 9 13

It needs cv2: without it, it exits 1 with a message and runs no rung.  The
port's rungs run on the card (``--cpu``: the CPU; without a card and without
``--cpu`` it exits 1 with a message).  Prints a per-rung table and one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..config import ModelConfig
from ..device import resolve_device, true_float32
from ..media.source import SyntheticSource
from ..models import export_onnx, weights
from ..tracker import core
from ..utils import graph


def iou(a, b):
    ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


@graph.compiled("agreement_cv2.update", static=("cfg",))
def update(params, state, frame, cfg, device):
    """The production rung's step compiled, the state not donated: JAX's
    ``jax.jit(lambda p, s, f: core.update(p, s, f, cfg, use_pallas=False,
    fused=False))``, the plain per-block route."""
    return core.update(params, state, frame, cfg, device=device,
                       use_kernel=False, fused=False)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 9, 13])
    ap.add_argument("--checkpoint",
                    default="assets/weights_vittrack_t_synthetic.npz")
    ap.add_argument("--onnx", default="",
                    help="reuse an exported cv2-5.0 graph (default: "
                         "export fresh into a temp dir)")
    ap.add_argument("--rungs", nargs="+",
                    default=["replica", "matched", "float-window",
                             "float-feedback", "production"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the port's rungs on the CPU")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        import cv2
    except ImportError:
        print("error: agreement_cv2 needs cv2 (OpenCV 5's TrackerVit), "
              "which is not importable here; no rung was run",
              file=sys.stderr)
        return 1
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    true_float32(dev)

    from ..compat import Cv2VitReplica, MatchedCropTracker

    cfg = ModelConfig(dtype="float32")
    params = weights.load_npz(args.checkpoint, cfg, device=dev)

    tmp = None
    onnx_path = args.onnx
    if not onnx_path:
        tmp = tempfile.TemporaryDirectory()
        onnx_path = os.path.join(tmp.name, "vittrack_cv2.onnx")
        export_onnx.export_vittrack(params, cfg, onnx_path,
                                    input_transform="cv2-5.0")

    def make_rung(name):
        if name == "replica":
            return Cv2VitReplica(onnx_path)
        if name == "matched":
            return MatchedCropTracker(params, cfg, device=dev)
        if name == "float-window":
            return MatchedCropTracker(params, cfg, window="float", device=dev)
        if name == "float-feedback":
            return MatchedCropTracker(params, cfg, window="float",
                                      feedback="float", device=dev)
        raise ValueError(name)

    results = {r: [] for r in args.rungs}
    n = args.frames
    for seed in args.seeds:
        src = SyntheticSource(640, 512, obj_size=48, seed=seed, speed=3.0)
        frames = [np.asarray(src.frame_rgb(i)) for i in range(n + 1)]
        bb0 = tuple(int(v) for v in src.bbox_at(0))

        t0 = time.time()
        p = cv2.TrackerVit_Params()
        p.net = onnx_path
        tr = cv2.TrackerVit_create(p)
        tr.init(frames[0], bb0)
        ref = [tr.update(f)[1] for f in frames[1:]]
        print(f"seed {seed}: cv2 reference done ({time.time() - t0:.0f}s)",
              flush=True)

        for name in args.rungs:
            t0 = time.time()
            if name == "production":
                st = core.init(params, frames[0], np.asarray(bb0, np.float32),
                               cfg, device=dev)
                ious = []
                for i in range(1, n + 1):
                    st, bb, _c = update(params, st, frames[i], cfg, dev)
                    ious.append(iou(bb.cpu().numpy(), ref[i - 1]))
            else:
                rung = make_rung(name)
                rung.init(frames[0], bb0)
                ious = [iou(rung.update(frames[i]), ref[i - 1])
                        for i in range(1, n + 1)]
            m = float(np.mean(ious))
            results[name].append({"seed": seed, "mean_iou": round(m, 4),
                                  "min_iou": round(float(np.min(ious)), 4)})
            print(f"  {name:15s} mean {m:.4f}  min {np.min(ious):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    print()
    agg = {}
    for name in args.rungs:
        rows = results[name]
        agg[name] = {
            "mean_iou": round(float(np.mean([r["mean_iou"] for r in rows])),
                              4),
            "min_iou": round(float(np.min([r["min_iou"] for r in rows])), 4),
        }
        print(f"{name:15s} mean {agg[name]['mean_iou']:.4f}  "
              f"min {agg[name]['min_iou']:.4f}")
    print(json.dumps({"frames": n, "seeds": args.seeds, "per_rung": agg,
                      "per_seed": results}))
    if tmp:
        tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
