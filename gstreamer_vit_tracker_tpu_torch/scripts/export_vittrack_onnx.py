"""Export a trained checkpoint as a cv2.TrackerVit-compatible ONNX graph.

Port of ``scripts/export_vittrack_onnx.py``, with its flags, prints and exit
codes, over the port's ``models/export_onnx.py`` (which writes the same
bytes as the JAX package's exporter):

    python -m gstreamer_vit_tracker_tpu_torch.scripts.export_vittrack_onnx \
        --checkpoint assets/weights_vittrack_t_synthetic.npz \
        --out vittrack_ours.onnx

The exported file has the OpenCV-Zoo VitTrack IO contract (two inputs
"template" / "search", outputs "output1/2/3" = conf/size/offset maps), so
OpenCV 5's cv2.TrackerVit loads and drives it directly:

    p = cv2.TrackerVit_Params(); p.net = "vittrack_ours.onnx"
    tracker = cv2.TrackerVit_create(p)

It is the reverse of ``scripts/import_vittrack_onnx.py``.  cv2's TrackerVit
crops are sized for the zoo model (template 128, search 256): presets with
other input sizes run under cv2.dnn but not under cv2.TrackerVit.  The
checkpoint is read onto the card (``--cpu``: the CPU; without a card and
without ``--cpu`` it exits 1 with a message); the graph is written on the
host.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config import ModelConfig
from ..device import resolve_device
from ..models import export_onnx, weights


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", default="vittrack_export.onnx")
    ap.add_argument("--target", default="standard",
                    choices=("standard", "cv2-5.0"),
                    help="'cv2-5.0' bakes in the inverse of OpenCV 5.0 "
                         "TrackerVit's measured blob quirk (sign-flipped "
                         "ch1/2, per-channel slopes ~1.46-1.49 — see "
                         "models/export_onnx.py::CV2_50_BLOB_SLOPE) so "
                         "cv2's own pipeline feeds the net the trained "
                         "distribution — use it for files driven by "
                         "cv2.TrackerVit")
    ap.add_argument("--skip-cv2-check", action="store_true",
                    help="skip the export-time self-check that measures "
                         "the INSTALLED cv2's blob convention with spy "
                         "graphs and aborts if it differs from the baked "
                         "compensation (runs only for --target cv2-5.0 "
                         "when cv2 is importable)")
    ap.add_argument("--cpu", action="store_true",
                    help="read the checkpoint onto the CPU")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return 1

    if args.target == "cv2-5.0" and not args.skip_cv2_check:
        try:
            import cv2  # noqa: F401
            have_cv2 = True
        except ImportError:
            have_cv2 = False
            print("cv2 not importable: skipping the blob-convention "
                  "self-check (the baked compensation was measured "
                  "against OpenCV 5.0.0)")
        if have_cv2:
            from ..compat import verify_cv2_convention

            got = verify_cv2_convention()   # raises on mismatch
            print(f"cv2 blob-convention self-check OK "
                  f"(slopes {[round(s, 5) for s in got['slope']]}, "
                  f"crossings {[round(c, 4) for c in got['crossing']]}, "
                  f"hann peak {got['hann_peak']:.6f})")

    cfg = ModelConfig(dtype="float32")
    params = weights.load_npz(args.checkpoint, cfg, device=dev)
    export_onnx.export_vittrack(params, cfg, args.out,
                                input_transform=args.target)
    print(f"exported {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"inputs template/search, outputs output1/2/3 = conf/size/offset)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
