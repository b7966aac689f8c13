"""Evaluate tracking quality: IoU vs ground truth on synthetic videos.

Port of ``scripts/eval_tracking.py``, with the same flags, defaults,
scenarios, prints and exit codes:

    python -m gstreamer_vit_tracker_tpu_torch.scripts.eval_tracking \
        --preset small --checkpoint w.npz
    python -m gstreamer_vit_tracker_tpu_torch.scripts.eval_tracking \
        --preset vittrack-t --world independent --scenario all

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU.
Without ``--cpu`` and without a card it exits 1 with a message.
``--tracker cv2`` and ``--tracker matched`` need OpenCV (``cv2``).

Scenarios:

  basic      — fixed-size target on a Lissajous path (training family)
  scale      — target size sweeps 0.5x -> 2x over the sequence (size head)
  occlusion  — an occluder sweeps over the target every 200 frames; checks
               confidence COLLAPSES while hidden (the Lost machine's 0.25
               threshold) and the track RE-ACQUIRES after
  distractor — two lookalike patches glide under the target (association)
  heldout    — out-of-family generator (HeldoutSource): generalisation
  all        — run every scenario, print a summary table

Reports per-sequence mean/min IoU and mean confidence.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..config import PRESETS
from ..device import resolve_device, true_float32
from ..media.source import HeldoutSource, SyntheticSource
from ..models import vittrack, weights
from ..tracker import core

__all__ = ["PRESETS", "SCENARIOS", "EvalReport", "build_argparser",
           "center_errors", "iou", "main", "make_source", "run",
           "run_sequence", "run_sequence_multi", "summarize"]

SCENARIOS = ("basic", "scale", "occlusion", "distractor", "shake",
             "drift", "morph", "rotation", "noise", "exit", "heldout")


def iou(a, b):
    ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def make_source(scenario: str, seq: int, args) -> object:
    """Scenario -> ground-truthed source.  '+'-composition stacks
    hardenings on one scene: ``occlusion+distractor``,
    ``scale+shake+occlusion``, ... (heldout is its own world and doesn't
    compose).

    ``--world independent`` swaps EVERY scenario onto the independent
    world (media/indie.py — no renderer code shared with the training
    families).  There 'heldout' degenerates to 'basic': the whole world is
    held out by construction."""
    obj = 40 + 8 * seq
    kw = dict(obj_size=obj, seed=seq, speed=args.speed)
    if getattr(args, "world", "family") == "independent":
        from ..media.indie import IndependentSource

        cls = IndependentSource
        if scenario == "heldout":
            return cls(args.width, args.height, **kw)
    else:
        cls = SyntheticSource
        if scenario == "heldout":
            return HeldoutSource(args.width, args.height, **kw)
    for part in scenario.split("+"):
        if part == "basic":
            pass
        elif part == "scale":
            kw.update(scale_range=(0.5, 2.0), scale_period=args.frames)
        elif part == "occlusion":
            kw.update(occlusion=(200, 41))
        elif part == "distractor":
            kw.update(n_distractors=2)
        elif part == "shake":
            # ±24 px/axis camera shake: violent shared inter-frame motion
            # stressing the search-window margin.
            kw.update(shake_px=24.0)
        elif part == "drift":
            # Appearance drift: the target fades to 25% brightness by
            # ~frame 375 — the regime the online template update
            # (--template-update) exists for.
            kw.update(appearance_drift=0.002)
        elif part == "morph":
            # Structural appearance drift: the target's texture linearly
            # cross-fades into a different construction family (full
            # replacement by frame 400).
            kw.update(morph_rate=0.0025)
        elif part == "rotation":
            # In-plane spin: 1.5 deg/frame = a full revolution every 240
            # frames.
            kw.update(rotation_dpf=1.5)
        elif part == "exit":
            # The target leaves through a frame edge and comes back: ~40
            # fully-off-frame frames per window (under the 60-frame
            # session auto-reset), one window per 300 frames.
            kw.update(exit_spec=(300, 100))
        elif part == "noise":
            # sigma-12 Gaussian sensor noise on every frame.
            kw.update(noise_sigma=12.0)
        else:
            raise SystemExit(f"unknown scenario part {part!r}")
    return cls(args.width, args.height, **kw)


def run_sequence_multi(params, cfg, src, frames: int, n_obj: int,
                       exclusive: bool = False, device="cuda"):
    """Track n_obj targets (primary + distractors, all ground-truthed) in
    one batched step (tracker/multi.py).  Returns per-object mean IoU,
    mean confidence, and the identity-agnostic coverage."""
    from ..tracker import multi

    dev = resolve_device(device)
    bbs = torch.tensor([src.object_bbox_at(k, 0) for k in range(n_obj)],
                       dtype=torch.float32)
    st = multi.init_objects_jit(params, src.frame_rgb(0), bbs, cfg,
                                device=dev)
    active = torch.ones((n_obj,), dtype=torch.bool)
    ious = np.zeros((frames, n_obj))
    confs = np.zeros((frames, n_obj))
    cover = np.zeros((frames, n_obj))
    for i in range(1, frames + 1):
        st, bboxes, scores = multi.update_objects_jit(
            params, st, src.frame_rgb(i), active, cfg, exclusive=exclusive,
            device=dev)
        b, s = bboxes.cpu().numpy(), scores.cpu().numpy()
        for k in range(n_obj):
            gt = np.asarray(src.object_bbox_at(k, i))
            ious[i - 1, k] = iou(b[k], gt)
            # Identity-agnostic coverage: is SOME slot on this object?
            # Separates a label swap (coverage stays high) from a slot
            # collapse (an object goes untracked).
            cover[i - 1, k] = max(iou(b[j], gt) for j in range(n_obj))
        confs[i - 1] = s
    return ious.mean(axis=0), confs.mean(axis=0), cover.mean()


def center_errors(pred, gt):
    """(raw px, gt-size-normalized) center distance — the OTB precision /
    TrackingNet norm-precision primitives."""
    pcx, pcy = pred[0] + pred[2] / 2.0, pred[1] + pred[3] / 2.0
    gcx, gcy = gt[0] + gt[2] / 2.0, gt[1] + gt[3] / 2.0
    dx, dy = pcx - gcx, pcy - gcy
    raw = float(np.hypot(dx, dy))
    norm = float(np.hypot(dx / max(gt[2], 1e-6), dy / max(gt[3], 1e-6)))
    return raw, norm


def run_sequence(upd, params, cfg, src, frames: int, device="cuda"):
    """Track one sequence with ``upd(params, state, frame) -> (state,
    bbox, conf)``.  Returns per-frame (iou, conf, visible_frac,
    center_err_px, center_err_norm)."""
    st = core.init(params, src.frame_rgb(0), src.bbox_at(0), cfg,
                   device=device)
    rows = []
    for i in range(1, frames + 1):
        st, bbox, conf = upd(params, st, src.frame_rgb(i))
        vis = (src.visible_frac_at(i)
               if hasattr(src, "visible_frac_at") else 1.0)
        b, gt = bbox.cpu().numpy(), np.asarray(src.bbox_at(i))
        rows.append((iou(b, gt), float(conf), vis) + center_errors(b, gt))
    return np.asarray(rows)


def run_sequence_cv2(onnx_path: str, src, frames: int):
    """Reference-implementation baseline: OpenCV's own TrackerVit tracking
    our exported model (models/export_onnx.py) over the same scenario.
    Stock VitTrack semantics — no window freeze, no re-detection ramp — so
    the delta vs our tracker on the occlusion scenario is exactly the
    value of the recovery machinery."""
    import cv2

    p = cv2.TrackerVit_Params()
    p.net = onnx_path
    tracker = cv2.TrackerVit_create(p)
    tracker.init(np.asarray(src.frame_rgb(0)),
                 tuple(int(v) for v in src.bbox_at(0)))
    rows = []
    for i in range(1, frames + 1):
        _ok, box = tracker.update(np.asarray(src.frame_rgb(i)))
        vis = (src.visible_frac_at(i)
               if hasattr(src, "visible_frac_at") else 1.0)
        b = np.asarray(box, np.float64)
        gt = np.asarray(src.bbox_at(i))
        rows.append((iou(b, gt), float(tracker.getTrackingScore()), vis)
                    + center_errors(b, gt))
    return np.asarray(rows)


def run_sequence_matched(params, cfg, src, frames: int, device="cuda"):
    """The reference-parity mode (--tracker matched): the port's forward
    under cv2.TrackerVit's measured crop / interior-hann decode /
    integer-Rect feedback pipeline (compat/cv2vit.py)."""
    from ..compat import MatchedCropTracker

    tr = MatchedCropTracker(params, cfg, device=device)
    tr.init(np.asarray(src.frame_rgb(0)),
            tuple(int(v) for v in src.bbox_at(0)))
    rows = []
    for i in range(1, frames + 1):
        box = tr.update(np.asarray(src.frame_rgb(i)))
        vis = (src.visible_frac_at(i)
               if hasattr(src, "visible_frac_at") else 1.0)
        b = np.asarray(box, np.float64)
        gt = np.asarray(src.bbox_at(i))
        rows.append((iou(b, gt), float(tr.score), vis) + center_errors(b, gt))
    return np.asarray(rows)


def summarize(scenario: str, rows: np.ndarray, thr: float) -> dict:
    """Scenario-aware metrics from (N, 3) [iou, conf, visible] rows."""
    visible = rows[:, 2] >= 0.7
    # "hidden" = genuinely invisible: the trained model legitimately keeps
    # tracking (with high IoU) through partial occlusion up to ~70%, so
    # confidence there SHOULD stay high.
    hidden = rows[:, 2] < 0.05
    out = {
        "mean_iou": float(rows[visible, 0].mean()),
        "min_iou": float(rows[visible, 0].min()),
        "mean_conf": float(rows[visible, 1].mean()),
        "lost_frames": int((rows[visible, 1] <= thr).sum()),
    }
    if rows.shape[1] >= 5:
        # Standard tracking-benchmark metrics alongside IoU (whose success
        # AUC it already equals): OTB precision = frac(center err <= 20 px);
        # TrackingNet normalized precision at 0.2 of the gt box size.
        out["precision_20px"] = float((rows[visible, 3] <= 20.0).mean())
        out["norm_precision_02"] = float((rows[visible, 4] <= 0.2).mean())
    if hidden.any():
        # While the target is hidden the tracker must NOT stay confident
        # (silent drift); the session machine keys Lost off conf <= 0.25.
        out["hidden_conf_max"] = float(rows[hidden, 1].max())
        out["hidden_below_thr_frac"] = float((rows[hidden, 1] <= thr).mean())
        # Re-acquisition: mean IoU over the 20 frames after each occlusion
        # window ends (target fully visible again).
        post = []
        n = len(rows)
        for i in range(1, n):
            if rows[i - 1, 2] < 1.0 and rows[i, 2] == 1.0:
                post.extend(rows[i + 5:i + 30, 0])   # skip 5 settle frames
        if post:
            out["reacquire_iou"] = float(np.mean(post))
    return out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="corr-tiny", choices=sorted(PRESETS))
    ap.add_argument("--checkpoint", default="",
                    help="weights npz; default: the preset's shipped asset "
                         "(assets/weights_*.npz) when one exists — pass "
                         "--random-init for untrained weights")
    ap.add_argument("--random-init", action="store_true",
                    help="evaluate seeded random weights (useful only as a "
                         "sanity floor)")
    ap.add_argument("--scenario", default="basic",
                    help=f"one of {SCENARIOS + ('all',)}, or a "
                         "'+'-composition like occlusion+distractor")
    ap.add_argument("--world", default="family",
                    choices=("family", "independent"),
                    help="family: the training-sibling worlds (default); "
                         "independent: media/indie.py — zero renderer "
                         "code shared with any training family, the "
                         "renderer-overfitting bound")
    ap.add_argument("--seqs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--speed", type=float, default=3.0)
    ap.add_argument("--template-update", action="store_true",
                    help="enable the online template update "
                         "(config.template_update_*): confident-frame "
                         "re-embeds blended with the init template — "
                         "measure it against the drift scenario")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--objects", type=int, default=1, metavar="N",
                    help="track N ground-truthed objects per frame (primary "
                         "+ N-1 lookalike distractors) through the batched "
                         "multi-object step; reports per-object IoU")
    ap.add_argument("--exclusive", action="store_true",
                    help="with --objects: cross-slot duplicate suppression "
                         "(tracker/multi.py) — slots refuse to collapse "
                         "onto one target after a lookalike crossing")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the port's plain versions)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="also write the per-scenario summary metrics as "
                         "one JSON object (machine-readable twin of the "
                         "printed table)")
    ap.add_argument("--tracker", choices=("ours", "cv2", "matched"),
                    default="ours",
                    help="'cv2' runs OpenCV's TrackerVit on the checkpoint "
                         "exported via models/export_onnx.py — the "
                         "reference-implementation baseline (flagship "
                         "preset only: cv2 crops at fixed 128/256); "
                         "'matched' runs the port's forward under "
                         "cv2.TrackerVit's measured crop/decode/int-Rect "
                         "pipeline (compat/cv2vit.py MatchedCropTracker, "
                         "f32). Both need cv2")
    return ap


@dataclasses.dataclass
class EvalReport:
    """What a run ends with: its exit code, the summary (the ``--json``
    object), the updates the tracking loops made, and the host seconds
    those loops took (making the frames included)."""

    rc: int
    summary: dict = dataclasses.field(default_factory=dict)
    updates: int = 0
    loop_seconds: float = 0.0

    @property
    def updates_per_s(self) -> float:
        return self.updates / max(self.loop_seconds, 1e-9)


def main(argv=None) -> int:
    return run(argv).rc


def run(argv=None) -> EvalReport:
    """The script: parse ``argv``, evaluate, and report."""
    args = build_argparser().parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return EvalReport(rc=1)
    true_float32(dev)

    if args.tracker != "ours" and args.objects > 1:
        # Must precede the multi-object branch: it returns early and would
        # otherwise silently report OUR numbers as the cv2 baseline.
        print(f"--tracker {args.tracker} is single-object only "
              "(cv2.TrackerVit's pipeline has no batched mode); drop "
              "--objects", file=sys.stderr)
        return EvalReport(rc=2)

    cfg = PRESETS[args.preset]
    if args.template_update:
        cfg = dataclasses.replace(cfg, template_update_enabled=True)
    params = vittrack.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
    if not args.checkpoint and not args.random_init:
        # Default to the preset's shipped asset: evaluating silently-random
        # weights is a footgun (IoU ~0.01 that looks like a regression).
        # corr-tiny is training-free by design and stays seeded.
        args.checkpoint = weights.default_checkpoint(args.preset)
    if args.checkpoint:
        params = weights.load_npz(args.checkpoint, cfg, device=dev)
        print(f"loaded {args.checkpoint}")
    elif args.preset != "corr-tiny":
        print("WARNING: evaluating seeded random weights "
              "(--random-init)", file=sys.stderr)
    report = EvalReport(rc=0)

    if args.objects > 1:
        # Multi-object mode: every rendered patch (primary + lookalike
        # distractors) is a ground-truthed target for the batched step.
        n = args.objects
        scen = args.scenario if args.scenario != "all" else "basic"
        extra = {}
        if scen == "scale":
            extra = dict(scale_range=(0.5, 2.0), scale_period=args.frames)
        elif scen == "occlusion":
            extra = dict(occlusion=(200, 41))
        elif scen == "heldout":
            print("--objects does not compose with the heldout world "
                  "(HeldoutSource has no distractors)", file=sys.stderr)
            return EvalReport(rc=2)
        print(f"--- multi-object: {n} targets/frame (batched step), "
              f"scenario {scen}")
        per_obj, covers = [], []
        for seq in range(args.seqs):
            src = SyntheticSource(args.width, args.height,
                                  obj_size=40 + 8 * seq, seed=seq,
                                  speed=args.speed, n_distractors=n - 1,
                                  **extra)
            t = time.perf_counter()
            mi, mc, cov = run_sequence_multi(params, cfg, src, args.frames,
                                             n, exclusive=args.exclusive,
                                             device=dev)
            report.loop_seconds += time.perf_counter() - t
            report.updates += args.frames
            per_obj.append(mi)
            covers.append(cov)
            objs = " ".join(f"{v:.3f}" for v in mi)
            print(f"seq {seq}: per-object mean IoU [{objs}] "
                  f"conf [{' '.join(f'{v:.2f}' for v in mc)}] "
                  f"coverage {cov:.3f}")
        all_iou = np.asarray(per_obj)
        print(f"multi-object overall mean IoU {all_iou.mean():.3f} "
              f"(min object {all_iou.min():.3f}), "
              f"coverage {np.mean(covers):.3f}")
        report.summary = {
            "mode": "multi-object", "objects": n, "scenario": scen,
            "mean_iou": float(all_iou.mean()),
            "min_object_iou": float(all_iou.min()),
            "coverage": float(np.mean(covers))}
        if args.json:
            _dump_json(args.json, report.summary)
        return report

    if args.tracker in ("cv2", "matched") and \
            (cfg.template_size, cfg.search_size, cfg.head_mode) != \
            (128, 256, "conv"):
        print(f"--tracker {args.tracker} requires the flagship preset: "
              "cv2.TrackerVit's pipeline crops at fixed 128/256 and needs "
              "the conv head (use --preset vittrack-t)", file=sys.stderr)
        return EvalReport(rc=2)

    if args.tracker in ("cv2", "matched"):
        # Fail with the fix, not a bare ImportError mid-eval: cv2 is
        # optional, and only these two modes need it.
        try:
            import cv2  # noqa: F401
        except ImportError:
            print(f"--tracker {args.tracker} needs OpenCV (cv2 is not "
                  "importable here). Use --tracker ours.", file=sys.stderr)
            return EvalReport(rc=2)

    if args.tracker == "matched":
        # Matched-crop mode is an f32 parity tool (compat/cv2vit.py).
        cfg = dataclasses.replace(cfg, dtype="float32")

    if args.tracker == "cv2":
        import atexit
        import tempfile

        from ..models import export_onnx
        fd, onnx_path = tempfile.mkstemp(suffix=".onnx", prefix="gvt_eval_")
        os.close(fd)
        atexit.register(lambda: os.path.exists(onnx_path)
                        and os.unlink(onnx_path))
        export_onnx.export_vittrack(params, cfg, onnx_path,
                                    input_transform="cv2-5.0")
        print(f"cv2.TrackerVit baseline on exported {onnx_path}")

    def upd(p, s, f):
        return core.update(p, s, f, cfg, device=dev)

    scenarios = SCENARIOS if args.scenario == "all" else (args.scenario,)
    summary = {}
    for scenario in scenarios:
        print(f"--- scenario: {scenario}")
        all_rows = []
        for seq in range(args.seqs):
            src = make_source(scenario, seq, args)
            t = time.perf_counter()
            if args.tracker == "cv2":
                rows = run_sequence_cv2(onnx_path, src, args.frames)
            elif args.tracker == "matched":
                rows = run_sequence_matched(params, cfg, src, args.frames,
                                            device=dev)
            else:
                rows = run_sequence(upd, params, cfg, src, args.frames,
                                    device=dev)
            report.loop_seconds += time.perf_counter() - t
            report.updates += args.frames
            all_rows.append(rows)
            s = summarize(scenario, rows, 0.25)
            extra = "".join(
                f" {k} {v:.3f}" for k, v in s.items()
                if k in ("hidden_conf_max", "reacquire_iou"))
            print(f"seq {seq} (obj {40 + 8 * seq}px): "
                  f"mean IoU {s['mean_iou']:.3f} min {s['min_iou']:.3f} "
                  f"conf {s['mean_conf']:.2f} lost {s['lost_frames']}"
                  + extra)
        s = summarize(scenario, np.concatenate(all_rows), 0.25)
        summary[scenario] = s
        print(f"{scenario}: overall mean IoU {s['mean_iou']:.3f}"
              + (f", precision@20px {s['precision_20px']:.3f}"
                 if "precision_20px" in s else "")
              + (f", hidden conf max {s['hidden_conf_max']:.3f}"
                 if "hidden_conf_max" in s else ""))
    if len(scenarios) > 1:
        print("\nscenario        mean_iou  min_iou  lost  prec@20  nprec@0.2")
        for k, s in summary.items():
            p20 = s.get("precision_20px")
            np02 = s.get("norm_precision_02")
            print(f"{k:15s} {s['mean_iou']:8.3f} {s['min_iou']:8.3f} "
                  f"{s['lost_frames']:5d}"
                  + (f" {p20:8.3f}" if p20 is not None else "        -")
                  + (f" {np02:10.3f}" if np02 is not None else "          -"))
    report.summary = {
        "mode": args.tracker, "preset": args.preset,
        "seqs": args.seqs, "frames": args.frames,
        "scenarios": summary}
    if args.json:
        _dump_json(args.json, report.summary)
    return report


def _dump_json(path: str, obj) -> None:
    import json

    def _py(v):
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        raise TypeError(f"not JSON-serializable: {type(v)}")

    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=_py)
        f.write("\n")
    print(f"summary written to {path}")


if __name__ == "__main__":
    sys.exit(main())
