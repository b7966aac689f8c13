"""Interactive CLI entry point of the PyTorch/CUDA port.

Port of ``gstreamer_vit_tracker_tpu/app/main.py`` (the reference
application, main.rs + the pad-probe hot loop in pipeline_ir.rs:100-228),
with the same flags, defaults, prints and exit codes, so the
``--record-track`` lines of the two apps compare row by row:

* startup banner and source validation (main.rs:28-40);
* keyboard thread with raw TTY + mpsc-style command queue (main.rs:48,54);
* per-frame loop: interval stats -> drain commands -> track -> overlay HUD
  on the device -> sink, with a console print every 60 frames
  (pipeline_ir.rs:103-220);
* 'Q' quits, state set to Null -> here: loop exit + sink close
  (main.rs:58-68).

Model presets:
  corr-tiny   training-free correlation tracker (works with zero weights);
  small       4-layer conv-head model (auto-loads the shipped synthetic-
              trained checkpoint from assets/);
  vittrack-t  flagship deit-tiny ViT + conv head (auto-loads its shipped
              checkpoint; override with --checkpoint).

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU
instead.  Without ``--cpu`` and without a card it exits non-zero.

Run headless: python -m gstreamer_vit_tracker_tpu_torch.app.main \
    --headless --frames 120 --source synthetic
"""

from __future__ import annotations

import argparse
import dataclasses
import queue as pyqueue
import sys
import threading
import time

import torch

from ..config import PRESETS, AppConfig
from ..media.sink import FileSink, MJPEGSink, MultiSink, NullSink, host_pixels
from ..media.source import (FileSource, FlakySource, SyntheticSource,
                            V4L2Source)
from ..ops import overlay
from ..session.machine import TorchTrackerBackend, TrackerSession
from ..utils.profiling import PhaseTimer
from ..utils.timing import TimingStats
from . import keyboard

__all__ = ["PRESETS", "RunReport", "build_argparser", "main", "run"]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gstreamer_vit_tracker_tpu_torch",
                                 description="ViT tracker on one NVIDIA GPU "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--source", default="synthetic",
                    choices=["synthetic", "file", "v4l2", "mjpeg"])
    ap.add_argument("--gst", default="", metavar="DESC",
                    help="gst-launch-1.0 pipeline description; element "
                         "chain is mapped onto this framework's components "
                         "and overrides --source/--format/geometry flags "
                         "(media/gst.py; the reference's own pipeline line "
                         "from pipeline_ir.rs:21-87 parses as-is)")
    ap.add_argument("--input", default="",
                    help="file path for --source file; stream URL for "
                         "--source mjpeg (http://host:port/)")
    ap.add_argument("--device", default="/dev/video21",
                    help="camera node for --source v4l2")
    ap.add_argument("--v4l2-pixfmt", default="yuy2",
                    choices=["yuy2", "mjpeg"],
                    help="V4L2 capture pixel format: yuy2 (the reference's "
                         "caps, pipeline_ir.rs:27-41) or mjpeg (compressed "
                         "mode most USB cameras need for >30fps; decoded "
                         "host-side to RGB)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--fps", type=int, default=60)
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until Quit)")
    ap.add_argument("--model", default="corr-tiny", choices=sorted(PRESETS))
    ap.add_argument("--checkpoint", default="", help="npz weights to load")
    ap.add_argument("--objects", type=int, default=1, metavar="N",
                    help="track N targets at once (sequential selection, "
                         "one batched device update per frame, per-target "
                         "Lost handling; exceeds the single-object "
                         "reference deliberately)")
    ap.add_argument("--exclusive", action="store_true",
                    help="with --objects: cross-slot duplicate suppression "
                         "— two slots collapsing onto one target after a "
                         "lookalike crossing sends the lower-confidence "
                         "one to lost/re-detection (tracker/multi.py)")
    ap.add_argument("--format", default="rgb", choices=["rgb", "nv12", "yuy2"],
                    dest="fmt",
                    help="frame format: rgb (active-pipeline analog), nv12 "
                         "(legacy 1080p path, luma HUD), yuy2 (camera format)")
    ap.add_argument("--headless", action="store_true",
                    help="no keyboard; auto-init on the synthetic target")
    ap.add_argument("--record", default="",
                    help="record frames to this path (.y4m streams raw "
                         "video playable anywhere; other suffixes collect "
                         "an .npy stack)")
    ap.add_argument("--record-track", default="", metavar="PATH",
                    help="append one JSON line per frame (state, bbox, "
                         "score; per-object in --objects mode) — the "
                         "machine-readable twin of the reference's console "
                         "prints (pipeline_ir.rs:210-220)")
    ap.add_argument("--preview", type=int, default=-1, metavar="PORT",
                    help="serve a live MJPEG preview on this HTTP port "
                         "(0 = ephemeral port; the headless analog of the "
                         "reference's kmssink display, pipeline_ir.rs:80-84)")
    ap.add_argument("--preview-host", default="127.0.0.1",
                    help="interface for --preview (default loopback; the "
                         "stream is unauthenticated — bind 0.0.0.0 only "
                         "knowingly)")
    ap.add_argument("--display-scale", action="store_true",
                    help="upscale output frames to the display resolution "
                         "on device (the reference's rgaconvert hardware "
                         "scaler stage, pipeline_ir.rs:62-73); rgb format")
    ap.add_argument("--no-pace", action="store_true",
                    help="run as fast as possible (benchmarking)")
    ap.add_argument("--init-bbox", default="", metavar="X,Y,W,H",
                    help="headless init box in frame pixels (the file-source "
                         "analog of the interactive corner selection, "
                         "tracker_context.rs:64-115; default: synthetic gt "
                         "box, else a centre box)")
    ap.add_argument("--seed", type=int, default=0)
    # Fault injection for soak/resilience runs (scripts/soak.py; the
    # reference has no analog — it exits on any pipeline error,
    # main.rs:56-65).  0 disables.
    ap.add_argument("--inject-source-fault", type=int, default=0,
                    metavar="N",
                    help="raise one transport fault (OSError + reopen "
                         "required) every N frames")
    ap.add_argument("--inject-device-fault", type=int, default=0,
                    metavar="N",
                    help="make the tracker backend raise once every N "
                         "updates (exercises backend re-create + re-seed)")
    ap.add_argument("--inject-corrupt", type=int, default=0, metavar="N",
                    help="corrupt the frame content every N frames "
                         "(exercises the Lost/re-detection path)")
    ap.add_argument("--speed", type=float, default=2.0,
                    help="synthetic target speed (0 = static)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the port's plain versions) "
                         "instead of the card")
    ap.add_argument("--pipelined", action="store_true",
                    help="one-frame-latency pipelining: never block on "
                         "in-flight device work (higher FPS, bbox lags one "
                         "frame)")
    return ap


class _FaultyBackend:
    """--inject-device-fault N: proxy that makes the backend raise once
    every N updates (counted per backend instance — a re-created backend
    starts a fresh countdown).  Everything else passes through."""

    def __init__(self, inner, every: int):
        self._inner = inner
        self._every = every
        self._n = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def update(self, frame):
        self._n += 1
        if self._every and self._n % self._every == 0:
            raise RuntimeError("injected device fault")
        return self._inner.update(frame)


def _unwrap(src):
    """See through the fault-injection wrapper for type/geometry checks."""
    return src.inner if isinstance(src, FlakySource) else src


def _wrap_flaky(src, args):
    if not (args.inject_source_fault or args.inject_corrupt):
        return src
    return FlakySource(src, corrupt_every=args.inject_corrupt,
                       fault_every=args.inject_source_fault, seed=args.seed)


def make_source(args):
    if args.source == "synthetic":
        # Multi-object runs get lookalike distractor patches so the extra
        # slots have something real to latch onto (media/source.py).
        return SyntheticSource(args.width, args.height, fps=args.fps,
                               seed=args.seed, fmt=args.fmt, speed=args.speed,
                               n_distractors=max(0, args.objects - 1))
    if args.source == "file":
        if not args.input:
            sys.exit("--source file requires --input")
        return FileSource(args.input, fps=args.fps)
    if args.source == "mjpeg":
        if not args.input:
            sys.exit("--source mjpeg requires --input http://host:port/")
        from ..media.mjpeg import MJPEGSource

        return MJPEGSource(args.input, fps=args.fps)
    return V4L2Source(args.device, args.width, args.height, args.fps,
                      pixfmt=args.v4l2_pixfmt)


@dataclasses.dataclass
class RunReport:
    """What a run ends with: its exit code and the app's own telemetry
    (the numbers of the closing ``Done:`` print, the rolling p50 track time
    and the mean frame-fetch and HUD draw times)."""

    rc: int
    frames: int = 0
    wall_s: float = 0.0
    final_state: str = ""
    track_ms_avg: float = 0.0
    track_ms_p50: float = 0.0
    map_ms: float = 0.0
    draw_ms: float = 0.0
    faults: int = 0
    source_reopens: int = 0
    backend_recreates: int = 0

    @property
    def fps(self) -> float:
        return self.frames / max(self.wall_s, 1e-9)


def main(argv=None) -> int:
    return run(argv).rc


def run(argv=None) -> RunReport:
    """The app: parse ``argv``, track, and report (see :class:`RunReport`)."""
    args = build_argparser().parse_args(argv)
    if args.gst:
        from ..media.gst import apply_to_args, parse_launch

        try:
            spec = parse_launch(args.gst)
        except ValueError as e:
            sys.exit(f"--gst: {e}")
        apply_to_args(spec, args)
        for note in spec.notes:
            print(f"pipeline: {note}")

    print("==========================================")
    print("   VitTrack TPU - Interactive Selection")
    print("==========================================\n")

    from ..device import resolve_device

    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return RunReport(rc=1)
    names = ([torch.cuda.get_device_name(dev)] if dev.type == "cuda"
             else ["cpu"])
    print(f"backend: {dev.type}  devices: {names}")

    src = make_source(args)
    # Fault-injection wrap AFTER construction: isinstance checks below
    # (synthetic auto-init bbox, file end-of-stream) see through it via
    # src.inner; the frame loop sees the faulty surface.
    src = _wrap_flaky(src, args)
    width, height = src.width, src.height
    # The source dictates the actual buffer layout: --source v4l2 delivers
    # packed YUY2 and --source file whatever the file holds; feeding those
    # into a mismatched preprocess path would crash on shape. Reconcile.
    src_fmt = getattr(src, "fmt", args.fmt)
    if src_fmt != args.fmt:
        print(f"note: --format {args.fmt} overridden by source "
              f"format {src_fmt}")
        args.fmt = src_fmt

    from ..models import vittrack, weights as weights_mod

    mcfg = PRESETS[args.model]
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    params = vittrack.init_params(gen, mcfg, device=dev)
    ckpt = args.checkpoint or weights_mod.default_checkpoint(args.model)
    if ckpt:
        params = weights_mod.load_npz(ckpt, mcfg, device=dev)
        print(f"loaded weights: {ckpt}")

    multi_mode = args.objects > 1
    if multi_mode:
        from ..session.multi import MultiObjectSession, TorchMultiTrackerBackend

        def _make_backend():
            return TorchMultiTrackerBackend(params, mcfg, args.objects,
                                            frame_format=args.fmt,
                                            exclusive=args.exclusive,
                                            device=dev)
    else:
        def _make_backend():
            return TorchTrackerBackend(params, mcfg, frame_format=args.fmt,
                                       pipelined=args.pipelined, device=dev)

    def make_backend():
        b = _make_backend()
        if args.inject_device_fault:
            b = _FaultyBackend(b, args.inject_device_fault)
        return b

    backend = make_backend()
    app_cfg = AppConfig()
    if multi_mode:
        session = MultiObjectSession(backend, width, height, app_cfg.session)
    else:
        session = TrackerSession(backend, width, height, app_cfg.session)
    stats = TimingStats(app_cfg.telemetry.window)
    phases = PhaseTimer()   # map/track/draw micro-breakdown (pipeline_ir.rs:126-208)
    sinks = []
    track_log = open(args.record_track, "a") if args.record_track else None
    if args.record:
        sinks.append(FileSink(args.record, fps=float(args.fps)))
    if args.preview >= 0:
        preview = MJPEGSink(args.preview, host=args.preview_host)
        print(f"live preview: http://{preview.host}:{preview.port}/")
        sinks.append(preview)
    if len(sinks) == 0:
        sink = NullSink()
    elif len(sinks) == 1:
        sink = sinks[0]
    else:
        sink = MultiSink(*sinks)

    running = threading.Event()
    running.set()
    cmd_q: pyqueue.Queue = pyqueue.Queue()
    if not args.headless:
        keyboard.start_keyboard_reader(cmd_q.put, running)

    if args.headless:
        # Auto-init on the known target (synthetic gt box or centre box),
        # unless the user pinned the box (--init-bbox, the file-source
        # analog of the interactive selection).
        if args.init_bbox:
            try:
                x, y, w, h = (int(v) for v in args.init_bbox.split(","))
            except ValueError:
                print(f"error: --init-bbox must be X,Y,W,H integers, got "
                      f"{args.init_bbox!r}")
                return RunReport(rc=2)
            if w < 20 or h < 20:  # selection_state.rs:42-43 minimum
                print(f"error: --init-bbox smaller than the 20x20 minimum "
                      f"selection: {w}x{h}")
                return RunReport(rc=2)
            bbox = (x, y, w, h)
        elif isinstance(_unwrap(src), SyntheticSource):
            bbox = tuple(int(v) for v in _unwrap(src).bbox_at(0))
        else:
            bbox = (width // 2 - 40, height // 2 - 40, 80, 80)
        frame0 = src.frame(0)
        if multi_mode:
            # Slot 0 on the target; the rest on the synthetic world's
            # lookalike distractor patches (real trackable content).
            session.tracker.init_slot(frame0, 0, bbox)
            for k in range(1, args.objects):
                if (isinstance(_unwrap(src), SyntheticSource)
                        and _unwrap(src)._distractors):
                    bb = tuple(int(v) for v in _unwrap(src).object_bbox_at(k, 0))
                else:
                    bb = (20 + 90 * k, 20, 80, 80)
                session.tracker.init_slot(frame0, k, bb)
            bbs, scores = session.tracker.update(frame0)
            from ..session.multi import Slot

            for k in range(args.objects):
                if float(scores[k]) > app_cfg.session.score_threshold:
                    session.slots[k] = Slot.TRACKING
                    session.boxes[k] = tuple(float(v) for v in bbs[k])
                    session.scores[k] = float(scores[k])
                else:
                    # Mirror the interactive low-score path: deactivate the
                    # backend slot, or every later frame batch-updates a
                    # slot the session ignores and the HUD stays pinned on
                    # "SELECT START k OF n" forever in headless mode.
                    session.tracker.deactivate(k)
            print(f"headless auto-init: {session.state_name()} scores="
                  + ",".join(f"{float(s):.2f}" for s in scores))
        else:
            session.tracker.init(frame0, bbox)
            b, score, ok = session.tracker.update(frame0)
            session.current_bbox = b
            session.current_score = score
            session.state = "tracking"
            print(f"headless auto-init: bbox={bbox} score={score:.3f}")

    period = 1.0 / args.fps
    last_t = None
    frame_idx = 0
    # A finite, non-looping file ends the run cleanly at its last frame
    # (the reference's pipeline gets EOS from v4l2src; our analog is the
    # file length) instead of riding the fault-recovery path off the end.
    end_frame = args.frames
    if isinstance(_unwrap(src), FileSource) and not _unwrap(src).loop:
        end_frame = (min(end_frame, _unwrap(src).num_frames) if end_frame
                     else _unwrap(src).num_frames)

    t_start = time.perf_counter()
    # Fault recovery: the reference merely exits on pipeline errors
    # (main.rs:56-65); we recover from transient device/relay faults by
    # re-creating the tracker backend and riding the Lost/auto-reset path,
    # giving up only after MAX_CONSECUTIVE_FAULTS bad frames in a row.
    MAX_CONSECUTIVE_FAULTS = 30
    consecutive_faults = 0
    total_faults = 0
    source_reopens = 0
    backend_recreates = 0

    try:
        while running.is_set():
            if end_frame and frame_idx >= end_frame:
                break
            now = time.perf_counter()
            if last_t is not None:
                stats.add_interval((now - last_t) * 1e6)
            last_t = now

            # Drain commands non-blockingly (pipeline_ir.rs:115-119).
            while True:
                try:
                    session.handle_command(cmd_q.get_nowait())
                except pyqueue.Empty:
                    break

            try:
                frame_idx = _run_frame(args, src, session, stats, phases,
                                       sink, app_cfg, frame_idx, dev,
                                       track_log=track_log)
                consecutive_faults = 0
            except KeyboardInterrupt:
                raise
            except EOFError as e:
                # A live stream ending (network camera closed, MJPEG
                # server gone) is end-of-input, not a fault: stop cleanly
                # like a file source running out of frames, don't burn 30
                # backend-recreate attempts on a source that cannot
                # recover (media/mjpeg.py raises EOFError for exactly
                # this; transient faults raise other exceptions and keep
                # the recovery path below).
                print(f"\rSource ended at frame {frame_idx}: {e}")
                break
            except Exception as e:
                consecutive_faults += 1
                total_faults += 1
                print(f"\rFrame {frame_idx} error: {e!r} "
                      f"({consecutive_faults}/{MAX_CONSECUTIVE_FAULTS})")
                if consecutive_faults >= MAX_CONSECUTIVE_FAULTS:
                    print("Unrecoverable: too many consecutive faults")
                    break
                if isinstance(e, OSError) and hasattr(src, "reopen"):
                    # Transport fault (connection reset, socket timeout,
                    # ioctl error — media/mjpeg.py, media/v4l2.py): the
                    # device and tracker state are intact, so reconnect
                    # the source and carry on with template and search
                    # window preserved — a camera hiccup costs frames,
                    # never the target.  A long outage degrades
                    # organically via the score threshold -> Lost ->
                    # re-detection ramp; a failed reconnect just counts
                    # as the next fault.
                    try:
                        src.reopen()
                        source_reopens += 1
                    except Exception as e3:
                        print(f"Source reopen failed: {e3!r}")
                else:
                    # Device/backend fault: re-create the backend, then
                    # re-seed its template from the last confirmed box on
                    # a fresh frame — a bare re-created backend raises
                    # 'tracker not initialised' on every Lost-mode update
                    # and the session limps to the 60-frame auto-reset
                    # instead of re-acquiring.
                    try:
                        backend = make_backend()
                        session.tracker = backend
                        _reseed_backend(src, session, backend, frame_idx)
                        backend_recreates += 1
                    except Exception as e2:
                        print(f"Backend re-create failed: {e2!r}")
                    if hasattr(session, "slots") or \
                            session.current_bbox is not None:
                        session.force_lost()
                    # else: still selecting — nothing to lose, keep
                    # selecting instead of detouring through LOST.
                frame_idx += 1

            if not args.no_pace:
                sleep = period - (time.perf_counter() - now)
                if sleep > 0:
                    time.sleep(sleep)
    except KeyboardInterrupt:
        pass
    finally:
        running.clear()
        sink.close()
        if track_log is not None:
            track_log.close()

    wall = time.perf_counter() - t_start
    print(f"\nDone: {frame_idx} frames in {wall:.1f}s "
          f"({frame_idx / max(wall, 1e-9):.1f} fps), "
          f"final state {session.state_name()}, "
          f"avg track {stats.avg_track_ms():.2f}ms, "
          f"faults {total_faults} (reopens {source_reopens}, "
          f"backend recreates {backend_recreates})")
    return RunReport(
        rc=0, frames=frame_idx, wall_s=wall, final_state=session.state_name(),
        track_ms_avg=stats.avg_track_ms(), track_ms_p50=stats.p50_track_ms(),
        map_ms=phases.avg_ms("map"), draw_ms=phases.avg_ms("draw"),
        faults=total_faults,
        source_reopens=source_reopens, backend_recreates=backend_recreates)


def _reseed_backend(src, session, backend, frame_idx: int) -> None:
    """Give a freshly re-created backend a live template: re-init from the
    session's last confirmed box(es) on a fresh source frame so the Lost
    re-detection ramp has something to re-acquire with.  Device faults are
    short (a few frames), so the last box is still a good template seed;
    selection mode has nothing to seed and simply continues selecting."""
    if hasattr(session, "slots"):            # multi-object session
        from ..session.multi import Slot

        boxes = [(k, session.boxes[k]) for k in range(session.n)
                 if session.slots[k] in (Slot.TRACKING, Slot.LOST)
                 and session.boxes[k] is not None]
        if not boxes:
            return
        frame = src.frame(frame_idx)
        for k, bb, in boxes:
            backend.init_slot(frame, k, bb)
    elif session.current_bbox is not None:
        backend.init(src.frame(frame_idx), session.current_bbox)


def _run_frame(args, src, session, stats, phases, sink, app_cfg,
               frame_idx: int, dev: torch.device, track_log=None) -> int:
    """One iteration of the per-frame hot loop (pipeline_ir.rs:100-228):
    fetch -> track -> HUD -> sink -> telemetry.  Raises on device/source
    faults; the caller recovers.  Returns the next frame index.

    The HUD paints in place into a copy of the frame that it uploads for
    itself (``torch.tensor`` always copies), never into a buffer the
    tracker may still read: in ``--pipelined`` mode that read can still be
    in flight."""

    with phases.phase("map"):
        frame = src.frame(frame_idx)

    t1 = time.perf_counter()
    with phases.phase("track"):
        bbox = session.process_frame(frame)
    track_us = (time.perf_counter() - t1) * 1e6
    stats.add_times(0.0, track_us)

    # HUD overlay on the device (pipeline_ir.rs:162-204).
    state_name = session.state_name()
    if track_log is not None:
        import json

        rec = {"frame": frame_idx, "state": state_name,
               "track_ms": round(track_us / 1e3, 3)}
        if hasattr(session, "tracked_boxes"):      # multi-object session
            rec["objects"] = [
                {"id": k, "bbox": [float(v) for v in bb],
                 "score": round(float(sc), 4)}
                for k, bb, sc in session.tracked_boxes()]
        else:
            bb = bbox if bbox is not None else session.current_bbox
            rec["bbox"] = ([float(v) for v in bb] if bb else None)
            rec["score"] = round(float(session.current_score), 4)
        track_log.write(json.dumps(rec) + "\n")
    sel = session.selection
    hud = overlay.HudParams(
        state_name=state_name,
        fps=stats.fps(),
        track_ms=stats.avg_track_ms(),
        score=session.current_score,
        is_tracking=state_name.startswith("TRACKING"),
        is_selecting=state_name.startswith("SELECT"),
        cursor=(sel.cursor_x, sel.cursor_y),
        sel_start=(sel.start_x, sel.start_y),
        sel_active=sel.phase.value == "selecting_area",
        bbox=(bbox if bbox is not None else
              (session.current_bbox if state_name == "TRACKING" and
               session.current_bbox else (0, 0, 0, 0))),
        has_bbox=bbox is not None or (
            state_name == "TRACKING" and session.current_bbox is not None),
    )
    t_draw = time.perf_counter()
    # HUD target per format (mirrors the reference: the active
    # pipeline draws on RGB after videoconvert, the legacy one on
    # the NV12 luma plane).
    # Each draw is a compiled program with the frame donated, as JAX jits
    # them: the host frame is copied into the program's buffer.
    if args.fmt == "rgb":
        out = overlay.render_hud_jit(frame, hud, dev)
    elif args.fmt == "yuy2":
        from ..ops import colorspace

        rgb = colorspace.yuy2_to_rgb_jit(frame.reshape(-1), src.width,
                                         src.height, dev)
        out = overlay.render_hud_jit(rgb, hud, dev)
    else:  # nv12 — draw into the luma plane
        from ..ops import overlay_nv12

        y_pl, _uv = frame
        out = overlay_nv12.render_hud_luma_jit(y_pl, hud, dev)
    # Per-target boxes beyond the primary (multi-object mode): distinct
    # colors on RGB, brightness steps on luma.
    extra = (session.tracked_boxes()[1:]
             if hasattr(session, "tracked_boxes") else [])
    if extra:
        colors = ((255, 80, 80), (80, 160, 255), (255, 255, 80),
                  (255, 80, 255), (80, 255, 255))
        from ..ops import overlay_nv12
        for k, bb, _sc in extra:
            x, y, w, h = (int(v) for v in bb)
            if args.fmt == "nv12":
                out = overlay_nv12.draw_rect_luma_strips(
                    out, x, y, w, h, 2, 255 - 40 * (k % 4))
            else:
                out = overlay.draw_rect(out, x, y, w, h, 2,
                                        colors[(k - 1) % len(colors)])
    if args.display_scale:
        # RGA-upscale analog (pipeline_ir.rs:62-73) on every format: the
        # RGB paths scale the composited RGB; the NV12 path scales its
        # HUD'd luma plane (the legacy pipeline also displays the NV12
        # frame at full screen via kmssink, pipeline.rs:37-50).
        from ..ops import resample

        out = resample.resize_static_jit(out, app_cfg.display.height,
                                         app_cfg.display.width, dev)
    phases.totals["draw"] = phases.totals.get("draw", 0.0) + (
        time.perf_counter() - t_draw)
    phases.counts["draw"] = phases.counts.get("draw", 0) + 1
    # Only recording sinks need host pixels at write time; the null sink
    # keeps the frame on the device (no transfer) and the MJPEG preview
    # fetches lazily on its own handler thread, per connected client.
    sink.write(host_pixels(out) if getattr(sink, "wants_host_pixels", False)
               else out)
    # Bound in-flight device work (the reference's leaky queue caps
    # buffers at 3, pipeline_ir.rs:75-78): an unpaced loop could
    # otherwise enqueue HUD frames far ahead of the card.
    if frame_idx % app_cfg.queue.max_buffers == 0 and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()

    if frame_idx % app_cfg.telemetry.print_every == 0 and frame_idx > 0:
        print(f"[{state_name}] FPS: {stats.fps():.0f} | "
              f"track: {stats.avg_track_ms():.1f}ms | "
              f"p50: {stats.p50_track_ms():.1f}ms | "
              f"draw: {phases.avg_ms('draw'):.1f}ms | "
              f"map: {phases.avg_ms('map'):.1f}ms | "
              f"score: {session.current_score * 100:.0f}%")

    return frame_idx + 1


if __name__ == "__main__":
    sys.exit(main())
