"""Long-duration steady-state soak of the port's headless app.

Port of ``scripts/soak.py``, with its flags, defaults, JSON line and exit
codes.  It runs the port's app (``gstreamer_vit_tracker_tpu_torch.app.main
--headless --no-pace``) as a subprocess over many NV12 frames with injected
source transport faults, corrupt frames and device faults, and watches what
an indefinite deployment cares about (the reference runs forever on a live
camera, main.rs:56-65):

* RSS of the app process, sampled every ``--sample-s`` seconds: no
  monotonic growth (median of the last quarter against the first quarter
  of the steady samples);
* fps drift: the app's periodic ``[STATE] FPS: ...`` prints, last quarter
  against the first;
* fault recovery: every injected fault recovered (source reopens counted by
  the app's ``Done:`` line, device faults by the session's ``Tracker
  error`` / ``re-acquired`` prints), and no ``Unrecoverable``;
* build churn, the counterpart of the JAX script's compile-cache check:
  no kernel library appears under ``build/torch_kernels/`` in the second
  half of the run, and the card's ``torch.cuda.memory_reserved()`` in the
  app, sampled beside the RSS, does not grow past its first half's peak.

Memory is compared only over the steady samples: those after warm-up,
which ends at the app's first FPS print after it has recovered from the
first injected source fault and the first device fault (each only where
the run is long enough to inject one).  On the card the app's start-up
(CUDA context, libraries, module loading) raises its RSS to ~6.3 GB by its
first FPS print, and the first device-fault recovery adds one 2 MB block
to the allocator's reserve, after which both stay flat through thousands
of frames and faults (``profile_soak.py``); a short run would otherwise
count that as growth.  The JAX script's 12000-frame default puts all of it
in the first quarter it skips.

Prints one JSON line; exit code 0 iff every check holds.

Usage:
    python -m gstreamer_vit_tracker_tpu_torch.scripts.soak --frames 12000
    python -m gstreamer_vit_tracker_tpu_torch.scripts.soak --frames 2000 \
        --cpu --model corr-tiny
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

from ..ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Run in the app's process: sample the card's reserved memory into the file
# named by argv[1] every argv[2] seconds, then run the app on the rest.
_CHILD = """
import sys, threading, time
import torch
from gstreamer_vit_tracker_tpu_torch.app import main as app
path, period = sys.argv[1], float(sys.argv[2])
def sample():
    with open(path, "a") as f:
        while True:
            f.write(f"{time.monotonic()} {torch.cuda.memory_reserved()}\\n")
            f.flush()
            time.sleep(period)
if torch.cuda.is_available():
    threading.Thread(target=sample, daemon=True).start()
sys.exit(app.main(sys.argv[3:]))
"""


def _rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0


def _kernel_builds() -> int:
    try:
        return sum(f.endswith(".so") for f in os.listdir(cuda_build.BUILD_DIR))
    except OSError:
        return 0


def _reserved(path: str) -> list:
    """(t, MB) samples the app wrote."""
    try:
        with open(path) as f:
            rows = [line.split() for line in f]
    except OSError:
        return []
    return [(float(t), int(b) / 2 ** 20) for t, b in rows if b]


def quarter(samples, which: str):
    """The median value of (t, value) ``samples`` over their second
    quarter (``which="first"``: the first quarter is warm-up) or their last
    quarter (``"last"``); None under 8 samples."""
    vals = [v for t, v in samples]
    n = len(vals)
    if n < 8:
        return None
    q = max(2, n // 4)
    chunk = sorted(vals[q:2 * q] if which == "first" else vals[-q:])
    return chunk[len(chunk) // 2]


def fps_steady(fps_prints, drift_frac: float):
    """The fps-drift check on the app's (t, fps) prints: (first-quarter
    fps, last-quarter fps, whether the last is at least ``1 - drift_frac``
    of the first).  It bounds a collapse, not jitter: on a host shared
    with other busy processes the prints measure the neighbours as well."""
    first, last = quarter(fps_prints, "first"), quarter(fps_prints, "last")
    ok = (first is not None and last is not None
          and last >= (1.0 - drift_frac) * first)
    return first, last, ok


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12000)
    ap.add_argument("--model", default="vittrack-t")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--source-fault-every", type=int, default=997)
    ap.add_argument("--device-fault-every", type=int, default=1501)
    ap.add_argument("--corrupt-every", type=int, default=643)
    ap.add_argument("--sample-s", type=float, default=5.0,
                    help="RSS sampling period")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rss-growth-mb", type=float, default=150.0,
                    help="max allowed last-quarter vs first-quarter RSS "
                         "median growth")
    ap.add_argument("--fps-drift-frac", type=float, default=0.5,
                    help="max allowed relative fps drop, last vs first "
                         "quarter (bounds collapse, not jitter)")
    ap.add_argument("--timeout-s", type=float, default=5400.0)
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    app_argv = ["--headless", "--no-pace", "--source", "synthetic",
                "--format", "nv12", "--model", args.model,
                "--width", str(args.width), "--height", str(args.height),
                "--frames", str(args.frames),
                "--inject-source-fault", str(args.source_fault_every),
                "--inject-device-fault", str(args.device_fault_every),
                "--inject-corrupt", str(args.corrupt_every)]
    if args.cpu:
        app_argv.append("--cpu")

    tmp = tempfile.TemporaryDirectory()
    mem_log = os.path.join(tmp.name, "reserved.txt")
    cmd = [sys.executable, "-u", "-c", _CHILD, mem_log, str(args.sample_s),
           *app_argv]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)

    rss_samples: list = []          # (t, mb)
    build_samples: list = []        # (t, kernel libraries)
    done = threading.Event()

    def sampler():
        while not done.wait(args.sample_s):
            t = time.monotonic() - t0
            mb = _rss_mb(proc.pid)
            if mb > 0:
                rss_samples.append((t, mb))
            build_samples.append((t, _kernel_builds()))

    threading.Thread(target=sampler, daemon=True).start()

    fps_prints: list = []           # (t, fps)
    tracker_errors = 0
    reacquired = 0
    unrecoverable = False
    # Warm-up lasts until the first FPS print after the first recovery of
    # each fault kind the run injects.
    need_source = bool(args.source_fault_every
                       and args.frames > args.source_fault_every)
    need_device = bool(args.device_fault_every
                       and args.frames > args.device_fault_every)
    warm_t = None
    tail: list = []
    summary_line = ""
    fps_re = re.compile(r"\[([A-Z ]+)\] FPS: (\d+)")

    killer = threading.Timer(args.timeout_s, proc.kill)
    killer.start()
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            tail.append(line)
            del tail[:-30]
            m = fps_re.search(line)
            if m:
                fps_prints.append((time.monotonic() - t0, float(m.group(2))))
                if warm_t is None and not (need_source or need_device):
                    warm_t = fps_prints[-1][0]
            if "Tracker error" in line:
                tracker_errors += 1
            if "re-acquired" in line:
                reacquired += 1
                need_device = need_device and tracker_errors == 0
            if re.match(r"\s*Frame \d+ error", line):
                need_source = False
            if "Unrecoverable" in line:
                unrecoverable = True
            if line.startswith("Done:"):
                summary_line = line
    finally:
        rc = proc.wait()
        killer.cancel()
        done.set()
    wall = time.monotonic() - t0
    reserved = _reserved(mem_log)
    tmp.cleanup()

    steady = [(t, v) for t, v in rss_samples
              if warm_t is not None and t >= warm_t]
    rss_first = quarter(steady, "first")
    rss_last = quarter(steady, "last")
    fps_first, fps_last, fps_ok = fps_steady(fps_prints, args.fps_drift_frac)
    # Build churn: kernel libraries appearing in the SECOND half.
    builds_mid = (build_samples[len(build_samples) // 2][1]
                  if build_samples else 0)
    builds_end = build_samples[-1][1] if build_samples else 0
    # The app stamps its samples with the same system-wide monotonic clock.
    reserved = [v for t, v in reserved
                if warm_t is not None and t - t0 >= warm_t]
    half = len(reserved) // 2
    reserved_first = max(reserved[:half], default=None)
    reserved_last = max(reserved[half:], default=None)

    m = re.search(r"Done: (\d+) frames .*faults (\d+) \(reopens (\d+)",
                  summary_line)
    frames_done = int(m.group(1)) if m else 0
    app_faults = int(m.group(2)) if m else -1
    reopens = int(m.group(3)) if m else -1

    checks = {
        "completed": rc == 0 and frames_done >= args.frames,
        "no_unrecoverable": not unrecoverable,
        "source_faults_recovered": reopens >= args.frames
        // args.source_fault_every if args.source_fault_every else True,
        "device_faults_recovered": (tracker_errors == 0
                                    or reacquired >= 1),
        "rss_steady": (rss_first is not None and rss_last is not None
                       and rss_last - rss_first <= args.rss_growth_mb),
        "fps_steady": fps_ok,
        "no_late_builds": builds_end - builds_mid == 0,
        # On the CPU the app reserves nothing on a card: nothing to grow.
        "reserved_steady": (args.cpu or (
            reserved_first is not None and reserved_last is not None
            and reserved_last <= reserved_first)),
    }
    result = {
        "metric": "soak_frames", "value": frames_done, "unit": "frames",
        "wall_s": round(wall, 1), "warm_up_s": warm_t,
        "fps_overall": round(frames_done / max(wall, 1e-9), 1),
        "rss_first_mb": rss_first, "rss_last_mb": rss_last,
        "fps_first": fps_first, "fps_last": fps_last,
        "app_faults": app_faults, "source_reopens": reopens,
        "session_tracker_errors": tracker_errors,
        "reacquired": reacquired,
        "kernel_builds_2nd_half": builds_end - builds_mid,
        "reserved_first_half_peak_mb": reserved_first,
        "reserved_second_half_peak_mb": reserved_last,
        "checks": checks,
        "ok": all(checks.values()),
    }
    print(json.dumps(result))
    if not result["ok"]:
        print("SOAK FAILED; last output lines:", file=sys.stderr)
        for line in tail[-12:]:
            print("  " + line, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
