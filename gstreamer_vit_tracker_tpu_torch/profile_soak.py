"""The app's memory over a long soak: where the soak's steady window starts.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_soak [frames]

It runs the port's headless app (corr-tiny, 320x256 NV12) as a subprocess
the way ``scripts/soak.py`` does, twice: ``frames`` frames (default 6000)
with the soak's faults (source every 397 frames, device every 601, corrupt
every 251), then half as many without faults.  It samples the app's RSS
every 0.5 s from here and ``torch.cuda.memory_reserved()`` inside the app,
and prints, for each run, the RSS when the app's first FPS print came and
at the end, the reserve's every change, and the times of the faults, the
recoveries and the FPS prints (seconds from the start).  Prints the card's
name and power limit, then one JSON object a run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from .scripts import soak

SAMPLE_S = 0.5


def run(frames: int, faults: bool) -> dict:
    argv = ["--headless", "--no-pace", "--source", "synthetic", "--format",
            "nv12", "--model", "corr-tiny", "--width", "320", "--height",
            "256", "--frames", str(frames)]
    if faults:
        argv += ["--inject-source-fault", "397", "--inject-device-fault",
                 "601", "--inject-corrupt", "251"]
    with tempfile.TemporaryDirectory() as tmp:
        mem = os.path.join(tmp, "reserved.txt")
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-u", "-c", soak._CHILD, mem, str(SAMPLE_S),
             *argv], cwd=soak.REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1)
        rss, done = [], threading.Event()

        def sample():
            while not done.wait(SAMPLE_S):
                rss.append((round(time.monotonic() - t0, 2),
                            round(soak._rss_mb(proc.pid), 1)))

        threading.Thread(target=sample, daemon=True).start()
        events = []
        for line in proc.stdout:
            line = line.strip()
            if ("FPS:" in line or "error" in line or "re-acquired" in line
                    or "lost" in line or line.startswith("Done:")):
                events.append((round(time.monotonic() - t0, 2), line[:48]))
        rc = proc.wait()
        done.set()
        reserved = [(round(t - t0, 2), round(mb, 1))
                    for t, mb in soak._reserved(mem)]
    first_fps = next((t for t, e in events if "FPS:" in e), None)
    changes = [r for i, r in enumerate(reserved)
               if i == 0 or r[1] != reserved[i - 1][1]]
    at_fps = [mb for t, mb in rss if first_fps is not None and t >= first_fps]
    return {"faults": faults, "frames": frames, "rc": rc,
            "first_fps_print_s": first_fps,
            "rss_mb_at_first_fps": at_fps[0] if at_fps else None,
            "rss_mb_max_after_first_fps": max(at_fps, default=None),
            "rss_mb_last": rss[-1][1] if rss else None,
            "reserved_mb_changes": changes,
            "events": [e for e in events if "FPS:" not in e[1]]}


def main() -> int:
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 6000
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for n, faults in ((frames, True), (frames // 2, False)):
        print(json.dumps(run(n, faults)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
