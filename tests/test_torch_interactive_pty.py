"""PyTorch port: the interactive app (not ``--headless``) driven through a
real pty, as ``tests/test_interactive_pty.py`` drives the JAX package's.

It spawns ``python -m gstreamer_vit_tracker_tpu_torch.app.main --cpu`` on a
pty, types the reference key protocol (move fast T/F/G/H, Enter to latch
each corner, Q to quit) and asserts the session walks SELECT START ->
SELECT END -> TRACKING and exits 0; with ``--objects 2`` it arms slot after
slot and ends TRACKING 2 OF 2.  ``tests/test_torch_app.py`` runs the port's
app headless only.  Marked ``slow``, as JAX's drive is.
"""

import os
import pty
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = [sys.executable, "-m", "gstreamer_vit_tracker_tpu_torch.app.main",
        "--cpu", "--model", "corr-tiny", "--width", "320", "--height", "256",
        "--speed", "0", "--frames", "3000", "--no-pace"]


class _Session:
    """The app on a pty: its output drained by a thread, keys typed into
    the pty."""

    def __init__(self, extra):
        self.master, slave = pty.openpty()
        self.proc = subprocess.Popen(ARGV + extra, stdin=slave,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, cwd=REPO)
        os.close(slave)
        self.out = bytearray()
        self.done = threading.Event()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        while True:
            chunk = self.proc.stdout.read(256)
            if not chunk:
                break
            self.out.extend(chunk)
        self.done.set()

    def text(self) -> str:
        return self.out.decode(errors="replace")

    def wait_for(self, needle: str, timeout: float) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if needle.encode() in self.out:
                return
            if self.proc.poll() is not None:
                break
            time.sleep(0.1)
        assert needle.encode() in self.out, self.text()

    def keys(self, chars: bytes, settle: float = 0.25):
        for ch in chars:
            os.write(self.master, bytes([ch]))
            time.sleep(settle)

    def select_centre_box(self, first: str, confirmed: str):
        # The target sits at the frame's centre (speed 0), the cursor too:
        # up-left fast once (T, F), latch; down-right fast twice, confirm.
        self.keys(b"tf\r")
        self.wait_for(first, 30)
        self.keys(b"hhgg\r")
        self.wait_for(confirmed, 60)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        os.close(self.master)
        self.done.wait(5)


@pytest.mark.slow
def test_interactive_select_and_track():
    s = _Session([])
    try:
        s.wait_for("KEYBOARD CONTROLS", 90)
        s.select_centre_box("Start point set", "*** TRACKING STARTED! ***")
        s.keys(b"q")
        assert s.proc.wait(timeout=60) == 0
    finally:
        s.close()
    text = s.text()
    assert "Init result: score=" in text
    assert "Done:" in text
    assert "TRACKING" in text


@pytest.mark.slow
def test_interactive_multi_object_select_and_track():
    # --objects 2: the sequential selection arms slot after slot, both
    # targets then advance in one batched update a frame.
    s = _Session(["--objects", "2"])
    try:
        s.wait_for("KEYBOARD CONTROLS", 90)
        for obj in (1, 2):
            s.select_centre_box(f"Object {obj}: start point set",
                                f"TRACKING object {obj}")
        s.keys(b"q")
        assert s.proc.wait(timeout=60) == 0
    finally:
        s.close()
    text = s.text()
    assert "TRACKING object 1" in text
    assert "TRACKING object 2" in text
    assert "TRACKING 2 OF 2" in text
