"""Raw-TTY keyboard control plane.

Port of reference raw_mode_guard.rs: an RAII raw-mode guard
(ICANON+ECHO off, VMIN=1) and a detached reader thread that decodes bytes
to UserCommands and pushes them over a queue.  'Q' clears the running flag
and emits Quit (rs:92-95).
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from ..session.commands import Kind, decode_key

BANNER = """
╔═══════════════════════════════════════════╗
║            KEYBOARD CONTROLS              ║
╠═══════════════════════════════════════════╣
║  W/A/S/D or I/J/K/L  - Move cursor        ║
║  Shift + above       - Fast move          ║
║  Enter or Space      - Confirm point      ║
║  R or Escape         - Reset              ║
║  Q                   - Quit               ║
╚═══════════════════════════════════════════╝

Step 1: Move to FIRST corner, press Enter
Step 2: Move to SECOND corner, press Enter
"""


class RawModeGuard:
    """Context manager putting stdin into raw (non-canonical, no-echo)
    mode; restores the original termios on exit (raw_mode_guard.rs:12-37)."""

    def __init__(self, fd: int = 0):
        self.fd = fd
        self._saved = None

    def __enter__(self):
        try:
            import termios

            self._saved = termios.tcgetattr(self.fd)
            raw = termios.tcgetattr(self.fd)
            raw[3] &= ~(termios.ICANON | termios.ECHO)   # lflags
            raw[6][termios.VMIN] = 1
            raw[6][termios.VTIME] = 0
            termios.tcsetattr(self.fd, termios.TCSANOW, raw)
        except Exception:
            self._saved = None   # not a TTY — run without raw mode
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(self.fd, termios.TCSANOW, self._saved)
        return False


def start_keyboard_reader(push: Callable, running: threading.Event,
                          print_banner: bool = True) -> threading.Thread:
    """Spawn the reader thread (raw_mode_guard.rs:39-107).  ``push`` receives
    UserCommands; ``running.clear()`` on Quit."""

    def reader():
        with RawModeGuard():
            if print_banner:
                print(BANNER)
            while running.is_set():
                try:
                    b = os.read(0, 1)
                except OSError:
                    break
                if not b:
                    break
                cmd = decode_key(b[0])
                if cmd is None:
                    continue
                if cmd.kind == Kind.QUIT:
                    running.clear()
                push(cmd)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    return t
