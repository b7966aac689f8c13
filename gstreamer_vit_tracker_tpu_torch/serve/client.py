"""Blocking client for the tracking service: one client = one stream.

    c = TrackClient("127.0.0.1", port)
    slot = c.init(frame, (x, y, w, h))
    bbox, score = c.update(frame)          # one round trip per frame
    c.release(); c.close()

Frames use the package's array conventions (nv12: (y, uv) planes; yuy2:
packed (H, W*2); rgb: (H, W, 3) uint8).  Run N clients (threads or
processes) against one server and their updates coalesce into one batched
step per tick (serve/server.py).  The port's own copy of
``gstreamer_vit_tracker_tpu/serve/client.py`` (numpy and sockets only).
"""

from __future__ import annotations

import socket
from typing import Optional, Tuple

import numpy as np

from . import protocol


class TrackClient:
    def __init__(self, host: str, port: int, timeout_s: float = 120.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.info = self._rpc({"op": "hello"})
        self.fmt: str = self.info["format"]
        self.slot: Optional[int] = None

    def _rpc(self, header, payload: bytes = b"") -> dict:
        protocol.send_msg(self._sock, header, payload)
        reply, _ = protocol.recv_msg(self._sock)
        if not reply.get("ok"):
            raise TrackServiceError(reply.get("error", "unknown error"),
                                    reinit=bool(reply.get("reinit")))
        return reply

    def init(self, frame, bbox) -> int:
        """Start (or restart, e.g. after a recovery fault) this stream's
        track.  Returns the allocated slot id."""
        reply = self._rpc({"op": "init", "bbox": [float(v) for v in bbox]},
                          protocol.frame_to_bytes(self.fmt, frame))
        self.slot = int(reply["slot"])
        return self.slot

    def update(self, frame) -> Tuple[np.ndarray, float]:
        if self.slot is None:
            raise TrackServiceError("init first", reinit=True)
        reply = self._rpc({"op": "update", "slot": self.slot},
                          protocol.frame_to_bytes(self.fmt, frame))
        return (np.asarray(reply["bbox"], np.float32),
                float(reply["score"]))

    def release(self) -> None:
        if self.slot is not None:
            self._rpc({"op": "release", "slot": self.slot})
            self.slot = None

    def stats(self) -> dict:
        return self._rpc({"op": "stats"})

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrackServiceError(RuntimeError):
    """Server-side error.  ``reinit`` means the slot was lost (device
    fault recovered from an older snapshot) — call ``init`` again."""

    def __init__(self, msg: str, reinit: bool = False):
        super().__init__(msg)
        self.reinit = reinit
