"""MJPEG-over-HTTP network camera source.

The reference ingests live video from a local V4L2 sensor
(reference pipeline_ir.rs:21-41, main.rs:32).  The network
analog — an IP camera serving ``multipart/x-mixed-replace`` JPEG, the
gst-launch chain ``souphttpsrc ! multipartdemux ! jpegdec`` — is the other
live-capture path a tracker deployment meets in practice, and it is the
exact dual of this framework's :class:`~.sink.MJPEGSink` preview, so a
tracker box can chain off another box's preview stream.

Pure stdlib transport (http.client); JPEG decode via cv2 (or PIL as
fallback).  Both part framings are handled: ``Content-Length`` headers
(what MJPEGSink emits) and unframed streams that need JPEG end-of-image
scanning (what many IP cameras emit).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["MJPEGSource", "decode_jpeg"]

_SOI = b"\xff\xd8"   # JPEG start-of-image
_EOI = b"\xff\xd9"   # JPEG end-of-image


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 RGB (H, W, 3), via cv2 else PIL."""
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("cv2 could not decode JPEG part "
                             f"({len(buf)} bytes)")
        return np.ascontiguousarray(img[..., ::-1])     # BGR -> RGB
    except ImportError:
        pass
    import io

    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            "MJPEG decode needs cv2 or PIL (neither is importable): "
            "--source mjpeg and the MJPEG preview sink are unavailable "
            "on this box — use --source synthetic/file/v4l2 instead "
            "(see README capability matrix)") from None

    return np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))


class MJPEGSource:
    """Live frames from an MJPEG HTTP stream (IP camera / MJPEGSink).

    Same source contract as :class:`~.source.V4L2Source`: ``.width``,
    ``.height``, ``.fps``, ``.fmt == "rgb"``, ``frame(i)`` returning the
    NEXT live frame (the index is advisory — a live stream cannot seek),
    and ``close()``.  Geometry is learned from the first frame, which is
    fetched eagerly at construction and replayed on the first ``frame()``
    call so nothing is dropped.
    """

    def __init__(self, url: str, fps: int = 60, timeout: float = 5.0):
        import urllib.parse

        u = urllib.parse.urlsplit(url)
        if u.scheme != "http":
            raise ValueError(f"MJPEGSource supports http:// URLs, got {url!r}"
                             " (https adds TLS state for no tracking value;"
                             " terminate TLS in front if needed)")
        self.url = url
        self.fps = fps
        self.fmt = "rgb"
        self._timeout = timeout
        self._conn = None
        self._connect()
        self.height, self.width = self._pending.shape[:2]

    def _connect(self) -> None:
        import http.client
        import urllib.parse

        u = urllib.parse.urlsplit(self.url)
        self._conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                                timeout=self._timeout)
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        self._conn.request("GET", path)
        resp = self._conn.getresponse()
        if resp.status != 200:
            raise ConnectionError(
                f"{self.url}: HTTP {resp.status} {resp.reason}")
        ctype = resp.getheader("Content-Type", "")
        if "multipart" not in ctype:
            raise ValueError(f"{self.url}: not an MJPEG stream "
                             f"(Content-Type {ctype!r})")
        self._resp = resp
        self._buf = bytearray()
        # Eager first frame: learns geometry and proves the stream is
        # actually producing; replayed by the next frame() call.
        self._pending: Optional[np.ndarray] = decode_jpeg(self._read_part())

    def reopen(self) -> None:
        """Reconnect after a transport fault (connection reset, timeout).

        The app's fault-recovery loop calls this so a camera hiccup costs
        a few frames, not the whole run; a CLEAN stream end raises
        EOFError instead, which the app treats as end-of-input.  The
        camera analog of the reference's bus-error handling
        (reference main.rs:58-65) — except we recover."""
        self.close()
        self._connect()

    # -- buffered reads over the response body -------------------------------

    def _fill(self, n: int = 8192) -> bool:
        # read1, NOT read: BufferedIOBase.read(n) is greedy — it blocks
        # until the full n bytes accumulate, which would hold completed
        # frames hostage to the arrival of later ones (a live camera
        # sending 3 KB parts would reach us in ~8 KB bursts).  read1
        # returns after one raw recv with whatever is available.
        chunk = self._resp.read1(n)
        if not chunk:
            return False
        self._buf += chunk
        return True

    def _readline(self) -> bytes:
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                line = bytes(self._buf[:i + 1])
                del self._buf[:i + 1]
                return line
            if not self._fill():
                raise EOFError(f"{self.url}: stream ended mid-headers")

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            if not self._fill():
                raise EOFError(f"{self.url}: stream ended mid-frame")
        data = bytes(self._buf[:n])
        del self._buf[:n]
        return data

    def _read_part(self) -> bytes:
        """One multipart body: skip boundary + headers, return the JPEG."""
        headers = {}
        while True:
            s = self._readline().strip()
            if not s:
                if headers:
                    break                    # blank line ends the headers
                continue                     # blank before the boundary
            if s.startswith(b"--"):
                headers = {}                 # boundary line (possibly final)
                continue
            if b":" in s:
                k, v = s.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
        n = headers.get(b"content-length")
        if n is not None:
            return self._read_exact(int(n))
        # Length-less camera framing: scan for the JPEG end-of-image
        # marker.  Start past any header slop to the SOI first.
        while True:
            soi = self._buf.find(_SOI)
            if soi >= 0:
                break
            if not self._fill():
                raise EOFError(f"{self.url}: no JPEG SOI in part")
        del self._buf[:soi]
        search_from = 2
        while True:
            eoi = self._buf.find(_EOI, search_from)
            if eoi >= 0:
                return self._read_exact(eoi + 2)
            search_from = max(2, len(self._buf) - 1)
            if not self._fill():
                raise EOFError(f"{self.url}: stream ended mid-frame")

    # -- source contract ------------------------------------------------------

    def frame(self, i: int) -> np.ndarray:
        if self._pending is not None:
            f, self._pending = self._pending, None
            return f
        return decode_jpeg(self._read_part())

    def close(self) -> None:
        if self._conn is None:
            return
        try:
            self._conn.close()
        except OSError:
            pass
        self._conn = None
