"""Frame sinks: file recording, a null stand-in, and a live MJPEG preview.

The port's own copy of ``gstreamer_vit_tracker_tpu/media/sink.py``.  A frame
may be a tensor on the card: a sink that needs pixels takes them to the host
with :func:`host_pixels`, the MJPEG preview lazily on its handler thread.

The reference displays through DRM/KMS (``kmssink`` with ``sync=false`` on
a leaky queue, reference pipeline_ir.rs:75-84).  Headless accelerator
hosts have no display plane; the equivalents here are a recording sink
(for golden inspection), a null sink that only counts frames, and
:class:`MJPEGSink` — an HTTP ``multipart/x-mixed-replace`` stream any
browser can open, with the same display semantics as the reference's
sink: a slow viewer always sees the newest frame and the processing path
never blocks on display.  All sinks honour the "never block the
processing path" contract.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch


def host_pixels(frame) -> np.ndarray:
    """A frame as a host numpy array: a tensor (on the card or the CPU) is
    copied to the host, an array passes as it is."""
    if isinstance(frame, torch.Tensor):
        return frame.cpu().numpy()
    return np.asarray(frame)


class NullSink:
    """Counts frames; the default headless 'display'."""

    def __init__(self):
        self.frames = 0
        self.last_frame: Optional[np.ndarray] = None

    def write(self, frame: np.ndarray) -> None:
        self.frames += 1
        self.last_frame = frame

    def close(self) -> None:
        pass


def _encode_jpeg(rgb_or_luma: np.ndarray, quality: int) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) luma -> JPEG bytes (cv2 or PIL)."""
    arr = host_pixels(rgb_or_luma).astype(np.uint8, copy=False)
    try:
        import cv2

        bgr = arr[..., ::-1] if arr.ndim == 3 else arr
        ok, buf = cv2.imencode(".jpg", bgr,
                               [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        if ok:
            return buf.tobytes()
    except ImportError:
        pass
    import io

    from PIL import Image

    mode = "RGB" if arr.ndim == 3 else "L"
    out = io.BytesIO()
    Image.fromarray(arr, mode).save(out, "JPEG", quality=quality)
    return out.getvalue()


class MJPEGSink:
    """Live preview: MJPEG over HTTP (``multipart/x-mixed-replace``).

    Display analog of the reference's ``kmssink sync=false`` behind the
    drop-oldest queue (pipeline_ir.rs:75-84): ``write`` only swaps in a
    reference to the newest frame; the device->host fetch and JPEG encode
    happen lazily on the HTTP handler thread, per connected client — so a
    slow (or absent) viewer costs the tracking loop nothing and always
    sees the newest frame when it catches up.

    ``port=0`` binds an ephemeral port (see ``.port``).  Open
    ``http://<host>:<port>/`` in a browser.  Binds loopback by default —
    the stream is an unauthenticated live video feed; pass
    ``host="0.0.0.0"`` (app: ``--preview-host``) to expose it knowingly.
    """

    def __init__(self, port: int = 8080, quality: int = 80,
                 max_fps: float = 60.0, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        # Fail fast (not in a handler thread mid-stream) when no JPEG
        # encoder exists in the environment.
        _encode_jpeg(np.zeros((2, 2, 3), np.uint8), 80)
        self.frames = 0
        self.quality = quality
        self._latest = None          # newest frame (device or host array)
        self._seq = 0                # bumped per write; clients wait on it
        self._closed = False         # close() wakes handlers so they exit
        self._cv = threading.Condition()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # quiet: no per-request stderr spam
                pass

            def do_GET(self):
                if self.path not in ("/", "/stream"):
                    self.send_error(404)
                    return
                # The multipart stream has no Content-Length: it is
                # delimited by connection close.  Without this, HTTP/1.1
                # keep-alive leaves the socket open after do_GET returns
                # (e.g. on close()), so a downstream MJPEGSource never
                # sees FIN and misreads shutdown as a transport fault
                # instead of clean end-of-input.
                self.close_connection = True
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                min_interval = 1.0 / max_fps
                sent_seq = -1
                try:
                    while True:
                        with sink._cv:
                            # A frame must EXIST (not just a seq bump) or
                            # a pre-first-frame client busy-spins; close()
                            # also wakes us so the thread can exit.
                            sink._cv.wait_for(
                                lambda: sink._closed
                                or (sink._latest is not None
                                    and sink._seq != sent_seq),
                                timeout=1.0)
                            frame, seq = sink._latest, sink._seq
                            if sink._closed:
                                return
                        if frame is None or seq == sent_seq:
                            continue
                        sent_seq = seq
                        t0 = time.monotonic()
                        jpg = _encode_jpeg(frame, sink.quality)
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                            + jpg + b"\r\n")
                        dt = time.monotonic() - t0
                        if dt < min_interval:
                            time.sleep(min_interval - dt)
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:       # noqa: BLE001 — e.g. a device
                    # fetch failing during a relay outage must not kill the
                    # handler thread with a silent traceback: log once and
                    # close this client's stream cleanly (the browser
                    # reconnects).
                    print(f"[preview] stream closed: {type(e).__name__}: "
                          f"{e}", flush=True)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def write(self, frame) -> None:
        self.frames += 1
        with self._cv:
            self._latest = frame
            self._seq += 1
            self._cv.notify_all()

    @property
    def last_frame(self):
        return self._latest

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()    # wake handler threads so they return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)


class MultiSink:
    """Fan a frame out to several sinks (e.g. record + live preview)."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def write(self, frame) -> None:
        for s in self.sinks:
            s.write(frame)

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    @property
    def wants_host_pixels(self) -> bool:
        return any(getattr(s, "wants_host_pixels", False) for s in self.sinks)

    @property
    def frames(self) -> int:
        return max((s.frames for s in self.sinks), default=0)


class FileSink:
    """Records frames to a file: ``.y4m`` paths stream YUV4MPEG2 raw video
    frame by frame (playable anywhere: ``ffplay out.y4m``; media/y4m.py),
    ``.mp4/.avi/.mkv/.mov`` stream through cv2's VideoWriter when cv2 is
    importable (MJPG for .avi, mp4v otherwise), anything else collects an
    (N, H, W, 3) uint8 .npy written on close."""

    wants_host_pixels = True   # write() snapshots pixels; callers fetch

    _CV2_EXTS = (".mp4", ".avi", ".mkv", ".mov")

    def __init__(self, path: str, max_frames: int = 10_000,
                 fps: float = 30.0):
        self.path = path
        self.max_frames = max_frames
        self._frames: List[np.ndarray] = []
        self._y4m = None
        self._vw = None
        self._n = 0
        if path.endswith(".y4m"):
            from .y4m import Y4MWriter

            self._y4m = Y4MWriter(path, fps=fps)
        elif path.lower().endswith(self._CV2_EXTS):
            try:
                import cv2
            except ImportError as e:
                raise RuntimeError(
                    f"recording to {path!r} needs OpenCV (cv2) for encode; "
                    "use .y4m for the dependency-free path") from e
            self._cv2 = cv2
            self._fps = fps
            # Writer opens lazily on the first frame (needs dimensions).

    def _open_cv2(self, h: int, w: int):
        cv2 = self._cv2
        fourcc = "MJPG" if self.path.lower().endswith(".avi") else "mp4v"
        vw = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*fourcc),
                             self._fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError(f"cv2 could not open {self.path!r} for "
                               f"writing ({fourcc})")
        return vw

    def write(self, frame: np.ndarray) -> None:
        if self._n >= self.max_frames:
            return
        frame = host_pixels(frame)
        if hasattr(self, "_cv2"):
            if frame.ndim == 2:                  # luma-only: encode gray
                frame = np.repeat(frame[..., None], 3, axis=-1)
            if self._vw is None:
                self._vw = self._open_cv2(*frame.shape[:2])
            self._vw.write(np.ascontiguousarray(frame[..., ::-1]))
            self._n += 1
            return
        if self._y4m is not None:
            if frame.ndim == 2:
                # Luma-only frame (the app's nv12 display path composites
                # the HUD on the Y plane alone, mirroring the reference's
                # luma overlays, drawing.rs): record as grayscale 4:2:0
                # with neutral chroma.
                h, w = frame.shape
                y = frame[:h - h % 2, :w - w % 2]
                uv = np.full((y.shape[0] // 2, y.shape[1] // 2, 2), 128,
                             np.uint8)
                self._y4m.write_nv12(y, uv)
            else:
                self._y4m.write_rgb(frame)
        else:
            self._frames.append(frame)
        self._n += 1

    def close(self) -> None:
        if self._vw is not None:
            self._vw.release()
        elif self._y4m is not None:
            self._y4m.close()
        elif self._frames:
            np.save(self.path, np.stack(self._frames))

    @property
    def frames(self) -> int:
        return self._n
