"""Real V4L2 capture: ioctl-based format negotiation + mmap streaming I/O.

The reference's active pipeline negotiates YUY2 640x512@60 from
``/dev/video21`` with dmabuf io-mode through GStreamer's v4l2src
(reference pipeline_ir.rs:21-41, main.rs:32).  This module is the
framework's own minimal V4L2 stack — no GStreamer, no external libraries:
``VIDIOC_S_FMT`` (pixel-format negotiation), ``VIDIOC_S_PARM`` (frame
rate), ``VIDIOC_REQBUFS``/``VIDIOC_QUERYBUF`` + ``mmap`` (kernel-allocated
streaming buffers — the closest userspace analog of the dmabuf path),
``VIDIOC_STREAMON`` and the QBUF/DQBUF ring.

Struct layouts and ioctl codes follow linux/videodev2.h for 64-bit
platforms; they are pinned against the known x86_64 constants in
tests/test_v4l2.py (struct-size errors silently corrupt every field after
the mismatch, so the sizes ARE the contract).
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap as mmap_mod
import os
import select
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["V4L2Capture", "fourcc", "VIDIOC_S_FMT", "VIDIOC_REQBUFS",
           "VIDIOC_QUERYBUF", "VIDIOC_QBUF", "VIDIOC_DQBUF",
           "VIDIOC_STREAMON", "VIDIOC_STREAMOFF", "VIDIOC_S_PARM"]


def fourcc(code: str) -> int:
    """V4L2 FOURCC: little-endian packed 4 chars ('YUYV' = 0x56595559)."""
    a, b, c, d = (ord(ch) for ch in code)
    return a | (b << 8) | (c << 16) | (d << 24)


PIX_FMT_YUYV = fourcc("YUYV")
PIX_FMT_NV12 = fourcc("NV12")
PIX_FMT_MJPEG = fourcc("MJPG")   # compressed mode most USB cams need >30fps

# linux/videodev2.h enums
BUF_TYPE_VIDEO_CAPTURE = 1
FIELD_NONE = 1
MEMORY_MMAP = 1


# ---------------------------------------------------------------------------
# ioctl number construction (asm-generic/ioctl.h)
# ---------------------------------------------------------------------------

_IOC_WRITE = 1
_IOC_READ = 2


def _ioc(dirs: int, typ: str, nr: int, size: int) -> int:
    return (dirs << 30) | (size << 16) | (ord(typ) << 8) | nr


def _iowr(typ: str, nr: int, struct_type) -> int:
    return _ioc(_IOC_READ | _IOC_WRITE, typ, nr, ctypes.sizeof(struct_type))


def _iow(typ: str, nr: int, struct_type) -> int:
    return _ioc(_IOC_WRITE, typ, nr, ctypes.sizeof(struct_type))


# ---------------------------------------------------------------------------
# Structures (64-bit layouts)
# ---------------------------------------------------------------------------

class v4l2_pix_format(ctypes.Structure):
    _fields_ = [("width", ctypes.c_uint32),
                ("height", ctypes.c_uint32),
                ("pixelformat", ctypes.c_uint32),
                ("field", ctypes.c_uint32),
                ("bytesperline", ctypes.c_uint32),
                ("sizeimage", ctypes.c_uint32),
                ("colorspace", ctypes.c_uint32),
                ("priv", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("ycbcr_enc", ctypes.c_uint32),
                ("quantization", ctypes.c_uint32),
                ("xfer_func", ctypes.c_uint32)]


class _fmt_union(ctypes.Union):
    # The kernel union is padded to 200 bytes (raw_data) and 8-byte aligned
    # (v4l2_window holds pointers).
    _fields_ = [("pix", v4l2_pix_format),
                ("raw_data", ctypes.c_uint8 * 200),
                ("_align", ctypes.c_uint64)]


class v4l2_format(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32),
                ("fmt", _fmt_union)]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [("count", ctypes.c_uint32),
                ("type", ctypes.c_uint32),
                ("memory", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("flags", ctypes.c_uint8),
                ("reserved", ctypes.c_uint8 * 3)]


class v4l2_timecode(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("frames", ctypes.c_uint8),
                ("seconds", ctypes.c_uint8),
                ("minutes", ctypes.c_uint8),
                ("hours", ctypes.c_uint8),
                ("userbits", ctypes.c_uint8 * 4)]


class _timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long),
                ("tv_usec", ctypes.c_long)]


class _buffer_m_union(ctypes.Union):
    _fields_ = [("offset", ctypes.c_uint32),
                ("userptr", ctypes.c_ulong),
                ("planes", ctypes.c_void_p),
                ("fd", ctypes.c_int32)]


class v4l2_buffer(ctypes.Structure):
    _fields_ = [("index", ctypes.c_uint32),
                ("type", ctypes.c_uint32),
                ("bytesused", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("field", ctypes.c_uint32),
                ("timestamp", _timeval),
                ("timecode", v4l2_timecode),
                ("sequence", ctypes.c_uint32),
                ("memory", ctypes.c_uint32),
                ("m", _buffer_m_union),
                ("length", ctypes.c_uint32),
                ("reserved2", ctypes.c_uint32),
                ("request_fd", ctypes.c_int32)]


class v4l2_fract(ctypes.Structure):
    _fields_ = [("numerator", ctypes.c_uint32),
                ("denominator", ctypes.c_uint32)]


class v4l2_captureparm(ctypes.Structure):
    _fields_ = [("capability", ctypes.c_uint32),
                ("capturemode", ctypes.c_uint32),
                ("timeperframe", v4l2_fract),
                ("extendedmode", ctypes.c_uint32),
                ("readbuffers", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 4)]


class _parm_union(ctypes.Union):
    _fields_ = [("capture", v4l2_captureparm),
                ("raw_data", ctypes.c_uint8 * 200)]


class v4l2_streamparm(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32),
                ("parm", _parm_union)]


VIDIOC_S_FMT = _iowr("V", 5, v4l2_format)
VIDIOC_REQBUFS = _iowr("V", 8, v4l2_requestbuffers)
VIDIOC_QUERYBUF = _iowr("V", 9, v4l2_buffer)
VIDIOC_QBUF = _iowr("V", 15, v4l2_buffer)
VIDIOC_DQBUF = _iowr("V", 17, v4l2_buffer)
VIDIOC_STREAMON = _iow("V", 18, ctypes.c_int)
VIDIOC_STREAMOFF = _iow("V", 19, ctypes.c_int)
VIDIOC_S_PARM = _iowr("V", 22, v4l2_streamparm)


class V4L2Capture:
    """mmap-streaming V4L2 capture device.

    Usage::

        cap = V4L2Capture("/dev/video21", 640, 512, fps=60)
        cap.start()                       # S_FMT + S_PARM + REQBUFS + QBUF + STREAMON
        data = cap.read_frame()           # blocking DQBUF -> bytes -> QBUF
        cap.stop()

    Negotiates the reference's caps: YUY2 ``width x height @ fps``
    (pipeline_ir.rs:27-41); ``n_buffers`` mirrors the queue depth 3-ish
    buffering (pipeline_ir.rs:75-78).
    """

    def __init__(self, device: str, width: int, height: int, fps: int = 60,
                 pixelformat: int = PIX_FMT_YUYV, n_buffers: int = 4):
        self.device = device
        self.width = width
        self.height = height
        self.fps = fps
        self.pixelformat = pixelformat
        self.n_buffers = n_buffers
        self.sizeimage = 0
        self._fd: Optional[int] = None
        self._maps: List[Tuple[mmap_mod.mmap, int]] = []
        self._streaming = False

    # -- negotiation -------------------------------------------------------

    def _ioctl(self, code: int, arg) -> None:
        fcntl.ioctl(self._fd, code, arg)

    def negotiate(self) -> Tuple[int, int, int]:
        """VIDIOC_S_FMT; the camera may adjust — returns the ACTUAL
        (width, height, sizeimage) and updates self to match (the kernel
        contract: S_FMT writes the negotiated values back)."""
        f = v4l2_format()
        f.type = BUF_TYPE_VIDEO_CAPTURE
        f.fmt.pix.width = self.width
        f.fmt.pix.height = self.height
        f.fmt.pix.pixelformat = self.pixelformat
        f.fmt.pix.field = FIELD_NONE
        self._ioctl(VIDIOC_S_FMT, f)
        if f.fmt.pix.pixelformat != self.pixelformat:
            raise RuntimeError(
                f"the camera refused pixelformat {self.pixelformat:#x}, "
                f"offered {f.fmt.pix.pixelformat:#x}")
        self.width = f.fmt.pix.width
        self.height = f.fmt.pix.height
        self.sizeimage = f.fmt.pix.sizeimage
        return self.width, self.height, self.sizeimage

    def _set_fps(self) -> None:
        p = v4l2_streamparm()
        p.type = BUF_TYPE_VIDEO_CAPTURE
        p.parm.capture.timeperframe.numerator = 1
        p.parm.capture.timeperframe.denominator = self.fps
        try:
            self._ioctl(VIDIOC_S_PARM, p)
        except OSError:
            pass  # fixed-rate sensors reject S_PARM; keep their rate

    # -- streaming ---------------------------------------------------------

    def start(self) -> None:
        self._fd = os.open(self.device, os.O_RDWR | os.O_NONBLOCK)
        self.negotiate()
        self._set_fps()

        req = v4l2_requestbuffers()
        req.count = self.n_buffers
        req.type = BUF_TYPE_VIDEO_CAPTURE
        req.memory = MEMORY_MMAP
        self._ioctl(VIDIOC_REQBUFS, req)
        if req.count < 2:
            raise RuntimeError("insufficient V4L2 buffer memory")

        for i in range(req.count):
            buf = v4l2_buffer()
            buf.index = i
            buf.type = BUF_TYPE_VIDEO_CAPTURE
            buf.memory = MEMORY_MMAP
            self._ioctl(VIDIOC_QUERYBUF, buf)
            m = mmap_mod.mmap(self._fd, buf.length,
                              flags=mmap_mod.MAP_SHARED,
                              prot=mmap_mod.PROT_READ | mmap_mod.PROT_WRITE,
                              offset=buf.m.offset)
            self._maps.append((m, buf.length))
            self._ioctl(VIDIOC_QBUF, buf)

        typ = ctypes.c_int(BUF_TYPE_VIDEO_CAPTURE)
        self._ioctl(VIDIOC_STREAMON, typ)
        self._streaming = True

    def read_frame(self, timeout: float = 2.0) -> np.ndarray:
        """Blocking DQBUF -> copy -> QBUF.  Returns the packed frame bytes
        as (sizeimage,) uint8 (YUY2: reshape to (H, W*2))."""
        if not self._streaming:
            raise RuntimeError("start() first")
        r, _, _ = select.select([self._fd], [], [], timeout)
        if not r:
            raise TimeoutError(f"no frame within {timeout}s")
        buf = v4l2_buffer()
        buf.type = BUF_TYPE_VIDEO_CAPTURE
        buf.memory = MEMORY_MMAP
        self._ioctl(VIDIOC_DQBUF, buf)
        m, length = self._maps[buf.index]
        n = buf.bytesused or length
        data = np.frombuffer(m, dtype=np.uint8, count=n).copy()
        self._ioctl(VIDIOC_QBUF, buf)
        return data

    def stop(self) -> None:
        if self._fd is None:
            return
        if self._streaming:
            try:
                self._ioctl(VIDIOC_STREAMOFF,
                            ctypes.c_int(BUF_TYPE_VIDEO_CAPTURE))
            except OSError:
                pass
            self._streaming = False
        for m, _ in self._maps:
            m.close()
        self._maps.clear()
        os.close(self._fd)
        self._fd = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
