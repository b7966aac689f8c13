"""YUV4MPEG2 (.y4m) reader/writer — dependency-free raw-video file IO.

The reference consumes live camera video only (reference 
pipeline_ir.rs:21-41); the framework's portable equivalent of "point it at
real footage" is the Y4M container: uncompressed planar YUV with a 1-line
ASCII header, written by ffmpeg/gstreamer everywhere (``ffmpeg -i clip.mp4
out.y4m``).  Reading yields I420 planes converted to the framework's NV12
plane layout, which feeds the fused NV12 preprocess path directly
(ops/preprocess.py) — no host colour conversion.

Format: ``YUV4MPEG2 W<w> H<h> F<num>:<den> [Ip A1:1 C420...]\n`` then per
frame ``FRAME[ params]\n`` + planar Y (h*w), U (h/2*w/2), V (h/2*w/2).
Only 4:2:0 colourspaces are supported (C420, C420jpeg, C420mpeg2,
C420paldv); 4:2:2/4:4:4 files raise with a clear message.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Y4MReader", "Y4MWriter", "write_y4m_rgb"]

_C420 = {"420", "420jpeg", "420mpeg2", "420paldv"}


def _parse_header(line: bytes) -> dict:
    parts = line.decode("ascii", "replace").strip().split(" ")
    if not parts or parts[0] != "YUV4MPEG2":
        raise ValueError("not a YUV4MPEG2 file")
    out = {"fps": 30.0, "colorspace": "420"}
    for tok in parts[1:]:
        if not tok:
            continue
        tag, val = tok[0], tok[1:]
        if tag == "W":
            out["width"] = int(val)
        elif tag == "H":
            out["height"] = int(val)
        elif tag == "F":
            num, den = val.split(":")
            out["fps"] = float(num) / float(den)
        elif tag == "C":
            out["colorspace"] = val
    if "width" not in out or "height" not in out:
        raise ValueError("y4m header missing W/H")
    return out


class Y4MReader:
    """Random-access Y4M reader.

    Frames are indexed once at open (one O(num_frames) walk of seeks —
    no frame data is read until requested), then served per index from the
    open file handle; a 1080p clip is NOT loaded into memory."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        hdr = _parse_header(self._f.readline())
        self.width: int = hdr["width"]
        self.height: int = hdr["height"]
        self.fps: float = hdr["fps"]
        self.colorspace: str = hdr["colorspace"]
        if self.colorspace not in _C420:
            raise ValueError(
                f"unsupported y4m colorspace C{self.colorspace}: only 4:2:0 "
                "is supported (re-encode with `ffmpeg -pix_fmt yuv420p`)")
        if self.width % 2 or self.height % 2:
            raise ValueError("y4m 4:2:0 requires even dimensions")
        self._ysz = self.width * self.height
        self._csz = self._ysz // 4
        self._frame_bytes = self._ysz + 2 * self._csz
        self._offsets: List[int] = []
        size = os.fstat(self._f.fileno()).st_size
        pos = self._f.tell()
        while pos < size:
            self._f.seek(pos)
            marker = self._f.readline()          # b"FRAME...\n"
            if not marker.startswith(b"FRAME"):
                break
            data_at = pos + len(marker)
            if data_at + self._frame_bytes > size:
                break                            # truncated tail frame
            self._offsets.append(data_at)
            pos = data_at + self._frame_bytes
        self.num_frames = len(self._offsets)

    def frame_planes(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """I420 planes (y (H,W), u (H/2,W/2), v (H/2,W/2)) uint8."""
        self._f.seek(self._offsets[i])
        buf = np.frombuffer(self._f.read(self._frame_bytes), np.uint8)
        h2, w2 = self.height // 2, self.width // 2
        y = buf[:self._ysz].reshape(self.height, self.width)
        u = buf[self._ysz:self._ysz + self._csz].reshape(h2, w2)
        v = buf[self._ysz + self._csz:].reshape(h2, w2)
        return y, u, v

    def frame_nv12(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(y (H,W), uv (H/2,W/2,2)) — the framework's NV12 plane layout
        (ops/preprocess.py::preprocess_nv12)."""
        y, u, v = self.frame_planes(i)
        return np.ascontiguousarray(y), np.stack([u, v], axis=-1)

    def close(self) -> None:
        self._f.close()


class Y4MWriter:
    """Streaming Y4M writer (4:2:0).  Frames may be NV12 planes or RGB
    (converted with the same forward BT.601 math as the synthetic sources,
    media/source.py::rgb_to_nv12_planes)."""

    def __init__(self, path: str, width: Optional[int] = None,
                 height: Optional[int] = None, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self.width, self.height = width, height
        self._f = open(path, "wb")
        self._wrote_header = False
        self.frames = 0
        if width is not None and height is not None:
            self._write_header()

    def _write_header(self) -> None:
        if self.width % 2 or self.height % 2:
            raise ValueError("y4m 4:2:0 requires even dimensions")
        num = int(round(self.fps * 1000))
        self._f.write(f"YUV4MPEG2 W{self.width} H{self.height} "
                      f"F{num}:1000 Ip A1:1 C420jpeg\n".encode("ascii"))
        self._wrote_header = True

    def write_nv12(self, y: np.ndarray, uv: np.ndarray) -> None:
        if not self._wrote_header:
            self.height, self.width = y.shape
            self._write_header()
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(y, np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(uv[..., 0], np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(uv[..., 1], np.uint8).tobytes())
        self.frames += 1

    def write_rgb(self, rgb: np.ndarray) -> None:
        from .source import rgb_to_nv12_planes

        rgb = np.asarray(rgb, np.uint8)
        h, w = rgb.shape[:2]
        rgb = rgb[:h - h % 2, :w - w % 2]     # 4:2:0 needs even dims
        self.write_nv12(*rgb_to_nv12_planes(rgb))

    def close(self) -> None:
        self._f.close()


def write_y4m_rgb(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Write an (N, H, W, 3) uint8 RGB stack as a .y4m clip."""
    w = Y4MWriter(path, fps=fps)
    for f in frames:
        w.write_rgb(f)
    w.close()
