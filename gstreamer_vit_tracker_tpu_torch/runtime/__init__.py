"""ctypes bindings to the port's native host runtime
(``runtime/native/framering.cpp``).

Port of ``gstreamer_vit_tracker_tpu/runtime/__init__.py``, with its own copy
of the C++ source.  The library is compiled with ``g++`` at first use into
``build/torch_runtime/libframering-<hash>.so`` at the root of the checkout
(git-ignored; the hash covers the source, the compiler and its flags, so an
edited source is rebuilt and a stale library is never loaded), never beside
the source.  Without a toolchain every converter falls back to the port's
torch op on the CPU (``ops/colorspace.py``), bit-equal to the native code;
``synth_nv12`` and ``NativeFrameRing`` need the library.

The entry points are host code: numpy buffers in and out, no device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native", "framering.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_runtime")
CXX = os.environ.get("CXX") or "g++"
# The Makefile's flags.
CXXFLAGS = ("-O3", "-Wall", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((CXX,) + CXXFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libframering-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> bool:
    """Compile the library unless an up-to-date one is there (``force``:
    compile anyway).  Returns success; the compiler's output of a failed
    build goes to ``<library>.log``."""
    out = library_path()
    if os.path.exists(out) and not force:
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([CXX, *CXXFLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        with open(f"{out}.log", "w") as f:
            f.write(repr(e))
        return False
    if proc.returncode != 0:
        with open(f"{out}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        return False
    os.replace(tmp, out)   # atomic: a reader never sees half a library
    return True


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be
    built or loaded (the converters then take the torch op)."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    try:
        if not build():
            raise OSError("build failed")
        lib = ctypes.CDLL(library_path())
    except OSError:
        _load_failed = True
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.nv12_to_rgb_mt.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                   ctypes.c_int]
    lib.nv12_to_rgb_mt.restype = None
    lib.yuy2_to_rgb_mt.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                   ctypes.c_int]
    lib.yuy2_to_rgb_mt.restype = None
    lib.synth_nv12.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int]
    lib.synth_nv12.restype = None
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.restype = None
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, u8p]
    lib.ring_pop.restype = ctypes.c_uint64
    lib.ring_pop.argtypes = [ctypes.c_void_p, u8p]
    lib.ring_len.restype = ctypes.c_int
    lib.ring_len.argtypes = [ctypes.c_void_p]
    for stat in ("pushed", "dropped", "popped"):
        fn = getattr(lib, f"ring_stat_{stat}")
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _nv12_chroma_reads(width: int, height: int) -> int:
    """Bytes past the Y plane that the native converter reads: one UV row
    of ``width`` bytes per row pair, and one byte more on odd widths."""
    return ((height + 1) // 2) * width + (width % 2)


def nv12_to_rgb(nv12: np.ndarray, width: int, height: int,
                num_threads: int = 8) -> np.ndarray:
    """Native multithreaded BT.601 NV12 -> RGB (uint8 (height, width, 3)),
    bit-exact with the port's op and the reference LUT kernel
    (nv12_convert.rs:46-92), the op's semantics kept at the edges: a buffer
    shorter than ``width*height*3//2`` gives a zero image, and on odd sizes
    the chroma reads past the buffer's end take its last byte (the buffer
    is padded with it before the native call)."""
    nv12 = np.ascontiguousarray(nv12, np.uint8).reshape(-1)
    lib = load()
    if lib is None:
        from ..ops import colorspace

        return colorspace.nv12_to_rgb(torch.from_numpy(nv12), width=width,
                                      height=height).numpy()
    out = np.empty((height, width, 3), np.uint8)
    if nv12.shape[0] < width * height * 3 // 2:
        out.fill(0)
        return out
    need = width * height + _nv12_chroma_reads(width, height)
    if nv12.shape[0] < need:
        nv12 = np.concatenate([nv12, np.full(need - nv12.shape[0], nv12[-1],
                                             np.uint8)])
    lib.nv12_to_rgb_mt(_u8p(nv12), width, height, _u8p(out), num_threads)
    return out


def yuy2_to_rgb(yuy2: np.ndarray, width: int, height: int,
                num_threads: int = 8) -> np.ndarray:
    """Native multithreaded YUY2 -> RGB with the same math; ``width`` even
    and the buffer at least ``width*height*2`` bytes, as the op needs."""
    if width % 2:
        raise ValueError(f"YUY2 requires an even width, got {width}")
    yuy2 = np.ascontiguousarray(yuy2, np.uint8).reshape(-1)
    if yuy2.shape[0] < width * height * 2:
        raise ValueError(f"YUY2 buffer of {yuy2.shape[0]} bytes is short of "
                         f"{width}x{height}x2")
    lib = load()
    if lib is None:
        from ..ops import colorspace

        return colorspace.yuy2_to_rgb(torch.from_numpy(yuy2), width=width,
                                      height=height).numpy()
    out = np.empty((height, width, 3), np.uint8)
    lib.yuy2_to_rgb_mt(_u8p(yuy2), width, height, _u8p(out), num_threads)
    return out


def _need_lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    return lib


def synth_nv12(width: int, height: int, obj_x: int, obj_y: int,
               obj_size: int) -> np.ndarray:
    """Generate one NV12 frame natively (flat buffer, Y then UV)."""
    lib = _need_lib()
    out = np.empty(width * height * 3 // 2, np.uint8)
    lib.synth_nv12(_u8p(out), width, height, obj_x, obj_y, obj_size)
    return out


class NativeFrameRing:
    """Bounded drop-oldest frame ring backed by C++ (FrameQueue semantics:
    the reference's leaky queue, pipeline_ir.rs:75-78)."""

    def __init__(self, capacity: int, slot_bytes: int):
        if capacity < 1 or slot_bytes < 1:
            raise ValueError(f"ring of {capacity} slots of {slot_bytes} "
                             "bytes")
        lib = _need_lib()
        self._lib = lib
        self.slot_bytes = slot_bytes
        self._h = ctypes.c_void_p(lib.ring_create(capacity, slot_bytes))

    def push(self, frame: np.ndarray) -> bool:
        """Returns False if an old frame was dropped (producer never
        blocks)."""
        frame = np.ascontiguousarray(frame.reshape(-1), np.uint8)
        if frame.nbytes != self.slot_bytes:
            raise ValueError(f"frame of {frame.nbytes} bytes for slots of "
                             f"{self.slot_bytes}")
        return self._lib.ring_push(self._h, _u8p(frame)) == 0

    def pop(self) -> Optional[Tuple[int, np.ndarray]]:
        out = np.empty(self.slot_bytes, np.uint8)
        seq = self._lib.ring_pop(self._h, _u8p(out))
        if seq == 0:
            return None
        return int(seq), out

    def __len__(self) -> int:
        return self._lib.ring_len(self._h)

    @property
    def stats(self):
        return {s: int(getattr(self._lib, f"ring_stat_{s}")(self._h))
                for s in ("pushed", "dropped", "popped")}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
