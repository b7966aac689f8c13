"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout, then loaded with ``ctypes``.  The hash covers the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built or loaded at import time: only a caller that launches a
kernel on the card, or ``chip_smoke.py``, builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

# Every kernel source of the port; chip_smoke.py builds them all at once.
SOURCES = ("vit_encoder", "attention", "fused_prep_embed")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once.  Returns {name: seconds}; raises with the
    compiler's output if any build fails.  ``ptxas`` register and
    shared-memory reports go to ``<library>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():   # every nvcc waited for
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(f"{out}.log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
