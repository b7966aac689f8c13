"""Times of the attention kernels by shape of their CTAs.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_attention

``csrc/attention.cu`` takes the CTA shapes (warps, query rows a warp) of its
two kernels as ``-D`` macros.  This script builds it once per candidate
shape (all ``nvcc`` processes at once, into ``build/torch_kernels/shapes``),
checks every build against ``attention_reference`` and prints, for a few
(batch*heads, S, dh) cases, the mean time of 200 launches on CUDA events
beside ``F.scaled_dot_product_attention`` on the same tensors.  The shapes
compiled into the port are the source's defaults.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch
import torch.nn.functional as F

from .ops import cuda_build
from .ops.attention import attention_reference

# (warps, rows a warp) of the single kernel, then of the flash kernel.
SHAPES = ((16, 4, 8, 4), (8, 4, 4, 4), (8, 8, 4, 8), (16, 2, 8, 8),
          (12, 4, 16, 4), (4, 8, 8, 2), (10, 8, 4, 2))
CASES = (("single", 48, 320, 64, torch.bfloat16),
         ("single", 3, 320, 64, torch.bfloat16),
         ("single", 32, 80, 48, torch.float32),
         ("flash", 3, 1088, 64, torch.bfloat16),
         ("flash", 48, 1088, 64, torch.bfloat16),
         ("flash", 3, 1088, 64, torch.float32),
         ("flash", 4, 777, 128, torch.bfloat16))


def _ms(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    out_dir = os.path.join(cuda_build.BUILD_DIR, "shapes")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(cuda_build.CSRC, "attention.cu")
    procs = []
    for sw, sr, fw, fr in SHAPES:
        out = os.path.join(out_dir, f"libattention_{sw}_{sr}_{fw}_{fr}.so")
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-DSINGLE_W={sw}",
               f"-DSINGLE_R={sr}", f"-DFLASH_W={fw}", f"-DFLASH_R={fr}",
               "-o", out, src]
        procs.append(((sw, sr, fw, fr), out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for shape, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for shape {shape}:\n{log}")
        lib = ctypes.CDLL(out)
        for fn in (lib.attention_single_forward, lib.attention_flash_forward):
            fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
        libs[shape] = lib

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for which, bh, s, dh, dtype in CASES:
        gen = torch.Generator().manual_seed(s + dh)
        q, k, v = (torch.randn((bh, s, dh), generator=gen).to(dev, dtype)
                   for _ in range(3))
        ref = attention_reference(q, k, v).float()
        out = torch.empty_like(q)
        sdpa = _ms(lambda: F.scaled_dot_product_attention(q[None], k[None],
                                                          v[None]))
        cells = []
        for shape, lib in libs.items():
            fn = (lib.attention_single_forward if which == "single"
                  else lib.attention_flash_forward)

            def call():
                return fn(int(dtype == torch.bfloat16), bh, s, dh,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), stream)

            wr = shape[:2] if which == "single" else shape[2:]
            if call() != 0:          # this shape's shared memory does not fit
                cells.append(f"{wr}: does not launch")
                continue
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            cells.append(f"{wr}: {_ms(call):.4f} ms, max|d| {err:.1e}")
        print(f"{which} ({bh}, {s}, {dh}) {str(dtype)[6:]} | "
              f"scaled_dot_product_attention {sdpa:.4f} ms | "
              + " | ".join(cells), flush=True)


if __name__ == "__main__":
    main()
