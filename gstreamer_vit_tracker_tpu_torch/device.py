"""Where the port's entry points run.

Every entry point takes ``device`` and defaults to ``"cuda"``: the port is
written for the card, and a caller that wants the CPU (the tests) says so.
A missing card is an error, never a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and no card is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def true_float32(dev: torch.device) -> None:
    """On a CUDA device, turn TF32 off for float32 products and cuDNN
    convolutions (cuDNN's default is on), so that the float32 presets and
    the float32 heads compute in float32 on the card as on the CPU.  A
    process-wide switch: the port's entry points call it once at start."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
