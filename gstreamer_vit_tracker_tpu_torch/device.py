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
