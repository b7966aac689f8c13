"""BT.601 limited-range YUV -> RGB in float space.

Port of the float-space half of ``gstreamer_vit_tracker_tpu/ops/colorspace.py``
(the part the fused preprocess uses); the full-frame integer converters
come with a later slice.
"""

from __future__ import annotations

import torch

__all__ = ["BT601_COEFFS", "rgb_from_shifted_yuv", "round_scalar"]

# Float-space BT.601 coefficients: the integer math divided by 256.
# R = 298/256*(Y-16) + 409/256*(V-128), etc.
BT601_COEFFS = {
    "y": 298.0 / 256.0,
    "rv": 409.0 / 256.0,
    "gu": -100.0 / 256.0,
    "gv": -208.0 / 256.0,
    "bu": 516.0 / 256.0,
}


def round_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float.

    JAX rounds a Python scalar to the dtype of the array it meets (weak
    typing), so ``bf16_array * 1.59765625`` multiplies by the bf16 value;
    PyTorch multiplies by the unrounded scalar.  Rounding on the host
    first gives JAX's product, with no device copy."""
    return torch.tensor(value, dtype=dtype).item()


def rgb_from_shifted_yuv(yp: torch.Tensor, up: torch.Tensor,
                         vp: torch.Tensor) -> torch.Tensor:
    """BT.601 conversion of offset-shifted planes (Y-16, U-128, V-128),
    stacked RGB on the last axis.  Offsets are removed before resampling
    so zero-weight padding decodes to black; the conversion of shifted
    planes is linear and commutes with the resample."""
    c = {k: round_scalar(v, yp.dtype) for k, v in BT601_COEFFS.items()}
    yv = c["y"] * yp
    r = yv + c["rv"] * vp
    g = yv + c["gu"] * up + c["gv"] * vp
    b = yv + c["bu"] * up
    return torch.stack([r, g, b], dim=-1)
