"""BT.601 limited-range YUV -> RGB.

Port of ``gstreamer_vit_tracker_tpu/ops/colorspace.py``: the float-space
conversion the preprocess uses, and the exact integer conversion of a whole
YUY2 frame that the app's HUD draws on.  ``nv12_to_rgb`` and
``nv12_planes_to_rgb`` are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["BT601_COEFFS", "rgb_from_shifted_yuv", "round_scalar",
           "yuy2_to_rgb"]

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


def _convert_i32(y: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Exact integer BT.601 conversion of int32 (H, W) planes to uint8
    (H, W, 3), nv12_convert.rs:124-126: ``+128 >> 8`` rounding (an
    arithmetic shift on negatives, as Rust's i32 ``>>``) and a clamp."""
    yv = 298 * (y - 16)
    rv = 409 * (v - 128)
    gu = 100 * (u - 128)
    gv = 208 * (v - 128)
    bu = 516 * (u - 128)
    r = (yv + rv + 128) >> 8
    g = (yv - gu - gv + 128) >> 8
    b = (yv + bu + 128) >> 8
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255).to(torch.uint8)


def yuy2_to_rgb(yuy2: torch.Tensor, *, width: int,
                height: int) -> torch.Tensor:
    """A flat YUY2 (YUYV) buffer, two pixels in 4 bytes Y0 U Y1 V, to a
    uint8 (height, width, 3) RGB frame with the NV12 path's integer BT.601
    math.  ``width`` must be even."""
    if width % 2:
        raise ValueError(f"YUY2 requires an even width, got {width}")
    quad = yuy2[:height * width * 2].reshape(height, width // 2, 4).to(
        torch.int32)
    y = quad[..., 0::2].reshape(height, width)
    u = torch.repeat_interleave(quad[..., 1], 2, dim=1)
    v = torch.repeat_interleave(quad[..., 3], 2, dim=1)
    return _convert_i32(y, u, v)
