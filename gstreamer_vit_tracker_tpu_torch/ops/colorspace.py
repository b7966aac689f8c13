"""BT.601 limited-range YUV -> RGB.

Port of ``gstreamer_vit_tracker_tpu/ops/colorspace.py``: the exact
integer conversion of whole NV12 and YUY2 frames (nv12_convert.rs:8-43,
107-168; the app's HUD draws on YUY2 frames, ``runtime`` falls back to
these without a toolchain) and the float-space conversion the preprocess
uses.  ``yuy2_to_rgb_jit`` is JAX's jitted ``yuy2_to_rgb`` as the app
calls it: one compiled program (``utils/graph.py``) a frame size.
"""

from __future__ import annotations

import torch

from ..utils import graph

__all__ = ["BT601_COEFFS", "nv12_planes_to_rgb", "nv12_to_rgb",
           "rgb_from_shifted_yuv", "rgb_from_shifted_yuv_f32",
           "rgb_from_yuv_f32", "round_scalar", "yuy2_to_rgb",
           "yuy2_to_rgb_jit"]

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


# JAX's name: on float32 planes the coefficients round to float32, which is
# JAX's weak-typed product.
rgb_from_shifted_yuv_f32 = rgb_from_shifted_yuv


def rgb_from_yuv_f32(y: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Float-space BT.601 conversion of unshifted planes (no rounding or
    clamp), stacked RGB on the last axis."""
    return rgb_from_shifted_yuv(y - 16.0, u - 128.0, v - 128.0)


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


def _yuy2_to_rgb(yuy2: torch.Tensor, width: int, height: int,
                 device) -> torch.Tensor:
    return yuy2_to_rgb(yuy2, width=width, height=height)


# (yuy2 buffer, width, height, device): a host buffer is copied in.
yuy2_to_rgb_jit = graph.Compiled(_yuy2_to_rgb, "colorspace.yuy2_to_rgb_jit",
                                 static=("width", "height"))


def _upsample2(plane: torch.Tensor) -> torch.Tensor:
    """Block-replicate a half-resolution chroma plane to full size, int32."""
    return plane.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1).to(
        torch.int32)


def nv12_to_rgb(nv12, *, width: int, height: int) -> torch.Tensor:
    """A flat NV12 buffer (Y plane of height*width bytes, then the
    interleaved UV plane) to a uint8 (height, width, 3) RGB frame, on the
    buffer's device.

    As in the reference: a buffer shorter than ``width*height*3//2`` gives a
    zero image (nv12_convert.rs:48-50); pixel (r, c) reads U at UV offset
    ``(r//2)*width + (c//2)*2`` and V at the next byte (nv12_convert.rs:
    111-113), which is defined for odd sizes too.  There the reads past the
    buffer's end are clamped to its last byte, as JAX's gather clamps."""
    buf = torch.as_tensor(nv12)
    y_size = width * height
    if buf.shape[0] < y_size * 3 // 2:
        return torch.zeros((height, width, 3), dtype=torch.uint8,
                           device=buf.device)
    y = buf[:y_size].reshape(height, width).to(torch.int32)
    if width % 2 == 0 and height % 2 == 0:
        uv = buf[y_size:y_size + y_size // 2].reshape(height // 2,
                                                      width // 2, 2)
        return _convert_i32(y, _upsample2(uv[..., 0]), _upsample2(uv[..., 1]))
    uv = buf[y_size:]
    rows = torch.arange(height, device=buf.device)[:, None]
    cols = torch.arange(width, device=buf.device)[None, :]
    base = (rows // 2) * width + (cols // 2) * 2
    last = uv.shape[0] - 1
    u = uv[torch.clamp(base, max=last)].to(torch.int32)
    v = uv[torch.clamp(base + 1, max=last)].to(torch.int32)
    return _convert_i32(y, u, v)


def nv12_planes_to_rgb(y_plane: torch.Tensor,
                       uv_plane: torch.Tensor) -> torch.Tensor:
    """Planar NV12: ``y_plane`` (H, W) uint8 and ``uv_plane`` (H//2, W//2,
    2) uint8 (channel 0 = U, 1 = V), even sizes only, to uint8 (H, W, 3)."""
    return _convert_i32(y_plane.to(torch.int32), _upsample2(uv_plane[..., 0]),
                        _upsample2(uv_plane[..., 1]))
