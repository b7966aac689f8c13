"""Fused NV12 crop + resize + colorspace + normalise.

Port of the NV12 path of ``gstreamer_vit_tracker_tpu/ops/preprocess.py``:
chroma-folded bilinear window resampling as matrix products, BT.601
conversion, and model normalisation, over the device-resident frame.  Only
the pixels the sampling matrices touch are converted; no full-frame RGB
image exists.  Window geometry stays in 0-d tensors, so nothing is read
back to the host.

Crop geometry follows the OSTrack/VitTrack convention: a square window of
side ``ceil(factor * sqrt(w*h))`` centred on the target, zero-padded where
it leaves the frame, resized to the model input size.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .colorspace import rgb_from_shifted_yuv
from .resample import fold_half_res, sampling_matrix

__all__ = ["CropWindow", "crop_window", "normalize", "band_origin",
           "preprocess_nv12"]


class CropWindow(NamedTuple):
    """Square sampling window in source-frame pixels (float32; 0-d, or
    with the leading batch dimensions of the boxes it was made from)."""

    cx: torch.Tensor      # window centre x
    cy: torch.Tensor      # window centre y
    size: torch.Tensor    # window side length (source px)


def crop_window(bbox: torch.Tensor, factor) -> CropWindow:
    """Window around ``bbox`` = (..., 4) (x, y, w, h) with ``factor`` x
    context.

    ``side = ceil(factor * sqrt(w * h))``, floored at 2; w and h are
    floored at 1 px so a degenerate box still yields a valid window.
    """
    x, y, w, h = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    w = torch.clamp_min(w, 1.0)
    h = torch.clamp_min(h, 1.0)
    cx = x + 0.5 * w
    cy = y + 0.5 * h
    size = torch.ceil(factor * torch.sqrt(w * h))
    return CropWindow(cx=cx, cy=cy, size=torch.clamp_min(size, 2.0))


@functools.lru_cache(maxsize=None)
def _channel_constant(values: Tuple[float, ...], dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    # Made once per (values, dtype, device): a fresh host-to-device copy on
    # every step would cost a transfer for three numbers.
    return torch.tensor(values, dtype=dtype, device=device)


def normalize(rgb01: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """Channel-wise ``(x - mean) / std`` on a (..., 3) image in [0, 1];
    mean and std are rounded to the image's dtype first, as in JAX."""
    m = _channel_constant(tuple(mean), rgb01.dtype, rgb01.device)
    s = _channel_constant(tuple(std), rgb01.dtype, rgb01.device)
    return (rgb01 - m) / s


def band_origin(window: CropWindow, frame_h: int, frame_w: int,
                band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-left corner (row0, col0) of a static ``band`` x ``band`` region
    centred on the crop window, clamped inside the frame and snapped to
    even coordinates (NV12 chroma alignment).  0-d int32 tensors."""
    def origin(centre, limit):
        o = torch.round(centre - band / 2).to(torch.int32)
        o = torch.clamp(o, 0, max(limit - band, 0))
        return torch.div(o, 2, rounding_mode="floor") * 2

    return origin(window.cy, frame_h), origin(window.cx, frame_w)


def _resample(r: torch.Tensor, plane: torch.Tensor, c: torch.Tensor
              ) -> torch.Tensor:
    """``(R @ P) @ C^T``, rounded to the planes' dtype between the two.

    ``r`` and ``c`` carry the windows' leading dimensions, ``plane`` the
    first of them (the frame's).  Window dimensions beyond the frame's fold
    into the rows of the first product, so the objects of one stream share
    the stream's frame instead of each getting a copy of it."""
    lead, (out, src) = r.shape[:-2], r.shape[-2:]
    rows = r.reshape(*plane.shape[:-2], -1, src)
    t = (rows @ plane).reshape(*lead, out, plane.shape[-1])
    return t @ c.transpose(-1, -2)


def preprocess_nv12(y_plane: torch.Tensor, uv_plane: torch.Tensor,
                    window: CropWindow, out_size: int,
                    mean: Sequence[float], std: Sequence[float],
                    dtype=torch.float32,
                    band: Optional[int] = None) -> torch.Tensor:
    """NV12 planes -> normalised (out_size, out_size, 3) RGB model crop.

    ``y_plane``: (H, W) uint8; ``uv_plane``: (H//2, W//2, 2) uint8 with
    channel 0 = U, 1 = V.  Batched: the window's leaves carry leading
    dimensions (streams, objects), the planes the first of them (one frame
    per stream, shared by its objects), and the crop comes out as
    (..., out_size, out_size, 3); the band is for the unbatched call only.
    Luma is resampled at full resolution, chroma at
    half resolution through the pair-folded matrices.  The black-level
    offsets are subtracted before resampling so the zero-weight padding
    decodes to black.  With ``band``, a static window-centred region is
    gathered first so the products cost the band, not the frame.  The
    products are left-associated, ``(R @ P) @ C^T``, rounded to ``dtype``
    between the two, as in JAX.
    """
    h, w = y_plane.shape[-2:]
    lead = window.size.shape
    if y_plane.shape[:-2] != lead[:y_plane.dim() - 2]:
        raise ValueError(f"frame batch {tuple(y_plane.shape[:-2])} is not the "
                         f"head of the window batch {tuple(lead)}")
    start_y = window.cy - 0.5 * window.size
    start_x = window.cx - 0.5 * window.size
    if band is not None and (h > band or w > band):
        if lead:
            raise ValueError("the banded preprocess takes one window; "
                             "batched callers run with preprocess_band=None")
        bh, bw = min(band, h), min(band, w)
        row0, col0 = band_origin(window, h, w, band)
        dev = y_plane.device
        rows = row0 + torch.arange(bh, device=dev, dtype=torch.int32)
        cols = col0 + torch.arange(bw, device=dev, dtype=torch.int32)
        # Index gathers, not slices: the origin stays on the device.
        y_plane = y_plane[rows[:, None], cols[None, :]]
        rows2 = torch.div(row0, 2, rounding_mode="floor") + torch.arange(
            bh // 2, device=dev, dtype=torch.int32)
        cols2 = torch.div(col0, 2, rounding_mode="floor") + torch.arange(
            bw // 2, device=dev, dtype=torch.int32)
        uv_plane = uv_plane[rows2[:, None], cols2[None, :]]
        start_y = start_y - row0.to(torch.float32)
        start_x = start_x - col0.to(torch.float32)
        h, w = bh, bw

    scale = window.size / out_size
    ry = sampling_matrix(out_size, h, start_y, scale, dtype)
    cxm = sampling_matrix(out_size, w, start_x, scale, dtype)
    ry_uv = fold_half_res(ry)
    cx_uv = fold_half_res(cxm)

    yc = _resample(ry, y_plane.to(dtype) - 16.0, cxm)
    uc = _resample(ry_uv, uv_plane[..., 0].to(dtype) - 128.0, cx_uv)
    vc = _resample(ry_uv, uv_plane[..., 1].to(dtype) - 128.0, cx_uv)

    rgb = rgb_from_shifted_yuv(yc, uc, vc)
    rgb = torch.clamp(rgb, 0.0, 255.0)
    return normalize(rgb / 255.0, mean, std)
