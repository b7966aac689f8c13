"""Fused crop + resize + colorspace + normalise for RGB, NV12 and YUY2
frames.

Port of ``gstreamer_vit_tracker_tpu/ops/preprocess.py``: bilinear window
resampling as matrix products (chroma through folded matrices), BT.601
conversion, and model normalisation, over the device-resident frame.  Only
the pixels the sampling matrices touch are converted; no full-frame RGB
image exists for the YUV formats.  Window geometry stays in 0-d tensors, so
nothing is read back to the host.

``patch_major=p`` makes each of the three emit the crop as patch pixels
(p, N, p*3) in ViT patch-embed order: the ROW sampling matrix is generated
with its rows permuted to patch-major order r = p * g + gh, so the products
emit the crop as (p, gh, x, c), which reshapes with no relayout; the
values are those of the raster crop (``models/vit.py::embed_search_patches``
consumes them).

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
           "preprocess_rgb", "preprocess_nv12", "preprocess_yuy2"]


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


def _patch_row_perm(m: torch.Tensor, patch: int) -> torch.Tensor:
    """Permute a (..., out, src) sampling matrix's output rows from raster
    order y = gh * patch + p to patch-major order r = p * (out // patch) +
    gh."""
    out, src = m.shape[-2:]
    g = out // patch
    return m.reshape(*m.shape[:-2], g, patch, src).transpose(-3, -2).reshape(
        m.shape)


def _to_patches(crop: torch.Tensor, patch: int) -> torch.Tensor:
    """(..., out, out, 3) crop whose rows are patch-major -> (..., patch, N,
    patch * 3) patch pixels, one contiguous reshape."""
    out = crop.shape[-2]
    g = out // patch
    return crop.reshape(*crop.shape[:-3], patch, g * g, patch * 3)


def _rows_product(r: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """``R @ P`` for row matrices ``r`` (..., out, src) that carry the
    windows' leading dimensions and a plane (..., src, width) that carries
    the first of them (the frame's).  Window dimensions beyond the frame's
    fold into the rows of the product, so the objects of one stream share
    the stream's frame instead of each getting a copy of it."""
    lead, (out, src) = r.shape[:-2], r.shape[-2:]
    rows = r.reshape(*plane.shape[:-2], -1, src)
    return (rows @ plane).reshape(*lead, out, plane.shape[-1])


def _resample(r: torch.Tensor, plane: torch.Tensor, c: torch.Tensor
              ) -> torch.Tensor:
    """``(R @ P) @ C^T``, rounded to the planes' dtype between the two."""
    return _rows_product(r, plane) @ c.transpose(-1, -2)


def _check_lead(plane_lead, lead) -> None:
    if tuple(plane_lead) != tuple(lead[:len(plane_lead)]):
        raise ValueError(f"frame batch {tuple(plane_lead)} is not the head "
                         f"of the window batch {tuple(lead)}")


def _band_index(window: CropWindow, h: int, w: int, band: Optional[int]):
    """For a frame larger than ``band``: the band's row and column indices
    (int32 tensors on the window's device, so the origin never leaves it)
    and its origin; ``None`` when the frame fits the band or there is
    none."""
    if band is None or not (h > band or w > band):
        return None
    if window.size.dim():
        raise ValueError("the banded preprocess takes one window; "
                         "batched callers run with preprocess_band=None")
    row0, col0 = band_origin(window, h, w, band)
    dev = window.size.device
    rows = row0 + torch.arange(min(band, h), device=dev, dtype=torch.int32)
    cols = col0 + torch.arange(min(band, w), device=dev, dtype=torch.int32)
    return rows, cols, row0, col0


def _finish(rgb01: torch.Tensor, mean, std,
            patch_major: Optional[int]) -> torch.Tensor:
    out = normalize(rgb01, mean, std)
    return _to_patches(out, patch_major) if patch_major is not None else out


def preprocess_rgb(rgb: torch.Tensor, window: CropWindow, out_size: int,
                   mean: Sequence[float], std: Sequence[float],
                   dtype=torch.float32, band: Optional[int] = None,
                   patch_major: Optional[int] = None) -> torch.Tensor:
    """Crop ``window`` from an (H, W, 3) uint8 RGB frame, resize to
    ``out_size`` square, scale to [0, 1] and normalise: (out_size,
    out_size, 3), or patch pixels with ``patch_major`` (module docstring).
    Batched as :func:`preprocess_nv12`.  Both products come out in
    ``dtype``, so in bf16 the row-resampled intermediate is rounded to bf16,
    as in JAX."""
    h, w = rgb.shape[-3:-1]
    _check_lead(rgb.shape[:-3], window.size.shape)
    start_y = window.cy - 0.5 * window.size
    start_x = window.cx - 0.5 * window.size
    idx = _band_index(window, h, w, band)
    if idx is not None:
        rows, cols, row0, col0 = idx
        rgb = rgb[rows[:, None], cols[None, :]]
        start_y = start_y - row0.to(torch.float32)
        start_x = start_x - col0.to(torch.float32)
        h, w = rgb.shape[:2]
    scale = window.size / out_size
    ry = sampling_matrix(out_size, h, start_y, scale, dtype)
    if patch_major is not None:
        ry = _patch_row_perm(ry, patch_major)
    cx = sampling_matrix(out_size, w, start_x, scale, dtype)
    imgf = rgb.to(dtype)
    tmp = _rows_product(ry, imgf.reshape(*imgf.shape[:-2], w * 3))
    tmp = tmp.reshape(*tmp.shape[:-1], w, 3)
    crop = torch.einsum("...pw,...owc->...opc", cx, tmp)
    return _finish(crop / 255.0, mean, std, patch_major)


def preprocess_nv12(y_plane: torch.Tensor, uv_plane: torch.Tensor,
                    window: CropWindow, out_size: int,
                    mean: Sequence[float], std: Sequence[float],
                    dtype=torch.float32,
                    band: Optional[int] = None,
                    patch_major: Optional[int] = None) -> torch.Tensor:
    """NV12 planes -> normalised (out_size, out_size, 3) RGB model crop
    (patch pixels with ``patch_major``, module docstring).

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
    _check_lead(y_plane.shape[:-2], window.size.shape)
    start_y = window.cy - 0.5 * window.size
    start_x = window.cx - 0.5 * window.size
    idx = _band_index(window, h, w, band)
    if idx is not None:
        rows, cols, row0, col0 = idx
        # Index gathers, not slices: the origin stays on the device.
        y_plane = y_plane[rows[:, None], cols[None, :]]
        h, w = y_plane.shape
        rows2 = torch.div(row0, 2, rounding_mode="floor") + torch.arange(
            h // 2, device=rows.device, dtype=torch.int32)
        cols2 = torch.div(col0, 2, rounding_mode="floor") + torch.arange(
            w // 2, device=rows.device, dtype=torch.int32)
        uv_plane = uv_plane[rows2[:, None], cols2[None, :]]
        start_y = start_y - row0.to(torch.float32)
        start_x = start_x - col0.to(torch.float32)

    scale = window.size / out_size
    ry = sampling_matrix(out_size, h, start_y, scale, dtype)
    if patch_major is not None:
        ry = _patch_row_perm(ry, patch_major)
    cxm = sampling_matrix(out_size, w, start_x, scale, dtype)
    ry_uv = fold_half_res(ry)
    cx_uv = fold_half_res(cxm)

    yc = _resample(ry, y_plane.to(dtype) - 16.0, cxm)
    uc = _resample(ry_uv, uv_plane[..., 0].to(dtype) - 128.0, cx_uv)
    vc = _resample(ry_uv, uv_plane[..., 1].to(dtype) - 128.0, cx_uv)

    rgb = rgb_from_shifted_yuv(yc, uc, vc)
    rgb = torch.clamp(rgb, 0.0, 255.0)
    return _finish(rgb / 255.0, mean, std, patch_major)


def preprocess_yuy2(yuy2: torch.Tensor, window: CropWindow, out_size: int,
                    mean: Sequence[float], std: Sequence[float],
                    dtype=torch.float32, band: Optional[int] = None,
                    patch_major: Optional[int] = None) -> torch.Tensor:
    """YUY2 -> normalised RGB model crop.  ``yuy2`` is the row-major packed
    buffer (H, W*2) uint8 (4:2:2, two pixels per Y0-U-Y1-V quad).  Luma
    resamples at full resolution; chroma (full vertical, half horizontal
    resolution) through the column-folded matrix only.  ``band`` gathers a
    window-centred region first; its origin column is even, so the quad
    phase is kept.  Batched as :func:`preprocess_nv12`."""
    height, width = yuy2.shape[-2], yuy2.shape[-1] // 2
    _check_lead(yuy2.shape[:-2], window.size.shape)
    start_y = window.cy - 0.5 * window.size
    start_x = window.cx - 0.5 * window.size
    idx = _band_index(window, height, width, band)
    if idx is not None:
        rows, cols, row0, col0 = idx
        # One output column = two packed bytes; col0 is even.
        packed = col0 * 2 + torch.arange(2 * cols.shape[0], device=cols.device,
                                         dtype=torch.int32)
        yuy2 = yuy2[rows[:, None], packed[None, :]]
        start_y = start_y - row0.to(torch.float32)
        start_x = start_x - col0.to(torch.float32)
        height, width = yuy2.shape[0], yuy2.shape[1] // 2
    quads = yuy2.reshape(*yuy2.shape[:-2], height, width // 2, 4)
    y_plane = quads[..., 0::2].reshape(*yuy2.shape[:-2], height, width)

    scale = window.size / out_size
    ry = sampling_matrix(out_size, height, start_y, scale, dtype)
    if patch_major is not None:
        ry = _patch_row_perm(ry, patch_major)
    cxm = sampling_matrix(out_size, width, start_x, scale, dtype)
    cx_uv = fold_half_res(cxm)

    yc = _resample(ry, y_plane.to(dtype) - 16.0, cxm)
    uc = _resample(ry, quads[..., 1].to(dtype) - 128.0, cx_uv)
    vc = _resample(ry, quads[..., 3].to(dtype) - 128.0, cx_uv)

    rgb = rgb_from_shifted_yuv(yc, uc, vc)
    rgb = torch.clamp(rgb, 0.0, 255.0)
    return _finish(rgb / 255.0, mean, std, patch_major)
