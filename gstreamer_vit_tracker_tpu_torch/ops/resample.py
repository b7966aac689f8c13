"""Crop / resize as matrix multiplication.

Bilinear resampling is a separable linear map, so a crop+resize is exactly
``out = R @ img @ C^T`` where ``R`` (out_h, src_h) and ``C`` (out_w, src_w)
hold the bilinear hat weights of each output row/column against the source
grid.  Out-of-window samples get zero weight, which reproduces
zero-border-constant padding.  Sampling uses half-pixel-centre alignment
(``s_i = start + (i+0.5)*scale - 0.5``), as ``cv2.resize`` does.

Port of ``gstreamer_vit_tracker_tpu/ops/resample.py``: the sampling
matrices the tracking step uses, ``crop_resize`` and its channel-first
form ``crop_resize_chw``, and the full-frame ``resize_static`` of the app's
display upscale, compiled as JAX jits it (``resize_static_jit``,
``utils/graph.py``).
"""

from __future__ import annotations

import torch

from ..utils import graph

__all__ = ["sampling_matrix", "fold_half_res", "crop_resize",
           "crop_resize_chw", "resize_static", "resize_static_jit"]


def sampling_matrix(out_size: int, src_size: int, start, scale,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """The (out_size, src_size) bilinear sampling matrix.

    ``start`` (source coordinate of the window origin, px) and ``scale``
    (source px per output px) may be tensors, so no value leaves the
    device; with leading batch dimensions (one window per stream and
    object) the result is (..., out_size, src_size).  Weights are built in
    float32 and then cast to ``dtype``.
    """
    if isinstance(start, torch.Tensor):
        device = start.device
    f32 = torch.float32
    i = torch.arange(out_size, dtype=f32, device=device).unsqueeze(1)
    j = torch.arange(src_size, dtype=f32, device=device).unsqueeze(0)
    start = torch.as_tensor(start, dtype=f32, device=device)
    scale = torch.as_tensor(scale, dtype=f32, device=device)
    s = start[..., None, None] + (i + 0.5) * scale[..., None, None] - 0.5
    w = torch.clamp_min(1.0 - torch.abs(s - j), 0.0)
    return w.to(dtype)


def fold_half_res(m: torch.Tensor) -> torch.Tensor:
    """Fold a full-resolution sampling matrix to act on a 2x-subsampled
    plane under block-replicate upsampling: ``M'[i, j] = M[i, 2j] +
    M[i, 2j+1]``, so NV12 chroma is resampled at half resolution with no
    explicit upsample.  Requires an even source size; leading batch
    dimensions pass through."""
    src = m.shape[-1]
    if src % 2:
        raise ValueError(f"fold_half_res requires an even source size, got {src}")
    return m.reshape(*m.shape[:-1], src // 2, 2).sum(dim=-1)


def _scalar(v, dev: torch.device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``dev``: a number is filled in on the
    device (a fill, not a host-to-device copy, which no CUDA graph can
    capture), the value ``torch.as_tensor`` would give."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(v), dtype=torch.float32, device=dev)


def crop_resize(img: torch.Tensor, start_yx, size_yx, out_hw,
                dtype=torch.float32) -> torch.Tensor:
    """Crop the window ``[start, start+size)`` of ``img`` (H, W) or
    (H, W, C), any numeric dtype, and resize it to ``out_hw`` with bilinear
    filtering and zero padding: ``R @ img @ C^T`` in ``dtype``, the
    channels riding along.  Returns (out_h, out_w[, C])."""
    out_h, out_w = out_hw
    h, w = img.shape[0], img.shape[1]
    sy, sx = start_yx
    zy, zx = size_yx
    dev = img.device
    ry = sampling_matrix(out_h, h, _scalar(sy, dev),
                         _scalar(float(zy) / out_h, dev), dtype, dev)
    cx = sampling_matrix(out_w, w, _scalar(sx, dev),
                         _scalar(float(zx) / out_w, dev), dtype, dev)
    imgf = img.to(dtype)
    if img.dim() == 2:
        return ry @ imgf @ cx.T
    tmp = torch.einsum("oh,hwc->owc", ry, imgf)
    return torch.einsum("pw,owc->opc", cx, tmp)


def crop_resize_chw(img_chw: torch.Tensor, start_yx, size_yx, out_hw,
                    dtype=torch.float32) -> torch.Tensor:
    """:func:`crop_resize` for a channel-first (C, H, W) image: returns
    (C, out_h, out_w).  The scales are float32 quotients, as in JAX."""
    out_h, out_w = out_hw
    _, h, w = img_chw.shape
    sy, sx = start_yx
    zy, zx = size_yx
    dev = img_chw.device
    f32 = torch.float32
    ry = sampling_matrix(out_h, h, sy, torch.as_tensor(zy, dtype=f32,
                                                       device=dev) / out_h,
                         dtype, dev)
    cx = sampling_matrix(out_w, w, sx, torch.as_tensor(zx, dtype=f32,
                                                       device=dev) / out_w,
                         dtype, dev)
    tmp = torch.einsum("oh,chw->cow", ry, img_chw.to(dtype))
    return torch.einsum("pw,cow->cop", cx, tmp)


def resize_static(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Full-frame uint8 resize to (out_h, out_w): the reference's RGA
    display upscale (640x512 -> 1280x1024, pipeline_ir.rs:62-73), a float32
    bilinear resample rounded half to even and clamped."""
    h, w = img.shape[0], img.shape[1]
    out = crop_resize(img, (0.0, 0.0), (float(h), float(w)), (out_h, out_w))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _resize_static(img: torch.Tensor, out_h: int, out_w: int,
                   device) -> torch.Tensor:
    return resize_static(img, out_h, out_w)


# (img, out_h, out_w, device): JAX's jitted resize_static.
resize_static_jit = graph.Compiled(_resize_static, "resample.resize_static_jit",
                                   static=("out_h", "out_w"))
