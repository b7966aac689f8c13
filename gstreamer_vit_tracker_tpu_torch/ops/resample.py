"""Crop / resize as matrix multiplication.

Bilinear resampling is a separable linear map, so a crop+resize is exactly
``out = R @ img @ C^T`` where ``R`` (out_h, src_h) and ``C`` (out_w, src_w)
hold the bilinear hat weights of each output row/column against the source
grid.  Out-of-window samples get zero weight, which reproduces
zero-border-constant padding.  Sampling uses half-pixel-centre alignment
(``s_i = start + (i+0.5)*scale - 0.5``), as ``cv2.resize`` does.

Port of ``gstreamer_vit_tracker_tpu/ops/resample.py`` (the two functions
the NV12 tracking step uses).
"""

from __future__ import annotations

import torch

__all__ = ["sampling_matrix", "fold_half_res"]


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
