"""Training losses for the VitTrack heads.

Port of ``gstreamer_vit_tracker_tpu/train/losses.py``: the standard
OSTrack / CenterNet-family losses for centre-score + offset + size heads,

* penalty-reduced focal loss on a gaussian-splatted centre map;
* L1 on the sub-cell offset and the normalised size at the target cell;
* generalised IoU on the decoded box.

Where JAX writes each loss for ONE sample and lifts it with ``vmap``, every
function here takes leading batch dimensions written out and returns one
value per sample (a 0-d tensor for an unbatched call).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["centre_cell", "gaussian_target", "focal_loss", "l1_at_cell",
           "giou_loss", "total_loss"]


def centre_cell(fs: int, cxy_norm: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cy, cx) integer cell containing the normalised centre
    ``cxy_norm`` (..., 2): the ONE rule shared by the focal-target pin and
    the offset / size supervision (a disagreement at a cell boundary would
    train the regression at a cell labelled negative)."""
    cx = torch.clamp(torch.floor(cxy_norm[..., 0] * fs).to(torch.int64),
                     0, fs - 1)
    cy = torch.clamp(torch.floor(cxy_norm[..., 1] * fs).to(torch.int64),
                     0, fs - 1)
    return cy, cx


def _cell_mask(fs: int, cell_yx, device) -> torch.Tensor:
    """(..., fs, fs) bool, True at each sample's cell."""
    cy, cx = cell_yx
    idx = torch.arange(fs, device=device)
    return ((idx[:, None] == cy[..., None, None])
            & (idx[None, :] == cx[..., None, None]))


def gaussian_target(fs: int, cxy_norm: torch.Tensor,
                    sigma_cells: float = 1.0) -> torch.Tensor:
    """(..., fs, fs) gaussian centred at the normalised target centre, with
    the centre CELL pinned to exactly 1.0 (CenterNet convention: the focal
    loss takes ``target == 1`` as the positive; the continuous peak usually
    falls between cells).  The pinned cell is :func:`centre_cell`'s."""
    gx = cxy_norm[..., 0] * fs - 0.5
    gy = cxy_norm[..., 1] * fs - 0.5
    xs = torch.arange(fs, dtype=torch.float32, device=cxy_norm.device)
    dx2 = (xs[None, :] - gx[..., None, None]) ** 2
    dy2 = (xs[:, None] - gy[..., None, None]) ** 2
    t = torch.exp(-(dx2 + dy2) / (2.0 * sigma_cells ** 2))
    pin = _cell_mask(fs, centre_cell(fs, cxy_norm), cxy_norm.device)
    return torch.where(pin, torch.ones_like(t), t)


def focal_loss(score: torch.Tensor, target: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0) -> torch.Tensor:
    """CenterNet penalty-reduced pixel-wise focal loss over the last two
    dimensions.  ``score`` in (0, 1); ``target`` gaussian with 1.0 at the
    centre cell."""
    eps = 1e-6
    score = torch.clamp(score, eps, 1.0 - eps)
    pos = (target > 0.999).to(torch.float32)
    neg = 1.0 - pos
    pos_loss = -pos * ((1.0 - score) ** alpha) * torch.log(score)
    neg_loss = (-neg * ((1.0 - target) ** beta) * (score ** alpha)
                * torch.log(1.0 - score))
    num_pos = torch.clamp_min(pos.sum(dim=(-2, -1)), 1.0)
    return (pos_loss.sum(dim=(-2, -1)) + neg_loss.sum(dim=(-2, -1))) / num_pos


def _at_cell(pred_map: torch.Tensor, cell_yx) -> torch.Tensor:
    """``pred_map[..., cy, cx, :]`` for (..., fs, fs, C) maps and (...,)
    cells."""
    cy, cx = cell_yx
    fs, ch = pred_map.shape[-2:]
    flat = pred_map.reshape(*pred_map.shape[:-3], -1, ch)
    idx = (cy * fs + cx)[..., None, None].expand(*cy.shape, 1, ch)
    return torch.gather(flat, -2, idx).squeeze(-2)


def l1_at_cell(pred_map: torch.Tensor, target_vec: torch.Tensor,
               cell_yx) -> torch.Tensor:
    """L1 between ``pred_map[cy, cx]`` (..., fs, fs, 2) and a (..., 2)
    target."""
    return torch.abs(_at_cell(pred_map, cell_yx) - target_vec).mean(dim=-1)


def _boxes_xyxy(cxywh: torch.Tensor):
    cx, cy, w, h = cxywh.unbind(-1)
    return cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2


def giou_loss(pred_cxywh: torch.Tensor, gt_cxywh: torch.Tensor) -> torch.Tensor:
    """1 - GIoU of (..., 4) (cx, cy, w, h) boxes in normalised
    coordinates."""
    a = _boxes_xyxy(pred_cxywh)
    b = _boxes_xyxy(gt_cxywh)

    def area(x1, y1, x2, y2):
        return torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)

    inter = area(torch.maximum(a[0], b[0]), torch.maximum(a[1], b[1]),
                 torch.minimum(a[2], b[2]), torch.minimum(a[3], b[3]))
    union = area(*a) + area(*b) - inter
    iou = inter / torch.clamp_min(union, 1e-6)
    hull = area(torch.minimum(a[0], b[0]), torch.minimum(a[1], b[1]),
                torch.maximum(a[2], b[2]), torch.maximum(a[3], b[3]))
    giou = iou - (hull - union) / torch.clamp_min(hull, 1e-6)
    return 1.0 - giou


def total_loss(score: torch.Tensor, offset: torch.Tensor, size: torch.Tensor,
               gt_bbox_norm: torch.Tensor,
               visible: Optional[torch.Tensor] = None,
               w_focal: float = 1.0, w_l1: float = 5.0, w_giou: float = 2.0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss, one value per sample.

    ``score`` (..., fs, fs); ``offset`` / ``size`` (..., fs, fs, 2);
    ``gt_bbox_norm`` (..., 4) = (cx, cy, w, h) normalised to the search
    crop.

    ``visible`` ((...,) in {0, 1}, or None == 1): a fully occluded sample
    trains the score map to ALL-NEGATIVE (no positive cell, so the model
    learns to report low confidence when the target is hidden) and masks
    out the offset / size / giou regressions, whose labels point at an
    invisible box.
    """
    fs = score.shape[-1]
    centre = gt_bbox_norm[..., :2]
    vis = (torch.ones((), dtype=torch.float32, device=score.device)
           if visible is None else visible.to(torch.float32))
    target = gaussian_target(fs, centre) * vis[..., None, None]
    lf = focal_loss(score, target)

    cell = cy_cell, cx_cell = centre_cell(fs, centre)
    cell_xy = torch.stack([cx_cell, cy_cell], dim=-1).to(torch.float32)
    gt_off = centre * fs - cell_xy
    lo = l1_at_cell(offset, gt_off, cell) * vis
    ls = l1_at_cell(size, gt_bbox_norm[..., 2:4], cell) * vis

    pred = torch.cat([(cell_xy + _at_cell(offset, cell)) / fs,
                      _at_cell(size, cell)], dim=-1)
    lg = giou_loss(pred, gt_bbox_norm) * vis

    total = w_focal * lf + w_l1 * (lo + ls) + w_giou * lg
    return total, {"focal": lf, "l1_offset": lo, "l1_size": ls, "giou": lg}
