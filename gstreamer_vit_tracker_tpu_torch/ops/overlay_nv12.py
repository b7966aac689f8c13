"""HUD drawing on a device tensor: the NV12 luma plane.

Port of ``gstreamer_vit_tracker_tpu/ops/overlay_nv12.py``: the reference's
legacy 1080p pipeline draws brightness-only overlays into the Y plane
(nv12_convert.rs:172-343, drawing.rs:5-50) and leaves chroma alone.  Same
design as ``ops/overlay.py``: each masked select is evaluated over the
bounding box its mask can reach and painted into a (H, W) uint8 plane in
place.

The luma semantics differ from the RGB ones on purpose, as in the
reference: rect edges are inclusive with clamped corners
(nv12_convert.rs:183-212); the cursor draws arms to 25 outside a +-5 dead
zone (drawing.rs:10-22).
"""

from __future__ import annotations

import torch

from .overlay import (HudParams, _fill, _shape_at, hud_texts, selection_mask,
                      text_mask)

__all__ = ["draw_rect_luma", "draw_crosshair_luma", "draw_text_luma",
           "draw_cursor_luma", "draw_selection_luma", "draw_rect_luma_strips",
           "render_hud_luma"]


def _rect_corners(y_plane: torch.Tensor, x, y, w, h):
    hh, ww = y_plane.shape
    x, y, w, h = int(x), int(y), int(w), int(h)
    return max(x, 0), max(y, 0), min(x + w, ww - 1), min(y + h, hh - 1)


def draw_rect_luma(y_plane: torch.Tensor, x, y, w, h, thickness: int,
                   brightness: int, enable: bool = True) -> torch.Tensor:
    """nv12_convert.rs:172-213: clamped inclusive edges, ``thickness``
    bands growing inward.  A band can reach past the opposite corner when
    the box is thinner than the bands (or off the frame), as in JAX, so
    the region spans both corners widened by the bands."""
    if not enable:
        return y_plane
    x1, y1, x2, y2 = _rect_corners(y_plane, x, y, w, h)
    t = int(thickness)

    def mask(r, c):
        in_x = (c >= x1) & (c <= x2)
        in_y = (r >= y1) & (r <= y2)
        horiz = in_x & (((r >= y1) & (r < y1 + t)) | ((r <= y2) & (r > y2 - t)))
        vert = in_y & (((c >= x1) & (c < x1 + t)) | ((c <= x2) & (c > x2 - t)))
        return horiz | vert

    return _shape_at(y_plane, min(y1, y2 - t + 1), max(y2, y1 + t - 1),
                     min(x1, x2 - t + 1), max(x2, x1 + t - 1), mask,
                     brightness)


def draw_crosshair_luma(y_plane: torch.Tensor, cx, cy, size: int,
                        brightness: int, enable: bool = True) -> torch.Tensor:
    """nv12_convert.rs:216-242 (centre clamped at 0, arms cut at the
    frame)."""
    if not enable:
        return y_plane
    cx, cy = max(int(cx), 0), max(int(cy), 0)
    return _shape_at(
        y_plane, cy - size, cy + size, cx - size, cx + size,
        lambda r, c: (((r == cy) & ((c - cx).abs() <= size))
                      | ((c == cx) & ((r - cy).abs() <= size))), brightness)


def draw_cursor_luma(y_plane: torch.Tensor, cx, cy,
                     enable: bool = True) -> torch.Tensor:
    """drawing.rs:5-23: arms to +-25 with a +-5 dead zone, brightness 255,
    the centre clamped into the frame."""
    if not enable:
        return y_plane
    hh, ww = y_plane.shape
    cx = min(max(int(cx), 0), ww - 1)
    cy = min(max(int(cy), 0), hh - 1)

    def mask(r, c):
        dx, dy = (c - cx).abs(), (r - cy).abs()
        return (((r == cy) & (dx <= 25) & (dx > 5))
                | ((c == cx) & (dy <= 25) & (dy > 5)))

    return _shape_at(y_plane, cy - 25, cy + 25, cx - 25, cx + 25, mask, 255)


def draw_selection_luma(y_plane: torch.Tensor, start_x, start_y, cur_x,
                        cur_y, enable: bool = True) -> torch.Tensor:
    """drawing.rs:25-50: dashed box on luma, period-6 dashes, 255."""
    if not enable:
        return y_plane
    box, mask = selection_mask(y_plane, start_x, start_y, cur_x, cur_y)
    return _shape_at(y_plane, *box, mask, 255)


def draw_rect_luma_strips(y_plane: torch.Tensor, x, y, w, h, thickness: int,
                          brightness: int) -> torch.Tensor:
    """The JAX package's strip variant of :func:`draw_rect_luma` (what the
    app draws the extra multi-object boxes with): four strips, two (t, W)
    rows and two (H, t) columns, each origin clamped into the plane.  The
    same pixels as the masked variant for rects inside the frame; a rect
    partly off the frame drops its edge rows and columns past the border,
    as in JAX."""
    hh, ww = y_plane.shape
    t = max(1, min(int(thickness), hh, ww))
    x1, y1, x2, y2 = _rect_corners(y_plane, x, y, w, h)
    dev = y_plane.device

    def hstrip(row_lo, cond_rows):
        row0 = min(max(row_lo, 0), hh - t)
        r = row0 + torch.arange(t, device=dev)[:, None]
        c = torch.arange(ww, device=dev)[None, :]
        _fill(y_plane[row0:row0 + t], cond_rows(r) & (c >= x1) & (c <= x2),
              brightness)

    def vstrip(col_lo, cond_cols):
        col0 = min(max(col_lo, 0), ww - t)
        r = torch.arange(hh, device=dev)[:, None]
        c = col0 + torch.arange(t, device=dev)[None, :]
        _fill(y_plane[:, col0:col0 + t], cond_cols(c) & (r >= y1) & (r <= y2),
              brightness)

    hstrip(y1, lambda r: (r >= y1) & (r < y1 + t))
    hstrip(y2 - t + 1, lambda r: (r <= y2) & (r > y2 - t))
    vstrip(x1, lambda c: (c >= x1) & (c < x1 + t))
    vstrip(x2 - t + 1, lambda c: (c <= x2) & (c > x2 - t))
    return y_plane


def draw_text_luma(y_plane: torch.Tensor, chars, n_chars: int, x: int, y: int,
                   scale: int, brightness: int,
                   enable: bool = True) -> torch.Tensor:
    """nv12_convert.rs:245-321: 5x7 glyphs on the Y plane (the strip of
    ``ops/overlay.py::text_mask``)."""
    if not enable:
        return y_plane
    found = text_mask(y_plane, chars, n_chars, x, y, scale)
    if found is not None:
        view, lit = found
        _fill(view, lit, brightness)
    return y_plane


def render_hud_luma(y_plane: torch.Tensor, p: HudParams) -> torch.Tensor:
    """Paint the full HUD into an NV12 Y plane (H, W) uint8, in place, in
    the order JAX composites it (the legacy pipeline's composition,
    pipeline.rs:125-174); returns ``y_plane``."""
    for chars, n, x, y, scale, luma, on in hud_texts(p):
        draw_text_luma(y_plane, chars, n, x, y, scale, luma, enable=on)
    selecting = bool(p.is_selecting)
    cx, cy = int(p.cursor[0]), int(p.cursor[1])
    draw_cursor_luma(y_plane, cx, cy, enable=selecting)
    draw_selection_luma(y_plane, p.sel_start[0], p.sel_start[1], cx, cy,
                        enable=selecting and bool(p.sel_active))
    bx, by, bw, bh = (int(v) for v in p.bbox)
    draw_rect_luma(y_plane, bx, by, bw, bh, 3, 255, enable=bool(p.has_bbox))
    draw_crosshair_luma(y_plane, bx + bw // 2, by + bh // 2, 15, 255,
                        enable=bool(p.has_bbox))
    return y_plane
