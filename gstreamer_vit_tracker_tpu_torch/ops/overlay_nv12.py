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
zone (drawing.rs:10-22); the background is a multiplicative darken, not a
fill (nv12_convert.rs:324-343).

The strip crosshair and ``draw_rect_luma_strips_dyn`` take their geometry
as tensors on the plane's device (Python ints work too), and
``draw_text_luma`` takes glyphs and ``enable`` as device tensors: a loop
that draws a box it tracked on the device (``tracker/scan.py::
update_scan_hud_pool``) reads nothing back.  They gather the block a mask
can reach at a device-computed origin, as JAX's ``dynamic_slice`` does, and
scatter it back painted.  :func:`render_hud_luma_jit` is JAX's jitted
``_render_hud_luma``, built the same way as ``ops/overlay.py``'s
``render_hud_jit``.
"""

from __future__ import annotations

import torch

from ..utils import graph
from .overlay import (HUD_TEXT_AT, HudParams, _fill, _paint_block, _region,
                      _shape_at, dense, hud_fields, hud_vector, paint_box,
                      paint_cross, paint_lines, paint_selection, paint_text,
                      selection_mask, text_mask)

__all__ = ["draw_rect_luma", "draw_crosshair_luma", "draw_text_luma",
           "draw_background_luma", "draw_cursor_luma", "draw_selection_luma",
           "draw_rect_luma_strips", "draw_rect_luma_strips_dyn",
           "draw_crosshair_luma_strips", "render_hud_luma",
           "render_hud_luma_jit"]


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
                   scale: int, brightness: int, enable=True) -> torch.Tensor:
    """nv12_convert.rs:245-321: 5x7 glyphs on the Y plane (the strip of
    ``ops/overlay.py::text_mask``).  ``chars`` may be a tensor on the
    plane's device and ``enable`` a bool tensor there: it masks the
    glyphs, and nothing is read back."""
    if not isinstance(enable, torch.Tensor) and not enable:
        return y_plane
    found = text_mask(y_plane, chars, n_chars, x, y, scale)
    if found is not None:
        view, lit = found
        if isinstance(enable, torch.Tensor):
            lit = lit & enable
        _fill(view, lit, brightness)
    return y_plane


def draw_background_luma(y_plane: torch.Tensor, x: int, y: int, w: int,
                         h: int, darkness: int,
                         enable: bool = True) -> torch.Tensor:
    """nv12_convert.rs:324-343: multiplicative darken of ``[x, x+w) x
    [y, y+h)``, ``y' = y * (255 - darkness) // 255`` in int32."""
    if not enable:
        return y_plane
    reg = _region(y_plane, int(y), int(y) + int(h) - 1, int(x),
                  int(x) + int(w) - 1)
    if reg is not None:
        view = reg[0]
        dark = torch.div(view.to(torch.int32) * (255 - int(darkness)), 255,
                         rounding_mode="floor")
        view.copy_(dark.to(view.dtype))
    return y_plane


def _i32(v, dev: torch.device) -> torch.Tensor:
    """``v`` as a 0-d int32 tensor on ``dev``; a Python int is filled in
    on the device (a fill, not a host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=dev)


def draw_rect_luma_strips_dyn(y_plane: torch.Tensor, x, y, w, h,
                              thickness: int,
                              brightness: int) -> torch.Tensor:
    """:func:`draw_rect_luma_strips` with the box as tensors on the plane's
    device: the same four strips, their origins clamped into the plane on
    the device, so the same pixels (JAX's strip semantics for boxes partly
    off the frame too).  The host-int form stays for the app, whose boxes
    are host numbers: it paints views in place, with no gather or scatter."""
    hh, ww = y_plane.shape
    t = max(1, min(int(thickness), hh, ww))
    dev = y_plane.device
    x, y, w, h = (_i32(v, dev) for v in (x, y, w, h))
    x1, y1 = torch.clamp_min(x, 0), torch.clamp_min(y, 0)
    x2, y2 = torch.clamp_max(x + w, ww - 1), torch.clamp_max(y + h, hh - 1)
    strip = torch.arange(t, dtype=torch.int32, device=dev)
    rows = torch.arange(hh, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(ww, dtype=torch.int32, device=dev)[None, :]

    def hstrip(row_lo, cond_rows):
        r = torch.clamp(row_lo, 0, hh - t) + strip[:, None]
        _paint_block(y_plane, r, cols,
                     cond_rows(r) & (cols >= x1) & (cols <= x2), brightness)

    def vstrip(col_lo, cond_cols):
        c = torch.clamp(col_lo, 0, ww - t) + strip[None, :]
        _paint_block(y_plane, rows, c,
                     cond_cols(c) & (rows >= y1) & (rows <= y2), brightness)

    hstrip(y1, lambda r: (r >= y1) & (r < y1 + t))
    hstrip(y2 - t + 1, lambda r: (r <= y2) & (r > y2 - t))
    vstrip(x1, lambda c: (c >= x1) & (c < x1 + t))
    vstrip(x2 - t + 1, lambda c: (c <= x2) & (c > x2 - t))
    return y_plane


def draw_crosshair_luma_strips(y_plane: torch.Tensor, cx, cy, size: int,
                               brightness: int) -> torch.Tensor:
    """Strip variant of :func:`draw_crosshair_luma`: one ``(2*size+1)``
    square block whose origin is clamped into the plane (its side clamped
    to the plane, so a plane smaller than the crosshair truncates the
    arms), the centre clamped at 0 first.  ``cx``, ``cy``: ints or tensors
    on the plane's device."""
    hh, ww = y_plane.shape
    side = min(2 * size + 1, hh, ww)
    dev = y_plane.device
    cx = torch.clamp_min(_i32(cx, dev), 0)
    cy = torch.clamp_min(_i32(cy, dev), 0)
    span = torch.arange(side, dtype=torch.int32, device=dev)
    r = torch.clamp(cy - size, 0, max(hh - side, 0)) + span[:, None]
    c = torch.clamp(cx - size, 0, max(ww - side, 0)) + span[None, :]
    mask = (((r == cy) & ((c - cx).abs() <= size))
            | ((c == cx) & ((r - cy).abs() <= size)))
    _paint_block(y_plane, r, c, mask, brightness)
    return y_plane


def render_hud_luma(y_plane: torch.Tensor, p: HudParams) -> torch.Tensor:
    """Paint the full HUD into an NV12 Y plane (H, W) uint8, in place, in
    the order JAX composites it (the legacy pipeline's composition,
    pipeline.rs:125-174); returns ``y_plane``.  The body of
    :func:`render_hud_luma_jit`, its inputs uploaded as
    ``overlay.hud_vector``."""
    return _render_hud_luma_dev(y_plane, torch.as_tensor(
        hud_vector(p), device=y_plane.device), y_plane.device)


def _render_hud_luma_dev(y_plane: torch.Tensor, hud: torch.Tensor,
                         device) -> torch.Tensor:
    """:func:`render_hud_luma` on its inputs ``hud``
    (``overlay.hud_vector``) on the plane's device."""
    hh, ww = y_plane.shape
    chars, n, flags, g = hud_fields(hud)
    tracking, selecting, sel_active, has_bbox = flags
    cx, cy, sx, sy, bx, by, bw, bh = g
    for i, at in enumerate(HUD_TEXT_AT):
        paint_text(y_plane, chars[i], n[i], at, tracking if i == 3 else True,
                   at[3])
    ux = torch.clamp(cx, 0, ww - 1)
    uy = torch.clamp(cy, 0, hh - 1)

    def cursor(r, c):
        dx, dy = (c - ux).abs(), (r - uy).abs()
        return ((((r == uy) & (dx <= 25) & (dx > 5))
                 | ((c == ux) & (dy <= 25) & (dy > 5))) & selecting)

    paint_box(y_plane, uy - 25, ux - 25, 51, 51, cursor, 255)
    paint_selection(y_plane, sx, sy, cx, cy, selecting & sel_active, 255)
    t = min(3, hh, ww)
    x1, y1 = torch.clamp_min(bx, 0), torch.clamp_min(by, 0)
    x2, y2 = torch.clamp_max(bx + bw, ww - 1), torch.clamp_max(by + bh,
                                                                hh - 1)

    def rect(r, c):
        in_x = (c >= x1) & (c <= x2)
        in_y = (r >= y1) & (r <= y2)
        horiz = in_x & (((r >= y1) & (r < y1 + 3)) | ((r <= y2) & (r > y2 - 3)))
        vert = in_y & (((c >= x1) & (c < x1 + 3)) | ((c <= x2) & (c > x2 - 3)))
        return (horiz | vert) & has_bbox

    paint_lines(y_plane, (y1, y2 - 2), (x1, x2 - 2), t, rect, 255)
    paint_cross(y_plane,
                torch.clamp_min(torch.div(bw, 2, rounding_mode="floor") + bx,
                                0),
                torch.clamp_min(torch.div(bh, 2, rounding_mode="floor") + by,
                                0), 15, has_bbox, 255)
    return y_plane


_render_hud_luma = graph.Compiled(_render_hud_luma_dev,
                                  "overlay_nv12.render_hud_luma_jit",
                                  donate={"y_plane": ()})


def render_hud_luma_jit(y_plane, p: HudParams,
                        device="cuda") -> torch.Tensor:
    """:func:`render_hud_luma` compiled, the plane donated (JAX's jitted
    ``_render_hud_luma``): ``y_plane`` (H, W) uint8, a host array or a
    tensor, is copied into the program's plane buffer unless it is the tensor the
    last call returned, and the result is that buffer, painted.  Where the
    input lies is part of the key: a host array and a tensor on the card
    are two programs."""
    return _render_hud_luma(dense(y_plane), hud_vector(p), device)
