"""HUD drawing on a device tensor: RGB frames.

Port of ``gstreamer_vit_tracker_tpu/ops/overlay.py`` (the reference's CPU
renderers drawing_rgb.rs and drawing.rs): rectangle, crosshair, cursor,
dashed selection and 5x7 text, with the reference's geometry (thickness
bands inside the box, dash period 6, cursor size 25 / gap 5, 6-cell glyph
advance).

Every primitive is the JAX package's masked select, evaluated over the
bounding box of the pixels its mask can reach (clipped to the frame)
instead of the whole frame, and painted into that view of the image in
place with ``masked_fill_``; the geometry is host integers, so nothing is
read back from the device.  Painting in place is the counterpart of JAX's
donated frame: pass a tensor that nothing else still reads.  Each function
returns the image it painted.  The results are uint8-equal to JAX's
(tests/test_torch_hud.py).

The full HUD (:func:`render_hud`) takes its dynamic inputs as one int32
vector on the device (:func:`hud_vector`), so that JAX's jitted
``_render_hud``, :func:`render_hud_jit` (what the app calls), is one
compiled program (``utils/graph.py``) for every frame, the frame donated.
Its draws gather the block or strip a mask can reach at a
device-computed origin, paint the mask evaluated at the pixels' own
coordinates, and scatter it back.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..utils import graph
from .font import ADVANCE, FONT_TABLE, encode_text

__all__ = [
    "draw_rect", "draw_crosshair", "draw_cursor", "draw_selection",
    "draw_background", "draw_text", "encode_text", "HudParams", "render_hud",
    "hud_vector", "render_hud_jit",
]


def _region(img: torch.Tensor, r0: int, r1: int, c0: int, c1: int):
    """Rows [r0, r1] and columns [c0, c1] (inclusive) clipped to the image:
    (view, row indices (h, 1), column indices (1, w)), or None if empty."""
    h, w = img.shape[0], img.shape[1]
    r0, r1, c0, c1 = max(r0, 0), min(r1, h - 1), max(c0, 0), min(c1, w - 1)
    if r0 > r1 or c0 > c1:
        return None
    dev = img.device
    r = torch.arange(r0, r1 + 1, dtype=torch.int32, device=dev)[:, None]
    c = torch.arange(c0, c1 + 1, dtype=torch.int32, device=dev)[None, :]
    return img[r0:r1 + 1, c0:c1 + 1], r, c


def _fill(view: torch.Tensor, mask: torch.Tensor, color) -> None:
    """``where(mask, color, view)`` written into ``view``: one value on a
    luma plane, one a channel on (h, w, C)."""
    if view.dim() == 2:
        view.masked_fill_(mask, int(color))
    else:
        for ch, v in enumerate(color):
            view[..., ch].masked_fill_(mask, int(v))


def _shape_at(img: torch.Tensor, r0, r1, c0, c1, mask_fn, color) -> torch.Tensor:
    reg = _region(img, r0, r1, c0, c1)
    if reg is not None:
        view, r, c = reg
        _fill(view, mask_fn(r, c), color)
    return img


def draw_rect(img: torch.Tensor, x, y, w, h, thickness: int, color,
              enable: bool = True) -> torch.Tensor:
    """Rectangle outline, drawing_rgb.rs:55-66: ``thickness`` bands inside
    the box extent, pixels off the frame dropped."""
    if not enable:
        return img
    x, y, w, h, t = int(x), int(y), int(w), int(h), int(thickness)
    return _shape_at(
        img, y, y + h - 1, x, x + w - 1,
        lambda r, c: ((r < y + t) | (r >= y + h - t)
                      | (c < x + t) | (c >= x + w - t)), color)


def draw_crosshair(img: torch.Tensor, cx, cy, size: int, color,
                   enable: bool = True) -> torch.Tensor:
    """Cross of half-length ``size`` (drawing_rgb.rs:68-73)."""
    if not enable:
        return img
    cx, cy = int(cx), int(cy)
    return _shape_at(
        img, cy - size, cy + size, cx - size, cx + size,
        lambda r, c: (((r == cy) & ((c - cx).abs() <= size))
                      | ((c == cx) & ((r - cy).abs() <= size))), color)


def draw_cursor(img: torch.Tensor, cx, cy, enable: bool = True,
                color=(0, 255, 0)) -> torch.Tensor:
    """Open-centre cursor, size 25 / gap 5 (drawing_rgb.rs:75-84)."""
    if not enable:
        return img
    cx, cy = int(cx), int(cy)

    def mask(r, c):
        dx, dy = (c - cx).abs(), (r - cy).abs()
        return (((r == cy) & (dx >= 5) & (dx <= 25))
                | ((c == cx) & (dy >= 5) & (dy <= 25)))

    return _shape_at(img, cy - 25, cy + 25, cx - 25, cx + 25, mask, color)


def selection_mask(img: torch.Tensor, start_x, start_y, cur_x, cur_y):
    """The dashed selection box's corners and mask, shared with the luma
    variant (drawing_rgb.rs:106-129, drawing.rs:25-50): corners clamped to
    the frame, period-6 dashes."""
    h, w = img.shape[0], img.shape[1]
    sx, sy, ux, uy = int(start_x), int(start_y), int(cur_x), int(cur_y)
    x1, y1 = max(min(sx, ux), 0), max(min(sy, uy), 0)
    x2, y2 = min(max(sx, ux), w - 1), min(max(sy, uy), h - 1)

    def mask(r, c):
        horiz = (((r == y1) | (r == y2)) & (c >= x1) & (c <= x2)
                 & ((c // 6) % 2 == 0))
        vert = (((c == x1) | (c == x2)) & (r >= y1) & (r <= y2)
                & ((r // 6) % 2 == 0))
        return horiz | vert

    return (min(y1, y2), max(y1, y2), min(x1, x2), max(x1, x2)), mask


def draw_selection(img: torch.Tensor, start_x, start_y, cur_x, cur_y,
                   enable: bool = True) -> torch.Tensor:
    """Dashed yellow selection box with period-6 dashes
    (drawing_rgb.rs:106-129)."""
    if not enable:
        return img
    box, mask = selection_mask(img, start_x, start_y, cur_x, cur_y)
    return _shape_at(img, *box, mask, (255, 255, 0))


def draw_background(img: torch.Tensor, x, y, w, h, value: int = 30,
                    enable: bool = True) -> torch.Tensor:
    """Filled dark-gray info box ``[x, x+w) x [y, y+h)``, the part on the
    frame (drawing_rgb.rs:42-52 memset fill)."""
    if not enable:
        return img
    x, y, w, h = int(x), int(y), int(w), int(h)
    reg = _region(img, y, y + h - 1, x, x + w - 1)
    if reg is not None:
        reg[0].fill_(int(value))
    return img


@functools.lru_cache(maxsize=None)
def _font(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(FONT_TABLE, device=device)


def text_mask(img: torch.Tensor, chars: np.ndarray, n_chars: int, x: int,
              y: int, scale: int):
    """The lit pixels of up to ``len(chars)`` glyphs at (x, y): (view of
    the text strip, bool mask), or None when the strip is off the frame.
    Glyph indices come from ``font.encode_text``; 5x7 glyphs, integer
    ``scale``, ``6*scale`` advance (draw_text_rgb, drawing_rgb.rs:86-104).
    ``chars`` and ``n_chars`` may be tensors on the image's device (glyphs
    computed there), which are read where they lie."""
    h, w = img.shape[0], img.shape[1]
    max_len = len(chars)
    strip_h = min(7 * scale, h - y)
    strip_w = min(ADVANCE * scale * max_len, w - x)
    if strip_h <= 0 or strip_w <= 0:
        return None
    dev = img.device
    r = torch.arange(strip_h, device=dev)[:, None]
    c = torch.arange(strip_w, device=dev)[None, :]
    k = c // (ADVANCE * scale)
    gx = (c % (ADVANCE * scale)) // scale
    gy = r // scale
    ch = torch.as_tensor(chars, device=dev)[k]
    lit = _font(dev)[ch, torch.clamp_max(gy, 6), torch.clamp_max(gx, 4)] == 1
    lit = lit & (gx < 5) & (gy < 7) & (k < n_chars)
    return img[y:y + strip_h, x:x + strip_w], lit


def draw_text(img: torch.Tensor, chars: np.ndarray, n_chars: int, x: int,
              y: int, scale: int, luma: int, enable: bool = True
              ) -> torch.Tensor:
    """Render the glyphs at (x, y) in ``luma`` on all three channels."""
    if not enable:
        return img
    found = text_mask(img, chars, n_chars, x, y, scale)
    if found is not None:
        view, lit = found
        _fill(view, lit, (luma,) * 3)
    return img


# ---------------------------------------------------------------------------
# Full HUD (pipeline_ir.rs:162-204 composition)
# ---------------------------------------------------------------------------

# Field widths for the dynamic HUD strings.
STATE_LEN = 12      # "SELECT START"
FPS_LEN = 10        # "FPS: 12345"
TRK_LEN = 12        # "trk:123.4ms"
SCORE_LEN = 11      # "score: 100%"


class HudParams:
    """Host-side helper bundling the per-frame dynamic HUD inputs."""

    def __init__(self, state_name: str, fps: float, track_ms: float,
                 score: float, is_tracking: bool, is_selecting: bool,
                 cursor: Tuple[int, int], sel_start: Tuple[int, int],
                 sel_active: bool, bbox, has_bbox: bool):
        # Dynamic strings are TRUNCATED to their field width, never raised
        # on: a slow first tracked frame can push track_ms past 9999.9 and
        # must not crash the frame loop (encode_text itself still raises
        # on overflow — that contract is for static strings).
        self.state_chars, self.state_n = encode_text(
            state_name[:STATE_LEN], STATE_LEN)
        self.fps_chars, self.fps_n = encode_text(
            f"FPS: {fps:.0f}"[:FPS_LEN], FPS_LEN)
        self.trk_chars, self.trk_n = encode_text(
            f"trk:{track_ms:.1f}ms"[:TRK_LEN], TRK_LEN)
        self.score_chars, self.score_n = encode_text(
            f"score: {score * 100.0:.0f}%"[:SCORE_LEN], SCORE_LEN)
        self.is_tracking = is_tracking
        self.is_selecting = is_selecting
        self.cursor = cursor
        self.sel_start = sel_start
        self.sel_active = sel_active
        self.bbox = np.asarray(bbox if bbox is not None else (0, 0, 0, 0),
                               np.int32)
        self.has_bbox = has_bbox


# Where each of the four HUD strings goes: (x, y, scale, luma); the last,
# the score, only while tracking.
HUD_TEXT_AT = ((15, 15, 2, 255), (15, 40, 2, 255), (15, 65, 1, 200),
               (200, 15, 2, 255))


def render_hud(img: torch.Tensor, p: HudParams) -> torch.Tensor:
    """Paint the full HUD (state, FPS, timings, score, cursor / selection,
    bbox + crosshair) into ``img`` (H, W, 3) uint8, in place, in the order
    JAX composites it; returns ``img``.  The body of
    :func:`render_hud_jit`, its inputs uploaded as :func:`hud_vector`."""
    return _render_hud_dev(img, torch.as_tensor(hud_vector(p),
                                                 device=img.device),
                           img.device)


# ---------------------------------------------------------------------------
# The compiled HUD (JAX's jitted _render_hud): the geometry on the device
# ---------------------------------------------------------------------------

_HUD_WIDTHS = (STATE_LEN, FPS_LEN, TRK_LEN, SCORE_LEN)


def hud_vector(p: HudParams) -> np.ndarray:
    """Every dynamic input of the HUD in one int32 vector, one upload a
    frame: the four strings' glyphs, their lengths, the flags (tracking,
    selecting, selection active, box shown), the cursor, the selection's
    start and the box (x, y, w, h)."""
    rest = [p.state_n, p.fps_n, p.trk_n, p.score_n,
            bool(p.is_tracking), bool(p.is_selecting), bool(p.sel_active),
            bool(p.has_bbox), *p.cursor, *p.sel_start, *p.bbox]
    return np.concatenate([np.asarray(c, np.int32) for c in (
        p.state_chars, p.fps_chars, p.trk_chars, p.score_chars)]
        + [np.asarray([int(v) for v in rest], np.int32)])


def hud_fields(v: torch.Tensor):
    """:func:`hud_vector` on the device, unpacked: (the four glyph
    vectors, the four lengths, the four flags as bools, the eight
    coordinates), each a view or a 0-d tensor."""
    chars, at = [], 0
    for w in _HUD_WIDTHS:
        chars.append(v[at:at + w])
        at += w
    return (chars, v[at:at + 4].unbind(), (v[at + 4:at + 8] != 0).unbind(),
            v[at + 8:at + 16].unbind())


def _paint_block(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                 mask: torch.Tensor, color) -> None:
    """Gather the pixels of rows ``r`` (h, 1) x columns ``c`` (1, w)
    (device indices inside the image), paint ``mask`` in them and scatter
    them back: JAX's ``dynamic_slice`` / ``dynamic_update_slice`` pair, on
    a luma plane (one ``color``) or an (H, W, C) image (one a channel)."""
    flat = img.view(img.shape[0] * img.shape[1], -1)
    idx = r.long() * img.shape[1] + c.long()
    block = flat[idx]
    _fill(block if img.dim() == 3 else block[..., 0], mask, color)
    flat[idx] = block


def _axis(lo: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """The ``n`` indices from ``lo`` (a 0-d device tensor) clamped so that
    all lie in ``[0, size)`` (``n`` no more than ``size``)."""
    return torch.clamp(lo, 0, size - n) + torch.arange(
        n, dtype=torch.int32, device=lo.device)


def paint_box(img: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
              bh: int, bw: int, mask_fn, color) -> None:
    """Paint ``mask_fn(r, c)`` (at the pixels' own coordinates) in the
    ``bh`` x ``bw`` block whose origin ``(r0, c0)`` (0-d device tensors)
    is clamped into the image, its sides first cut to the image's."""
    hh, ww = img.shape[0], img.shape[1]
    bh, bw = min(bh, hh), min(bw, ww)
    r = _axis(r0, bh, hh)[:, None]
    c = _axis(c0, bw, ww)[None, :]
    _paint_block(img, r, c, mask_fn(r, c), color)


def paint_lines(img: torch.Tensor, rows, cols, t: int, mask_fn,
                color) -> None:
    """Paint ``mask_fn(r, c)`` in the full-width strips of ``t`` rows
    from each of ``rows`` and the full-height strips of ``t`` columns from
    each of ``cols`` (0-d device tensors, each strip clamped into the
    image): a mask that lies in those bands is painted whole."""
    hh, ww = img.shape[0], img.shape[1]
    for r0 in rows:
        paint_box(img, r0, r0 * 0, t, ww, mask_fn, color)
    for c0 in cols:
        paint_box(img, c0 * 0, c0, hh, t, mask_fn, color)


def paint_text(img: torch.Tensor, chars, n, at, enable, color) -> None:
    """One HUD string at its place ``at`` = (x, y, scale, luma), glyphs,
    length and ``enable`` (or True) as device tensors."""
    x, y, scale, _ = at
    found = text_mask(img, chars, n, x, y, scale)
    if found is not None:
        view, lit = found
        _fill(view, lit if enable is True else lit & enable, color)


def paint_selection(img: torch.Tensor, sx, sy, ux, uy, enable,
                    color) -> None:
    """:func:`draw_selection`'s dashed box, its corners device tensors:
    the strips through its two rows and its two columns."""
    hh, ww = img.shape[0], img.shape[1]
    x1 = torch.clamp_min(torch.minimum(sx, ux), 0)
    y1 = torch.clamp_min(torch.minimum(sy, uy), 0)
    x2 = torch.clamp_max(torch.maximum(sx, ux), ww - 1)
    y2 = torch.clamp_max(torch.maximum(sy, uy), hh - 1)

    def mask(r, c):
        horiz = (((r == y1) | (r == y2)) & (c >= x1) & (c <= x2)
                 & ((c // 6) % 2 == 0))
        vert = (((c == x1) | (c == x2)) & (r >= y1) & (r <= y2)
                & ((r // 6) % 2 == 0))
        return (horiz | vert) & enable

    paint_lines(img, (y1, y2), (x1, x2), 1, mask, color)


def paint_cross(img: torch.Tensor, cx, cy, size: int, enable,
                color) -> None:
    """:func:`draw_crosshair`'s cross, its centre device tensors."""
    paint_box(img, cy - size, cx - size, 2 * size + 1, 2 * size + 1,
              lambda r, c: ((((r == cy) & ((c - cx).abs() <= size))
                             | ((c == cx) & ((r - cy).abs() <= size)))
                            & enable), color)


def _render_hud_dev(img: torch.Tensor, hud: torch.Tensor,
                    device) -> torch.Tensor:
    """:func:`render_hud` on its inputs ``hud`` (:func:`hud_vector`) on
    the image's device."""
    chars, n, flags, g = hud_fields(hud)
    tracking, selecting, sel_active, has_bbox = flags
    cx, cy, sx, sy, bx, by, bw, bh = g
    for i, at in enumerate(HUD_TEXT_AT):
        paint_text(img, chars[i], n[i], at, tracking if i == 3 else True,
                   (at[3],) * 3)

    def cursor(r, c):
        dx, dy = (c - cx).abs(), (r - cy).abs()
        return ((((r == cy) & (dx >= 5) & (dx <= 25))
                 | ((c == cx) & (dy >= 5) & (dy <= 25))) & selecting)

    paint_box(img, cy - 25, cx - 25, 51, 51, cursor, (0, 255, 0))
    paint_selection(img, sx, sy, cx, cy, selecting & sel_active,
                    (255, 255, 0))
    t = min(3, img.shape[0], img.shape[1])

    def rect(r, c):
        inside = (r >= by) & (r < by + bh) & (c >= bx) & (c < bx + bw)
        border = ((r < by + 3) | (r >= by + bh - 3) | (c < bx + 3)
                  | (c >= bx + bw - 3))
        return inside & border & has_bbox

    paint_lines(img, (by, by + bh - 3), (bx, bx + bw - 3), t, rect,
                (0, 255, 0))
    paint_cross(img, torch.div(bw, 2, rounding_mode="floor") + bx,
                torch.div(bh, 2, rounding_mode="floor") + by, 15, has_bbox,
                (0, 255, 0))
    return img


def dense(x):
    """``x`` (a host array or a tensor) laid out row-major, as the compiled
    HUD's gathers view it: the same object when it is."""
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x)
    return torch.as_tensor(x).contiguous()


_render_hud = graph.Compiled(_render_hud_dev, "overlay.render_hud_jit",
                             donate={"img": ()})


def render_hud_jit(img, p: HudParams, device="cuda") -> torch.Tensor:
    """:func:`render_hud` compiled, the frame donated (JAX's jitted
    ``_render_hud``): ``img`` (H, W, 3) uint8, a host array or a tensor,
    is copied into the program's frame buffer unless it is the tensor the
    last call returned, and the result is that buffer, painted.  Where the
    input lies is part of the key: a host array and a tensor on the card
    are two programs."""
    return _render_hud(dense(img), hud_vector(p), device)
