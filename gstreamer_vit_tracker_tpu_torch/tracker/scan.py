"""Sequence tracking: a whole clip, or ``reps`` steps over a frame pool, in
one call that reads nothing back until the end.

Port of ``gstreamer_vit_tracker_tpu/tracker/scan.py``.  JAX's ``lax.scan``
becomes a Python loop: every step only enqueues device work (the state and
the per-step results stay tensors on the device), and the per-step results
come back stacked, one host read for the whole run.  Frames are stacked
over the clip in any of the three formats: RGB (N, H, W, 3), NV12 planes
((N, H, W), (N, H/2, W/2, 2)) or YUY2 (N, H, W*2).

``update_scan_hud_pool`` composites the luma HUD into a display buffer after
every tracked frame, with the score digits, the box and the enable computed
on the device (``ops/overlay_nv12.py``'s device-tensor draws), so it too
reads nothing back inside its loop.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..ops import font
from ..ops import overlay_nv12 as ol
from . import core, multi
from .state import TrackState

Params = Dict[str, Any]


def _pool(frames, frame_format: str, dev: torch.device):
    """The frame pool's planes on the device, and its length."""
    planes = core._frame_on(frames, frame_format, dev)
    return planes, planes[0].shape[0]


def _pick(planes, i):
    """Frame ``i`` (an index or a slice) of a pool's planes."""
    return tuple(p[i] for p in planes)


def update_scan(params: Params, state: TrackState, frames, cfg: ModelConfig,
                frame_format: str = "rgb", device="cuda"
                ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Track a whole clip.  ``frames``: stacked over frames (module
    docstring).

    Returns (final_state, bboxes (N, 4), scores (N,)).
    """
    dev = resolve_device(device)
    planes, n = _pool(frames, frame_format, dev)
    bboxes, scores = [], []
    for i in range(n):
        state, bbox, conf = core.update(params, state, _pick(planes, i), cfg,
                                        frame_format, dev)
        bboxes.append(bbox)
        scores.append(conf)
    return state, torch.stack(bboxes), torch.stack(scores)


def update_scan_pool(params: Params, state: TrackState, frames, reps: int,
                     cfg: ModelConfig, frame_format: str = "nv12",
                     fused_prep=False, device="cuda"
                     ) -> Tuple[TrackState, torch.Tensor]:
    """Benchmark variant: ``reps`` tracked frames cycling through a small
    device-resident frame pool by index.  Returns (state, scores (reps,)).
    ``fused_prep`` routes the NV12 step through the one-kernel preprocess +
    embed (``core.update``)."""
    dev = resolve_device(device)
    planes, pool = _pool(frames, frame_format, dev)
    scores = []
    for i in range(reps):
        state, _bbox, conf = core.update(
            params, state, _pick(planes, i % pool), cfg, frame_format,
            dev, fused_prep=fused_prep)
        scores.append(conf)
    return state, torch.stack(scores)


def update_streams_scan_pool(params: Params, state: TrackState, frames,
                             active, reps: int, cfg: ModelConfig,
                             frame_format: str = "nv12", device="cuda"
                             ) -> Tuple[TrackState, torch.Tensor]:
    """``reps`` batched multi-stream steps in one call.

    S independent streams advance together, each stream s reading pool
    frame ``(i + s) % P``, so content differs across streams without
    duplicating the pool on the device.  ``state`` is a (S, M)-leading
    TrackState from ``multi.init_streams``; ``active`` (S, M) bool is
    constant across the run.  Returns (state, scores (reps, S, M)).

    As in JAX, a step's frames are one contiguous slice of a cyclically
    extended pool (built once per call), not a row gather.
    """
    dev = resolve_device(device)
    planes, pool = _pool(frames, frame_format, dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    n_streams = active.shape[0]
    need = pool + n_streams          # slice start < pool, length n_streams
    tiles = -(-need // pool)

    def extend(x):
        return torch.cat([x] * tiles, dim=0)[:need]

    planes = tuple(extend(p) for p in planes)
    scores = []
    for i in range(reps):
        start = i % pool
        fr = _pick(planes, slice(start, start + n_streams))
        state, _bx, sc = multi.update_streams(params, state, fr, active, cfg,
                                              frame_format, device=dev)
        scores.append(sc)
    return state, torch.stack(scores)


def update_objects_scan_pool(params: Params, state: TrackState, frames,
                             active, reps: int, cfg: ModelConfig,
                             frame_format: str = "nv12", device="cuda"
                             ) -> Tuple[TrackState, torch.Tensor]:
    """``reps`` multi-object steps (N targets, one shared frame per step)
    in one call, cycling the frame pool.  Returns (state, scores
    (reps, N))."""
    dev = resolve_device(device)
    planes, pool = _pool(frames, frame_format, dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    scores = []
    for i in range(reps):
        state, _bx, sc = multi.update_objects(
            params, state, _pick(planes, i % pool), active, cfg,
            frame_format, device=dev)
        scores.append(sc)
    return state, torch.stack(scores)


# The static HUD lines of the legacy pipeline's composition (state, FPS,
# track ms): (x, y, scale, brightness), pipeline.rs:125-174.
HUD_LINES = ((15, 15, 2, 255), (15, 40, 2, 255), (15, 65, 1, 200))
SCORE_PREFIX = "score: "


class HudGlyphs(NamedTuple):
    """The HUD's glyph indices on the device: the three static lines
    ((chars, n) each) and the pieces of the live ``score: XX.X%`` line."""

    lines: Tuple[Tuple[torch.Tensor, int], ...]
    prefix: torch.Tensor      # "score: " (7,)
    dot: torch.Tensor         # (1,)
    pct: torch.Tensor         # (1,)


def hud_glyphs(hud_text, device) -> HudGlyphs:
    """Upload ``hud_text`` (three ``font.encode_text`` results: state, FPS,
    track lines) and the score line's fixed glyphs in one copy.  On the
    card the copy is from pinned memory and asynchronous, so no host sync
    is made."""
    dev = torch.device(device)
    prefix, _ = font.encode_text(SCORE_PREFIX, len(SCORE_PREFIX))
    marks = [font.FONT_CHARS.index("."), font.FONT_CHARS.index("%")]
    parts = [np.asarray(c, np.int32) for c, _ in hud_text] + [
        np.asarray(prefix, np.int32), np.asarray(marks, np.int32)]
    packed = torch.from_numpy(np.concatenate(parts))
    if dev.type == "cuda":
        packed = packed.pin_memory()
    packed = packed.to(dev, non_blocking=True)
    pieces = torch.split(packed, [len(p) for p in parts])
    lines = tuple((pieces[k], int(n)) for k, (_, n) in enumerate(hud_text))
    return HudGlyphs(lines, pieces[3], pieces[4][:1], pieces[4][1:])


def composite_hud(display: torch.Tensor, luma: torch.Tensor, bbox, conf,
                  glyphs: HudGlyphs) -> torch.Tensor:
    """One frame of the HUD pool: ``display`` (H, W) uint8 becomes ``luma``
    with the HUD painted on it (the body of JAX's
    ``scan.update_scan_hud_pool``): the state, FPS and track lines; the
    ``score: XX.X%`` line, its digits ``round(conf * 1000)`` clipped to
    0..999 and shown where ``conf > 0.25``; the box (``bbox`` truncated to
    int32) as rect strips of thickness 3 and the strip crosshair, luma 255.
    ``bbox`` and ``conf`` are tensors on the display's device; nothing is
    read back.  ``luma`` is only read."""
    display.copy_(luma)
    for (chars, n), (x, y, scale, bright) in zip(glyphs.lines, HUD_LINES):
        ol.draw_text_luma(display, chars, n, x, y, scale, bright)
    v = torch.clamp(torch.round(conf * 1000.0), 0, 999).to(torch.int32)
    score_chars = torch.cat([glyphs.prefix, (v // 100)[None],
                             ((v // 10) % 10)[None], glyphs.dot,
                             (v % 10)[None], glyphs.pct])
    ol.draw_text_luma(display, score_chars, score_chars.shape[0], 200, 15, 2,
                      255, enable=conf > 0.25)
    bb = bbox.to(torch.int32)
    ol.draw_rect_luma_strips_dyn(display, bb[0], bb[1], bb[2], bb[3], 3, 255)
    ol.draw_crosshair_luma_strips(display, bb[0] + bb[2] // 2,
                                  bb[1] + bb[3] // 2, 15, 255)
    return display


def update_scan_hud_pool(params: Params, state: TrackState, frames, hud_text,
                         reps: int, cfg: ModelConfig, device="cuda"
                         ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """BASELINE config 5's serving shape: ``reps`` tracked frames cycling
    through an NV12 pool ((P, H, W), (P, H/2, W/2, 2)), every one of them
    composited with the full luma HUD (:func:`composite_hud`) into one
    preallocated display buffer that each frame overwrites: the leaky
    display queue of the reference (pipeline_ir.rs:75-78), where a slow
    consumer sees only the newest frame but every frame pays the composite.

    The pool is never written (the HUD goes on the display's copy of the
    frame, as JAX paints a copy).  ``hud_text``: (state, FPS, track) lines
    from ``ops/font.encode_text``.  Returns (state, display_luma (H, W)
    uint8, scores (reps,))."""
    dev = resolve_device(device)
    planes, pool = _pool(frames, "nv12", dev)
    glyphs = hud_glyphs(hud_text, dev)
    display = torch.zeros_like(planes[0][0])
    scores = []
    for i in range(reps):
        frame = _pick(planes, i % pool)
        state, bbox, conf = core.update(params, state, frame, cfg, "nv12",
                                        dev)
        composite_hud(display, frame[0], bbox, conf, glyphs)
        scores.append(conf)
    return state, display, torch.stack(scores)
