"""Sequence tracking: a whole clip, or ``reps`` steps over a frame pool, in
one call that reads nothing back until the end.

Port of ``gstreamer_vit_tracker_tpu/tracker/scan.py``, where each function
is ONE XLA program (``lax.scan`` under ``jax.jit``).  Here each is one
captured step (``utils/graph.py``) replayed ``reps`` (or N) times: the step
picks its frame by a device-side index ``i % P`` that the graph carries and
increments, writes its results at row ``i`` of static ``(reps, ...)``
buffers and carries the state (donated) in its static buffers, so no step
reads anything back.  JAX's one program for all steps is approximated by
one graph a step, replayed.  Frames are stacked over the clip in any of
the three formats: RGB (N, H, W, 3), NV12 planes ((N, H, W), (N, H/2,
W/2, 2)) or YUY2 (N, H, W*2).

:func:`scanned` makes such a program of any step (the profiling scripts'
variants, JAX's jitted ``lax.scan`` s of their own).

``update_scan_hud_pool`` composites the luma HUD into a display buffer after
every tracked frame, with the score digits, the box and the enable computed
on the device (``ops/overlay_nv12.py``'s device-tensor draws), so it too
reads nothing back inside its loop.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import font
from ..ops import overlay_nv12 as ol
from ..utils import graph
from . import core, multi
from .state import TrackState

Params = Dict[str, Any]


def _planes(frames) -> Tuple[torch.Tensor, ...]:
    """A pool's planes as a tuple (one plane for RGB and YUY2)."""
    return tuple(frames) if isinstance(frames, (tuple, list)) else (frames,)


def _length(frames) -> int:
    return _planes(frames)[0].shape[0]


def _rows(reps: int) -> int:
    """Rows of a step-result buffer for ``reps`` steps: a power of two from
    256 up, so runs of different lengths share one capture."""
    return max(256, 1 << (reps - 1).bit_length())


def _results(reps: int, *shape: int) -> torch.Tensor:
    """The shape of a (rows, *shape) float32 step-result buffer (no memory:
    the graph owns the buffer)."""
    return torch.empty((_rows(reps),) + shape, device="meta")


def _pick(planes, i: torch.Tensor):
    """Frame ``i`` ((1,) int64 on the device) of a pool's planes."""
    return tuple(p.index_select(0, i)[0] for p in planes)


def scanned(step: Callable, name: str) -> Callable:
    """``step(carry, i) -> (carry, value)`` as one program of ``reps``
    steps, the carry donated: the counterpart of a ``jax.jit`` of
    ``lax.scan(step, carry, jnp.arange(reps))``.  ``i`` is the step's
    device index ((1,) int64); ``value`` a 0-d tensor (or None) written at
    row ``i``.  Returns ``run(carry, reps, device) -> (carry, values
    (reps,) float32)``: one captured step replayed ``reps`` times on the
    card.  Tensors that ``step`` reads from its closure (params, a frame
    pool) are constants of the program, read in place; a carry passed
    back from the last call is not copied, another one is copied in and
    left as it was."""
    def body(carry, values, reps, device, i):
        carry, value = step(carry, i)
        if value is not None:
            values.index_copy_(0, i, value.reshape(1).to(values.dtype))
        return carry, values

    program = graph.Compiled(body, name, donate={"carry": (0,)},
                             scratch=("values",), steps="reps")

    def run(carry, reps: int, device):
        carry, values = program(carry, _results(reps), reps, device)
        return carry, values[:reps]

    run.program = program
    return run


@graph.compiled("scan.update_scan", static=("cfg", "frame_format"),
                donate={"state": (0,)}, scratch=("bboxes", "scores"),
                steps="n")
def _clip_step(params: Params, state: TrackState, frames, bboxes, scores, n,
               cfg: ModelConfig, frame_format: str, device, i):
    state, bbox, conf = core.update(params, state, _pick(_planes(frames), i),
                                    cfg, frame_format, device)
    bboxes.index_copy_(0, i, bbox[None])
    scores.index_copy_(0, i, conf[None])
    return state, bboxes, scores


def update_scan(params: Params, state: TrackState, frames, cfg: ModelConfig,
                frame_format: str = "rgb", device="cuda"
                ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Track a whole clip.  ``frames``: stacked over frames (module
    docstring).

    Returns (final_state, bboxes (N, 4), scores (N,)).
    """
    n = _length(frames)
    state, bboxes, scores = _clip_step(params, state, frames,
                                       _results(n, 4), _results(n), n, cfg,
                                       frame_format, device)
    return state, bboxes[:n], scores[:n]


@graph.compiled("scan.update_scan_pool",
                static=("cfg", "frame_format", "fused_prep"),
                donate={"state": (0,)}, scratch=("scores",), steps="reps")
def _pool_step(params: Params, state: TrackState, frames, scores, reps,
               cfg: ModelConfig, frame_format: str, fused_prep, device, i):
    planes = _planes(frames)
    frame = _pick(planes, torch.remainder(i, planes[0].shape[0]))
    state, _bbox, conf = core.update(params, state, frame, cfg, frame_format,
                                     device, fused_prep=fused_prep)
    scores.index_copy_(0, i, conf[None])
    return state, scores


def update_scan_pool(params: Params, state: TrackState, frames, reps: int,
                     cfg: ModelConfig, frame_format: str = "nv12",
                     fused_prep=False, device="cuda"
                     ) -> Tuple[TrackState, torch.Tensor]:
    """Benchmark variant: ``reps`` tracked frames cycling through a small
    device-resident frame pool by index.  Returns (state, scores (reps,)).
    ``fused_prep`` routes the NV12 step through the one-kernel preprocess +
    embed (``core.update``)."""
    state, scores = _pool_step(params, state, frames, _results(reps), reps,
                               cfg, frame_format, fused_prep, device)
    return state, scores[:reps]


@graph.compiled("scan.update_streams_scan_pool",
                static=("cfg", "frame_format"), donate={"state": (0,)},
                scratch=("scores",), steps="reps")
def _streams_step(params: Params, state: TrackState, frames, active, scores,
                  reps, cfg: ModelConfig, frame_format: str, device, i):
    planes = _planes(frames)
    n_streams = active.shape[0]
    rows = torch.remainder(i + torch.arange(n_streams, device=i.device),
                           planes[0].shape[0])
    fr = tuple(p.index_select(0, rows) for p in planes)
    state, _bx, sc = multi.update_streams(params, state, fr, active, cfg,
                                          frame_format, device=device)
    scores.index_copy_(0, i, sc[None])
    return state, scores


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

    JAX slices each step's frames out of a cyclically extended pool; with
    the index on the device the step gathers rows ``(i + s) % P`` (one copy
    of the S frames a step)."""
    s, m = np.shape(active)
    state, scores = _streams_step(params, state, frames, active,
                                  _results(reps, s, m), reps, cfg,
                                  frame_format, device)
    return state, scores[:reps]


@graph.compiled("scan.update_objects_scan_pool",
                static=("cfg", "frame_format"), donate={"state": (0,)},
                scratch=("scores",), steps="reps")
def _objects_step(params: Params, state: TrackState, frames, active, scores,
                  reps, cfg: ModelConfig, frame_format: str, device, i):
    planes = _planes(frames)
    frame = _pick(planes, torch.remainder(i, planes[0].shape[0]))
    state, _bx, sc = multi.update_objects(params, state, frame, active, cfg,
                                          frame_format, device=device)
    scores.index_copy_(0, i, sc[None])
    return state, scores


def update_objects_scan_pool(params: Params, state: TrackState, frames,
                             active, reps: int, cfg: ModelConfig,
                             frame_format: str = "nv12", device="cuda"
                             ) -> Tuple[TrackState, torch.Tensor]:
    """``reps`` multi-object steps (N targets, one shared frame per step)
    in one call, cycling the frame pool.  Returns (state, scores
    (reps, N))."""
    state, scores = _objects_step(params, state, frames, active,
                                  _results(reps, *np.shape(active)), reps,
                                  cfg, frame_format, device)
    return state, scores[:reps]


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


def _glyph_table(hud_text) -> Tuple[np.ndarray, Tuple[int, ...],
                                     Tuple[int, ...]]:
    """``hud_text``'s glyphs and the score line's fixed ones as one int32
    array, with the sizes of its pieces and the three lines' counts."""
    prefix, _ = font.encode_text(SCORE_PREFIX, len(SCORE_PREFIX))
    marks = [font.FONT_CHARS.index("."), font.FONT_CHARS.index("%")]
    parts = [np.asarray(c, np.int32) for c, _ in hud_text] + [
        np.asarray(prefix, np.int32), np.asarray(marks, np.int32)]
    return (np.concatenate(parts), tuple(len(p) for p in parts),
            tuple(int(n) for _, n in hud_text))


def _split_glyphs(packed: torch.Tensor, sizes: Sequence[int],
                  counts: Sequence[int]) -> HudGlyphs:
    pieces = torch.split(packed, list(sizes))
    lines = tuple((pieces[k], n) for k, n in enumerate(counts))
    return HudGlyphs(lines, pieces[3], pieces[4][:1], pieces[4][1:])


def hud_glyphs(hud_text, device) -> HudGlyphs:
    """Upload ``hud_text`` (three ``font.encode_text`` results: state, FPS,
    track lines) and the score line's fixed glyphs in one copy.  On the
    card the copy is from pinned memory and asynchronous, so no host sync
    is made."""
    dev = torch.device(device)
    table, sizes, counts = _glyph_table(hud_text)
    packed = torch.from_numpy(table)
    if dev.type == "cuda":
        packed = packed.pin_memory()
    return _split_glyphs(packed.to(dev, non_blocking=True), sizes, counts)


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


@graph.compiled("scan.update_scan_hud_pool", static=("cfg", "sizes",
                                                     "counts"),
                donate={"state": (0,)}, scratch=("display", "scores"),
                steps="reps")
def _hud_step(params: Params, state: TrackState, frames, glyphs, display,
              scores, reps, cfg: ModelConfig, sizes, counts, device, i):
    frame = _pick(frames, torch.remainder(i, frames[0].shape[0]))
    state, bbox, conf = core.update(params, state, frame, cfg, "nv12", device)
    composite_hud(display, frame[0], bbox, conf,
                  _split_glyphs(glyphs, sizes, counts))
    scores.index_copy_(0, i, conf[None])
    return state, display, scores


def update_scan_hud_pool(params: Params, state: TrackState, frames, hud_text,
                         reps: int, cfg: ModelConfig, device="cuda"
                         ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """BASELINE config 5's serving shape: ``reps`` tracked frames cycling
    through an NV12 pool ((P, H, W), (P, H/2, W/2, 2)), every one of them
    composited with the full luma HUD (:func:`composite_hud`) into one
    display buffer that each frame overwrites: the leaky display queue of
    the reference (pipeline_ir.rs:75-78), where a slow consumer sees only
    the newest frame but every frame pays the composite.

    The pool is never written (the HUD goes on the display's copy of the
    frame, as JAX paints a copy).  ``hud_text``: (state, FPS, track) lines
    from ``ops/font.encode_text``; the graph carries the state and the
    display, and its glyph buffer is filled before the replays.  Returns
    (state, display_luma (H, W) uint8, scores (reps,))."""
    ys, uvs = frames
    table, sizes, counts = _glyph_table(hud_text)
    glyphs = torch.from_numpy(table)
    if torch.device(device).type == "cuda":
        glyphs = glyphs.pin_memory()
    display = torch.empty(tuple(ys.shape[1:]), dtype=torch.uint8,
                          device="meta")
    state, display, scores = _hud_step(
        params, state, (ys, uvs), glyphs, display, _results(reps), reps, cfg,
        sizes, counts, device)
    return state, display, scores[:reps]
