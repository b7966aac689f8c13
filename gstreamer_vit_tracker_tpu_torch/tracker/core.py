"""Tracker core: ``init(frame, bbox) -> TrackState`` and
``update(TrackState, frame) -> (TrackState, bbox, score)``.

Port of ``gstreamer_vit_tracker_tpu/tracker/core.py``:

    banded crop/resize/colorspace/normalise (resample products)
      -> patch embed -> joint ViT encode (CUDA encoder kernel)
      -> conv heads -> hanning-penalty decode -> bbox with clamps and freezes

Frames are RGB (H, W, 3), NV12 planes ((H, W), (H/2, W/2, 2)) or packed
YUY2 (H, W*2), uint8; the three adapters share one core.  On NV12 frames
``update(fused_prep=...)`` takes preprocess and patch embed as one CUDA
kernel (``ops/fused_prep_embed.py``), and ``update(fused_embed=True)``
takes the patch-major crop and ``embed_search_patches`` for any format.

Every value of the step stays a tensor on the device, so a CUDA update
enqueues its work without reading anything back; :func:`update_packed`
returns the five numbers a caller reads as one tensor.

``init_jit``, ``update_jit`` and ``update_packed_jit`` are the compiled
entry points (``utils/graph.py``): one CUDA graph per key, replayed, the
state donated by the two updates, as JAX's ``jax.jit`` programs are.

Where JAX adds object and stream axes with ``vmap`` (tracker/multi.py), the
step here takes them written out: a state whose fields carry leading
dimensions ((N,) objects of one frame, or (S, M) streams and objects) with
a frame that carries the first of them ((S,) frames, each shared by its M
objects).  One body serves the unbatched step and the batch.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import heads as heads_mod
from ..models import vittrack
from ..ops import fused_prep_embed as fpe
from ..ops import preprocess as pp
from ..utils import graph
from .state import TrackState

Params = Dict[str, Any]


def _prep_dtype(cfg: ModelConfig) -> torch.dtype:
    """Preprocess in the model's compute dtype, as the JAX package does
    (pixel integers <= 255 are exact in bf16)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


FORMATS = ("rgb", "nv12", "yuy2")


def _frame_on(frame, frame_format: str, dev: torch.device
              ) -> Tuple[torch.Tensor, ...]:
    """The frame's planes as a tuple of tensors on ``dev``: (Y, UV) for
    NV12, one plane for RGB and YUY2.  A tuple this function made passes
    through, so callers may place a frame once and step on it many times."""
    if frame_format not in FORMATS:
        raise ValueError(f"unknown frame format {frame_format!r}")
    if frame_format == "nv12":
        planes = tuple(frame)
        if len(planes) != 2:
            raise ValueError("an nv12 frame is a (Y, UV) pair of planes")
    else:
        planes = frame if isinstance(frame, tuple) else (frame,)
        if len(planes) != 1:
            raise ValueError(f"a {frame_format} frame is one array, got a "
                             f"tuple of {len(planes)}")
    return tuple(torch.as_tensor(p, device=dev) for p in planes)


def frame_shape(frame, frame_format: str) -> Tuple[int, int]:
    """(height, width) in pixels of a frame :func:`_frame_on` placed."""
    h, w = frame[0].shape[-3:-1] if frame_format == "rgb" \
        else frame[0].shape[-2:]
    return (h, w // 2) if frame_format == "yuy2" else (h, w)


def _prep_rgb(frame, window: pp.CropWindow, out_size: int, cfg: ModelConfig,
              patch_major: Optional[int] = None) -> torch.Tensor:
    return pp.preprocess_rgb(frame[0], window, out_size, cfg.norm_mean,
                             cfg.norm_std, dtype=_prep_dtype(cfg),
                             band=cfg.preprocess_band,
                             patch_major=patch_major)


def _prep_nv12(frame, window: pp.CropWindow, out_size: int, cfg: ModelConfig,
               patch_major: Optional[int] = None) -> torch.Tensor:
    y_plane, uv_plane = frame
    return pp.preprocess_nv12(y_plane, uv_plane, window, out_size,
                              cfg.norm_mean, cfg.norm_std,
                              dtype=_prep_dtype(cfg),
                              band=cfg.preprocess_band,
                              patch_major=patch_major)


def _prep_yuy2(frame, window: pp.CropWindow, out_size: int, cfg: ModelConfig,
               patch_major: Optional[int] = None) -> torch.Tensor:
    return pp.preprocess_yuy2(frame[0], window, out_size, cfg.norm_mean,
                              cfg.norm_std, dtype=_prep_dtype(cfg),
                              band=cfg.preprocess_band,
                              patch_major=patch_major)


_PREPS: Dict[str, Callable] = {"rgb": _prep_rgb, "nv12": _prep_nv12,
                               "yuy2": _prep_yuy2}


def _rows(t: torch.Tensor, keep: int) -> torch.Tensor:
    """Every leading dimension before the last ``keep`` as one batch
    dimension (a batch of 1 for an unbatched tensor)."""
    return t.reshape(-1, *t.shape[-keep:])


@functools.lru_cache(maxsize=None)
def _hann(fs: int, mode: str, device: torch.device) -> torch.Tensor:
    return heads_mod.hanning_2d(fs, mode, device)


@functools.lru_cache(maxsize=None)
def _frame_limits(fw: int, fh: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([fw, fh], dtype=torch.float32, device=device)


def init(params: Params, frame, bbox, cfg: ModelConfig,
         frame_format: str = "rgb", device="cuda") -> TrackState:
    """Capture the template and start a track.  ``bbox`` = (x, y, w, h) in
    frame pixels; ``frame`` in ``frame_format`` (module docstring).
    Batched: ``bbox`` (..., 4) with frames on its first dimensions (module
    docstring).  The state keeps copies, never the caller's buffers."""
    dev = resolve_device(device)
    frame = _frame_on(frame, frame_format, dev)
    bbox = torch.as_tensor(bbox, dtype=torch.float32, device=dev).clone()
    lead = bbox.shape[:-1]
    window = pp.crop_window(bbox, cfg.template_factor)
    z_img = _PREPS[frame_format](frame, window, cfg.template_size, cfg)
    z_tok = vittrack.embed_template(params, _rows(z_img, 3), cfg)
    z_tok = z_tok.reshape(*lead, *z_tok.shape[-2:])
    return TrackState(
        z_tok=z_tok,
        z_tok_init=z_tok.clone(),
        bbox=bbox,
        score=torch.ones(lead, dtype=torch.float32, device=dev),
        frame_idx=torch.zeros(lead, dtype=torch.int32, device=dev),
        lost_frames=torch.zeros(lead, dtype=torch.int32, device=dev),
    )


def update(params: Params, state: TrackState, frame, cfg: ModelConfig,
           frame_format: str = "rgb", device="cuda",
           use_kernel: Optional[bool] = None, fused: Optional[bool] = None,
           fused_embed: bool = False, fused_prep=False
           ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Track one frame.  Returns (new_state, bbox_xywh, confidence), each
    with the state's leading dimensions.

    ``fused`` and ``use_kernel`` are those of ``models/vit.py::encode``:
    the batched callers (tracker/multi.py) pass ``fused=False``, the
    per-block route.  ``fused_embed`` routes the preprocess through the
    patch-major crop and ``embed_search_patches``.  ``fused_prep`` (NV12
    frames, the unbatched step) takes the whole preprocess + patch embed
    as one CUDA kernel, ``ops/fused_prep_embed.py``: ``True`` selects the
    default patchify formulation, a string (``"loop"`` / ``"transpose"``)
    names one; on other formats it is ignored, as in JAX."""
    dev = resolve_device(device)
    frame = _frame_on(frame, frame_format, dev)
    prep = _PREPS[frame_format]
    fh, fw = frame_shape(frame, frame_format)
    lead = state.bbox.shape[:-1]

    # Re-detection ramp: while confidence stays below the freeze threshold
    # the search window grows geometrically (capped); lost_frames == 0
    # leaves the factor exact.
    factor = cfg.search_factor
    if cfg.lost_window_growth > 1.0:
        expand = torch.clamp_max(
            torch.pow(cfg.lost_window_growth, state.lost_frames.float()),
            cfg.lost_window_max_growth)
        factor = cfg.search_factor * expand
    window = pp.crop_window(state.bbox, factor)
    if cfg.preprocess_band is not None and cfg.lost_window_growth > 1.0:
        # A ramped window larger than the band would search zero padding.
        window = window._replace(
            size=torch.clamp_max(window.size, float(cfg.preprocess_band)))
    if fused_prep and frame_format == "nv12":
        mode = fused_prep if isinstance(fused_prep, str) else "loop"
        x_tok = fpe.nv12_search_tokens(params, frame[0], frame[1], window,
                                       cfg, mode=mode)[None]
        maps = vittrack.forward_tokens(params, _rows(state.z_tok, 2), x_tok,
                                       cfg, use_kernel=use_kernel, fused=fused)
    elif fused_embed:
        patches = prep(frame, window, cfg.search_size, cfg,
                       patch_major=cfg.patch_size)
        x_tok = vittrack.embed_search_patches(params, _rows(patches, 3), cfg)
        maps = vittrack.forward_tokens(params, _rows(state.z_tok, 2), x_tok,
                                       cfg, use_kernel=use_kernel, fused=fused)
    else:
        x_img = prep(frame, window, cfg.search_size, cfg)
        maps = vittrack.forward(params, _rows(state.z_tok, 2),
                                _rows(x_img, 3), cfg, use_kernel=use_kernel,
                                fused=fused)

    hann = _hann(cfg.feat_size, cfg.hann_mode, dev)
    prev_wh = state.bbox[..., 2:4]
    side = window.size[..., None]
    bbox_norm, conf = heads_mod.decode_maps(
        maps.score.reshape(*lead, *maps.score.shape[1:]),
        maps.offset.reshape(*lead, *maps.offset.shape[1:]),
        maps.size.reshape(*lead, *maps.size.shape[1:]), hann, prev_wh / side)
    gate = conf[..., None]

    # Crop-normalised (cx, cy, w, h) back to frame pixels.
    lim = _frame_limits(fw, fh, dev)
    origin = torch.stack([window.cx, window.cy], dim=-1) - 0.5 * side
    cxy = origin + bbox_norm[..., 0:2] * side
    wh = torch.minimum(torch.clamp_min(bbox_norm[..., 2:4] * side, 1.0), lim)
    if cfg.size_rate_limit > 0.0:
        # Plausibility clamp on the per-frame size change.
        r = 1.0 + cfg.size_rate_limit
        wh = torch.minimum(torch.maximum(wh, prev_wh / r), prev_wh * r)
    if cfg.size_conf_freeze > 0.0:
        # Half-confident frames update position only.
        wh = torch.where(gate > cfg.size_conf_freeze, wh, prev_wh)
    xy = torch.minimum(torch.clamp_min(cxy - 0.5 * wh, 0.0), lim - wh)
    new_bbox = torch.cat([xy, wh], dim=-1)
    if cfg.window_freeze_threshold > 0.0:
        # Low confidence: hold the previous bbox so the search window stays
        # where the target vanished.
        new_bbox = torch.where(gate > cfg.window_freeze_threshold,
                               new_bbox, state.bbox)

    confident = conf > cfg.window_freeze_threshold
    new_state = TrackState(
        z_tok=state.z_tok,
        z_tok_init=state.z_tok_init,
        bbox=new_bbox,
        score=conf,
        frame_idx=state.frame_idx + 1,
        lost_frames=torch.where(confident, torch.zeros_like(state.lost_frames),
                                state.lost_frames + 1),
    )

    if cfg.template_update_enabled:
        new_state = _maybe_update_template(params, new_state, frame, cfg,
                                           prep)

    return new_state, new_bbox, conf


def _maybe_update_template(params: Params, state: TrackState, frame,
                           cfg: ModelConfig, prep: Callable) -> TrackState:
    """Online template update: on a confident frame at the configured
    interval, re-embed the template at the current bbox and blend it with
    the initial template.  A masked ``where``, as in JAX, so the step
    reads no flag back to the host."""
    do = torch.logical_and(
        state.score > cfg.template_update_threshold,
        (state.frame_idx % cfg.template_update_interval) == 0)
    window = pp.crop_window(state.bbox, cfg.template_factor)
    z_img = prep(frame, window, cfg.template_size, cfg)
    z_new = vittrack.embed_template(params, _rows(z_img, 3), cfg)
    z_new = z_new.reshape(state.z_tok.shape)
    a = cfg.template_update_anchor
    blended = (a * state.z_tok_init.float()
               + (1.0 - a) * z_new.float()).to(state.z_tok.dtype)
    return state._replace(
        z_tok=torch.where(do[..., None, None], blended, state.z_tok))


def update_packed(params: Params, state: TrackState, frame, cfg: ModelConfig,
                  frame_format: str = "rgb", device="cuda", **route
                  ) -> Tuple[TrackState, torch.Tensor]:
    """Like :func:`update` but returns (state, packed) with ``packed`` =
    [x, y, w, h, score], one (..., 5) tensor, so a caller reads the result
    with one device-to-host copy.  ``route`` passes ``update``'s options
    (``fused_prep`` ...) through."""
    new_state, bbox, conf = update(params, state, frame, cfg, frame_format,
                                   device, **route)
    return new_state, torch.cat([bbox, conf[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Compiled entry points (the donated state: static buffers the replay
# updates in place)
# ---------------------------------------------------------------------------

init_jit = graph.Compiled(init, "core.init_jit",
                          static=("cfg", "frame_format"))


@graph.compiled("core.update_jit", static=("cfg", "frame_format"),
                donate={"state": (0,)})
def update_jit(params: Params, state: TrackState, frame, cfg: ModelConfig,
               frame_format: str = "rgb", device="cuda"
               ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """:func:`update` compiled, the state donated."""
    return update(params, state, frame, cfg, frame_format, device)


@graph.compiled("core.update_packed_jit", static=("cfg", "frame_format"),
                donate={"state": (0,)})
def update_packed_jit(params: Params, state: TrackState, frame,
                      cfg: ModelConfig, frame_format: str = "rgb",
                      device="cuda") -> Tuple[TrackState, torch.Tensor]:
    """:func:`update_packed` compiled, the state donated: (state, packed
    (..., 5)), the packed row a fresh tensor every call."""
    return update_packed(params, state, frame, cfg, frame_format, device)
