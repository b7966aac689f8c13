"""NV12 frame -> embedded search tokens as ONE CUDA kernel, and its plain
version.

Port of ``gstreamer_vit_tracker_tpu/ops/fused_prep_embed.py``.  Its TPU
kernel ``_kernel`` (band -> offset shift -> bilinear window resample ->
BT.601 -> clip / normalise -> patchify -> patch embed -> + pos + bias in
one ``pallas_call``) becomes ``csrc/fused_prep_embed.cu``; the source's
header says what it computes tap by tap and what bounds it on the H100.

:func:`nv12_search_tokens` is the drop-in for ``embed_search(params,
preprocess_nv12(...))`` on the unbatched step, inference only.  It launches
the kernel for CUDA planes (or raises) and takes the plain version
:func:`nv12_search_tokens_reference` for CPU planes; there is no way from
one to the other.  The JAX function refuses to run on its accelerator (its
compiler cannot lower the patchify); nothing of that carries over: on the
card the kernel runs.

``mode`` names the two patchify formulations of the JAX kernel (``"loop"``:
patch-major rows and ``patch`` accumulating products; ``"transpose"``: a
raster crop and one product).  They are one function; the plain version
implements both, the CUDA kernel serves both.

On the card a call on ready parameters is one ``torch.empty`` and one
launch: the kernel reads the window's centre and size where
``crop_window`` left them and works out the band itself, and the embed
weight and ``pos_embed_x + bias`` in the compute dtype, zero-padded to the
plan's width (and the weight split into its two TF32 planes for
``"tf32x3"``), are made once per parameter set (:func:`embed_operands`).
:func:`plan` picks the variant and tiling from the width and dtype before
the launch: ``"mma"`` (bf16, the embed on the tensor cores), ``"tf32x3"``
(float32, the embed on the tensor cores in split TF32); ``"simt"`` (float32
on the FMA units) runs by name only, the yardstick of ``"tf32x3"``, on
widths up to 1024.  Every embed width runs in both dtypes (ViT-H's 1280 in
clusters of 7 x 64 columns in bf16, 6 x 32 in float32); a patch above 32
raises.

``LAUNCHES`` counts kernel launches, ``VARIANT_LAUNCHES`` them by variant.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
import torch.nn.functional as F

from . import attention, cuda_build, operand_cache
from . import preprocess as pp
from .colorspace import BT601_COEFFS
from .vit_block import split_tf32

Params = Dict[str, Any]

__all__ = ["nv12_search_tokens", "nv12_search_tokens_reference",
           "search_pixels_reference", "embed_operands", "kernel_operands",
           "launch", "prepared", "plan", "tiling", "Plan", "LAUNCHES",
           "VARIANT_LAUNCHES"]

# Kernel launches since import (or since a caller reset them to 0), all
# and by variant.
LAUNCHES = 0
VARIANT_LAUNCHES = {"mma": 0, "tf32x3": 0, "simt": 0}

MODES = ("loop", "transpose")
# "tf32x3": 16 tokens x round_up(patch^2 x 3, 32) float32 pixels and the
# warps' sums in a block's 227 KB; "simt": 2 tokens' pixels in 48 KB.
_MAX_PATCH = 32


def _band(y_plane: torch.Tensor, window: pp.CropWindow, band
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, int]:
    """Band geometry of one window on one frame: start_y and start_x
    relative to the band, the int32 origin [row0, col0], and the band's
    size.  Without a band (or on a frame that fits it) the band is the
    frame."""
    h, w = y_plane.shape
    start_y = window.cy - 0.5 * window.size
    start_x = window.cx - 0.5 * window.size
    if band is not None and (h > band or w > band):
        bh, bw = min(band, h), min(band, w)
        row0, col0 = pp.band_origin(window, h, w, band)
        start_y = start_y - row0.to(torch.float32)
        start_x = start_x - col0.to(torch.float32)
    else:
        bh, bw = h, w
        row0 = col0 = torch.zeros((), dtype=torch.int32, device=y_plane.device)
    return start_y, start_x, torch.stack([row0, col0]), bh, bw


def _embed_operands(params: Params, dt: torch.dtype):
    bb = params["backbone"] if "backbone" in params else params
    pe = bb["patch_embed"]
    pos_bias = bb["pos_embed_x"] + pe["bias"][None, :]
    return pe["kernel"].to(dt), pos_bias.to(dt)


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_planes(y_plane: torch.Tensor, uv_plane: torch.Tensor,
                  window: pp.CropWindow, cfg: ModelConfig, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    if window.size.dim() != 0:
        raise ValueError("the fused preprocess + embed takes one window "
                         "(the unbatched step)")
    if y_plane.dim() != 2 or y_plane.dtype != torch.uint8:
        raise ValueError(f"y_plane must be (H, W) uint8, got "
                         f"{tuple(y_plane.shape)} {y_plane.dtype}")
    h, w = y_plane.shape
    if h % 2 or w % 2 or tuple(uv_plane.shape) != (h // 2, w // 2, 2) \
            or uv_plane.dtype != torch.uint8:
        raise ValueError(f"uv_plane must be ({h // 2}, {w // 2}, 2) uint8 for "
                         f"an even-sized frame, got {tuple(uv_plane.shape)} "
                         f"{uv_plane.dtype}")
    if cfg.search_size % cfg.patch_size:
        raise ValueError("search_size must be a multiple of patch_size")


def _hat(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Bilinear hat weight max(0, 1 - |t - j|) in float32."""
    return torch.clamp_min(1.0 - torch.abs(t - j), 0.0)


def _crop(y_plane: torch.Tensor, uv_plane: torch.Tensor,
          window: pp.CropWindow, cfg: ModelConfig, mode: str) -> torch.Tensor:
    """The normalised crop (S, S, 3) in float32 as the JAX kernel body makes
    it before the patch embed: dense sampling matrices generated from index
    grids, chroma matrices generated pair-folded on the interleaved byte
    columns, rounding to the compute dtype where it rounds.  In ``"loop"``
    mode its rows are patch-major (row p * g + gh is pixel row gh * patch +
    p)."""
    dt = _compute_dtype(cfg)
    f32 = torch.float32
    dev = y_plane.device
    out_size, patch = cfg.search_size, cfg.patch_size
    g = out_size // patch
    sy, sx, origin, bh, bw = _band(y_plane, window, cfg.preprocess_band)
    sc = (window.size / out_size).to(f32)
    sy, sx = sy.to(f32), sx.to(f32)
    # Index gathers, not slices: the origin stays on the device.
    rows = origin[0] + torch.arange(bh, device=dev, dtype=torch.int32)
    cols = origin[1] + torch.arange(bw, device=dev, dtype=torch.int32)
    y_band = y_plane[rows[:, None], cols[None, :]]
    uv_flat = uv_plane.reshape(y_plane.shape[0] // 2, y_plane.shape[1])
    rows2 = torch.div(origin[0], 2, rounding_mode="floor") + torch.arange(
        bh // 2, device=dev, dtype=torch.int32)
    uv_band = uv_flat[rows2[:, None], cols[None, :]]    # raw U, V byte order

    r = torch.arange(out_size, dtype=f32, device=dev)[:, None]
    o_row = r
    if mode == "loop":
        # Patch-major output rows r = p * g + gh come from pixel row
        # y = gh * patch + p.
        o_row = torch.floor(r / g) + (r - torch.floor(r / g) * g) * patch

    def coord(start, o):
        return start + (o + 0.5) * sc - 0.5

    def full(t, n):
        j = torch.arange(n, dtype=f32, device=dev)[None, :]
        return _hat(t, j).to(dt)

    def half(t, n):
        j = torch.arange(n, dtype=f32, device=dev)[None, :]
        return (_hat(t, 2.0 * j) + _hat(t, 2.0 * j + 1.0)).to(dt)

    ty, tx = coord(sy, o_row), coord(sx, r)
    ry, ry_uv, cx = full(ty, bh), half(ty, bh // 2), full(tx, bw)
    s = torch.arange(bw, dtype=f32, device=dev)[None, :]
    even = (s - 2.0 * torch.floor(s / 2.0)) < 0.5
    zero = torch.zeros((), dtype=f32, device=dev)
    cx_u = torch.where(even, _hat(tx, s) + _hat(tx, s + 1.0), zero).to(dt)
    cx_v = torch.where(even, zero, _hat(tx, s - 1.0) + _hat(tx, s)).to(dt)

    yp = (y_band.to(f32) - 16.0).to(dt)
    uvp = (uv_band.to(f32) - 128.0).to(dt)

    def mm(a, b):            # a @ b with float32 accumulation and result
        return a.to(f32) @ b.to(f32)

    tmp_y = mm(ry, yp).to(dt)
    yc = mm(tmp_y, cx.T)                                 # (S, S) float32
    tmp_uv = mm(ry_uv, uvp).to(dt)
    uc = mm(tmp_uv, cx_u.T)
    vc = mm(tmp_uv, cx_v.T)

    c = BT601_COEFFS
    yv = c["y"] * yc
    planes = (yv + c["rv"] * vc,
              yv + c["gu"] * uc + c["gv"] * vc,
              yv + c["bu"] * uc)
    planes = [(torch.clamp(p, 0.0, 255.0) / 255.0 - cfg.norm_mean[i])
              / cfg.norm_std[i] for i, p in enumerate(planes)]
    return torch.stack(planes, dim=-1)


def _patches(crop: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A ``"transpose"``-mode crop patchified: (N, patch^2 x 3), k = (p, q,
    c)."""
    g, patch = cfg.search_size // cfg.patch_size, cfg.patch_size
    x = crop.reshape(g, patch, g, patch, 3).permute(0, 2, 1, 3, 4)
    return x.reshape(g * g, patch * patch * 3)


def search_pixels_reference(y_plane: torch.Tensor, uv_plane: torch.Tensor,
                            window: pp.CropWindow, cfg: ModelConfig
                            ) -> torch.Tensor:
    """The patch pixels the embed multiplies, (N, patch^2 x 3) in the
    compute dtype: what the kernel's A tile holds."""
    dt = _compute_dtype(cfg)
    _check_planes(y_plane, uv_plane, window, cfg, "transpose")
    return _patches(_crop(y_plane, uv_plane, window, cfg, "transpose"),
                    cfg).to(dt)


def nv12_search_tokens_reference(params: Params, y_plane: torch.Tensor,
                                 uv_plane: torch.Tensor,
                                 window: pp.CropWindow, cfg: ModelConfig,
                                 mode: str = "loop") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX kernel body operation
    by operation (:func:`_crop`, then the patch embed as its ``mode``
    takes it), rounding where it rounds.  (N, D) tokens in the compute
    dtype."""
    _check_planes(y_plane, uv_plane, window, cfg, mode)
    dt = _compute_dtype(cfg)
    f32 = torch.float32
    g = cfg.search_size // cfg.patch_size
    n_tok, patch = g * g, cfg.patch_size
    crop = _crop(y_plane, uv_plane, window, cfg, mode)

    def mm(a, b):            # a @ b with float32 accumulation and result
        return a.to(f32) @ b.to(f32)

    w_embed, pos_bias = _embed_operands(params, dt)
    if mode == "transpose":
        tok = mm(_patches(crop, cfg).to(dt), w_embed)
    else:
        inter = crop.reshape(cfg.search_size, cfg.search_size * 3)
        kp = patch * 3
        tok = torch.zeros((n_tok, w_embed.shape[1]), dtype=f32,
                          device=y_plane.device)
        for p in range(patch):
            a = inter[p * g:(p + 1) * g].reshape(n_tok, kp)
            tok = tok + mm(a.to(dt), w_embed[p * kp:(p + 1) * kp])
    return (tok.to(dt) + pos_bias).to(dt)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """What one launch of the kernel runs (``csrc/fused_prep_embed.cu``)."""
    variant: str          # "mma" (bf16), "tf32x3" or "simt" (float32)
    tokens: int           # tokens a CTA
    cols: int = 0         # embed columns a CTA ("simt" makes them all)
    cluster: int = 1      # CTAs of a cluster sharing a token tile's pixels
    width: int = 0        # the operands' columns: the embed dim padded


# kTileTokens, kTileCols and kMaxCluster of the source; the widest embed
# "simt" takes (a thread of its 256 a 4-column group).
_TILE_TOKENS, _TILE_COLS, _MAX_CLUSTER = 16, 32, 8
_SIMT_MAX_DIM = 1024
_VARIANT_CODES = {"simt": 0, "mma": 1, "tf32x3": 2}
_SIMT_TOKENS = 2
# "mma"'s column tile where a token tile needs more than one cluster of 32
# columns (D above 256): 64 columns in clusters of up to 8 (at D 384 and 768
# 64 columns read faster than 32 in clusters of 6 and 8 at the default
# search of 256, slower at a search of 128; profile_prep.py, PERF.md).
_WIDE_COLS = 64
# "tf32x3"'s column tiles (the source builds 8, 16, 24 and 32), and its
# largest cluster: clusters of 8 of its one-CTA-an-SM blocks read 1.6-2.0x
# slower than clusters of 6 at the flagship's grid (profile_prep.py).
_TF32_COLS = (8, 16, 24, 32)
_TF32_MAX_CLUSTER = 6


def tiling(dim: int, cols: int, max_cluster: int = _MAX_CLUSTER
           ) -> Tuple[int, int]:
    """(cluster, width) of ``cols``-column tiles for embed width ``dim``:
    the fewest clusters of at most ``max_cluster`` that cover it, of equal
    size, and the width they cover (``dim`` padded; its columns past
    ``dim`` are zero in the operands)."""
    tiles = -(-dim // cols)
    clusters = -(-tiles // max_cluster)
    cluster = -(-tiles // clusters)
    return cluster, clusters * cluster * cols


def plan(dim: int, dtype: torch.dtype, variant: Optional[str] = None,
         cols: Optional[int] = None) -> Plan:
    """The variant and tiling for embed width ``dim`` in ``dtype``: a pure
    function of the shape.  Every ``dim`` from 1 runs (``"simt"`` by name
    up to 1024).

    * bf16 takes ``"mma"`` (``mma.sync`` m16n8k16): CTAs of 16 tokens by 32
      columns, the column tiles of a token tile one cluster that shares the
      pixel phase; above D 256 (more than 8 tiles) CTAs of 64 columns in
      equal clusters of up to 8, each cluster making the pixels again
      (``cols`` 32 or 64 by name).  At the flagship's (256 tokens, D 192)
      that is 16 x 6 = 96 CTAs in clusters of 6, each making a sixth of its
      tile's pixels and reading a 32-column sixth of the weight once (the
      fastest of the tilings ``profile_prep.py`` times on the H100;
      PERF.md).
    * float32 takes ``"tf32x3"`` (split-TF32 ``mma.sync`` m16n8k8, float32's
      accuracy) on the narrowest column tile (8, 16, 24 or 32; ``cols`` by
      name) whose tiles make one cluster of at most 6, else 32 columns in
      equal clusters of at most 6: 32 at the flagship's D 192 (clusters of
      6), 16 at ``small``'s D 96 (6) and corr-tiny's D 64 (4), 32 in 7
      clusters of 6 at ViT-H's D 1280.
      ``variant="simt"`` (FMA units, two tokens a CTA, the width padded to a
      multiple of 4, at most 1024) by name: the yardstick.

    ``dim`` is padded to the plan's ``width`` (a multiple of the column
    tile and of the clusters).  Another dtype or a variant the dtype does
    not take raises ``TypeError``, a width below 1 (or for ``"simt"``
    above 1024) or a column tile not built ``ValueError``."""
    if dim < 1:
        raise ValueError(f"embed dim {dim} below 1")
    if dtype == torch.float32:
        variant = variant or "tf32x3"
        if variant == "simt":
            if dim > _SIMT_MAX_DIM:
                raise ValueError(f"simt takes embed dims up to "
                                 f"{_SIMT_MAX_DIM}, not {dim}")
            return Plan("simt", _SIMT_TOKENS, 0, 1, -(-dim // 4) * 4)
        if variant != "tf32x3":
            raise TypeError(f"float32 runs tf32x3 or simt, not {variant}")
        cols = cols or next((c for c in _TF32_COLS
                             if -(-dim // c) <= _TF32_MAX_CLUSTER),
                            _TF32_COLS[-1])
        if cols not in _TF32_COLS:
            raise ValueError(f"tf32x3 takes {_TF32_COLS} columns a CTA, not "
                             f"{cols}")
        return Plan("tf32x3", _TILE_TOKENS, cols,
                    *tiling(dim, cols, _TF32_MAX_CLUSTER))
    if dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")
    if (variant or "mma") != "mma":
        raise TypeError(f"bfloat16 runs mma, not {variant}")
    cols = cols or (_TILE_COLS if dim <= _TILE_COLS * _MAX_CLUSTER
                    else _WIDE_COLS)
    if cols not in (32, 64):
        raise ValueError(f"mma takes 32 or 64 columns a CTA, not {cols}")
    return Plan("mma", _TILE_TOKENS, cols, *tiling(dim, cols))


_FORWARD: list = []      # the C entry, once loaded


def bind(lib: ctypes.CDLL):
    """The C entry of a loaded ``fused_prep_embed`` library, its signature
    declared: it takes :func:`_arguments`' tuple and the stream."""
    fn = lib.fused_prep_embed_forward
    fn.argtypes = ([ctypes.c_int] * 10 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    return fn


def _entry():
    if not _FORWARD:
        _FORWARD.append(bind(cuda_build.load("fused_prep_embed")))
    return _FORWARD[0]


# The embed weight and pos + bias as a plan reads them, made once per
# parameter set.
_OPERANDS = operand_cache.OperandCache()


def _leaves(params: Params) -> Tuple[torch.Tensor, ...]:
    bb = params["backbone"] if "backbone" in params else params
    return bb["patch_embed"]["kernel"], bb["pos_embed_x"], \
        bb["patch_embed"]["bias"]


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (what the kernel reads),
    copied only if it is not."""
    if t.is_contiguous() and not t.data_ptr() % 16:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def embed_operands(params: Params, dt: torch.dtype,
                   chosen: Optional[Plan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(embed weight, pos_embed_x + bias (N, W)) in ``dt`` as ``chosen``
    (default: :func:`plan` of the embed width) reads them: the plain
    version's, zero-padded to the plan's width W; the weight (K, W), or for
    ``"tf32x3"`` its two planes (2, K, W), hi = tf32(w) then lo = tf32(w -
    hi) (``vit_block.split_tf32``).  Reused while every leaf is the same
    tensor at the same ``_version`` (an optimiser step moves it on), made
    anew otherwise; made on every call, and not kept, when a gradient is
    wanted (the kernel has no backward: inference only)."""
    leaves = _leaves(params)
    chosen = chosen or plan(leaves[0].shape[-1], dt)

    def make():
        w, pos_bias = (F.pad(t, (0, chosen.width - t.shape[-1]))
                       for t in _embed_operands(params, dt))
        if chosen.variant == "tf32x3":
            w = torch.stack(split_tf32(w))
        return _ready(w), _ready(pos_bias)

    return _OPERANDS.get((dt, chosen.variant, chosen.width), leaves, make)


def kernel_operands(params: Params, y_plane: torch.Tensor,
                    uv_plane: torch.Tensor, window: pp.CropWindow,
                    cfg: ModelConfig, chosen: Optional[Plan] = None):
    """What the kernel reads: the planes as they lie (a copy only of one it
    cannot read in place), the window's float32 centre and size as they lie
    (the kernel works out the band and the start from them), the embed
    weight and pos + bias from :func:`embed_operands` for ``chosen``
    (default: the plan).  No PyTorch op runs for a call on ready parameters
    and planes."""
    dev = y_plane.device
    if uv_plane.device != dev:
        raise ValueError("y_plane and uv_plane lie on different devices")
    w_embed, pos_bias = embed_operands(params, _compute_dtype(cfg), chosen)
    y = y_plane if y_plane.is_contiguous() else y_plane.contiguous()
    uv = uv_plane if uv_plane.is_contiguous() and not uv_plane.data_ptr() % 2 \
        else uv_plane.clone(memory_format=torch.contiguous_format)
    scalars = tuple(t if t.dtype == torch.float32 and t.device == dev
                    else t.to(dev, torch.float32) for t in window)
    return (y, uv, *scalars, w_embed, pos_bias)


def _arguments(y_plane, uv_plane, cx, cy, size, w_embed, pos_bias,
               cfg: ModelConfig, chosen: Optional[Plan] = None):
    """Checks, the plan (``chosen``, default :func:`plan` of the config's
    embed width in the operands' dtype), the output and the C entry's
    arguments up to the stream."""
    if not y_plane.is_cuda:
        raise ValueError("the fused preprocess + embed kernel needs CUDA "
                         "tensors")
    if cfg.patch_size > _MAX_PATCH:
        raise ValueError(f"patch size {cfg.patch_size} above {_MAX_PATCH}")
    dev, dt, dim = y_plane.device, pos_bias.dtype, cfg.embed_dim
    chosen = chosen or plan(dim, dt)
    if (chosen.variant == "mma") != (dt == torch.bfloat16) \
            or w_embed.dtype != dt:
        raise TypeError(f"variant {chosen.variant} on embed weight "
                        f"{w_embed.dtype} and pos + bias {dt}")
    n_tok, k = (cfg.search_size // cfg.patch_size) ** 2, cfg.patch_size ** 2 * 3
    planes = (2,) if chosen.variant == "tf32x3" else ()
    if tuple(w_embed.shape) != (*planes, k, chosen.width) \
            or tuple(pos_bias.shape) != (n_tok, chosen.width) \
            or not dim <= chosen.width:
        raise ValueError(
            f"patch embed {tuple(w_embed.shape)} / pos embed "
            f"{tuple(pos_bias.shape)} do not fit search {cfg.search_size}, "
            f"patch {cfg.patch_size}, embed dim {dim} as {chosen}")
    for t in (y_plane, uv_plane, w_embed, pos_bias):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("every operand must be contiguous on the "
                             "planes' device")
    for t in (cx, cy, size):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError("the window's cx, cy and size must be one "
                             "float32 each on the planes' device")
    if w_embed.data_ptr() % 16 or uv_plane.data_ptr() % 2:
        raise ValueError("the embed weight must be 16-byte aligned, the UV "
                         "plane 2-byte aligned")
    h, w = y_plane.shape
    out = torch.empty((n_tok, dim), dtype=dt, device=dev)
    args = (_VARIANT_CODES[chosen.variant], chosen.cols, chosen.cluster, h, w,
            cfg.preprocess_band or 0, cfg.search_size, cfg.patch_size, dim,
            chosen.width, *cfg.norm_mean, *cfg.norm_std,
            y_plane.data_ptr(), uv_plane.data_ptr(), cx.data_ptr(),
            cy.data_ptr(), size.data_ptr(), w_embed.data_ptr(),
            pos_bias.data_ptr(), out.data_ptr())
    return chosen, out, args


def _enqueue(chosen: Plan, args: Tuple, index: int) -> None:
    """Launch on the current stream of device ``index`` (the current
    device), check the launch, count it."""
    global LAUNCHES
    err = _entry()(*args, attention._stream_handle(index))
    if err != 0:
        raise RuntimeError(f"fused_prep_embed_forward ({chosen}) failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[chosen.variant] += 1


def launch(y_plane: torch.Tensor, uv_plane: torch.Tensor, cx: torch.Tensor,
           cy: torch.Tensor, size: torch.Tensor, w_embed: torch.Tensor,
           pos_bias: torch.Tensor, cfg: ModelConfig,
           chosen: Optional[Plan] = None) -> torch.Tensor:
    """One launch of the kernel on :func:`kernel_operands` (made for the
    same ``chosen``) into a new (N, D) tensor; raises on what the kernel
    does not take (:func:`plan`) or if the launch fails."""
    index = y_plane.device.index
    if y_plane.is_cuda and index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch(y_plane, uv_plane, cx, cy, size, w_embed, pos_bias,
                          cfg, chosen)
    chosen, out, args = _arguments(y_plane, uv_plane, cx, cy, size, w_embed,
                                   pos_bias, cfg, chosen)
    _enqueue(chosen, args, index)
    return out


def prepared(params: Params, y_plane: torch.Tensor, uv_plane: torch.Tensor,
             window: pp.CropWindow, cfg: ModelConfig,
             chosen: Optional[Plan] = None):
    """``(out, launch)``: ``launch()`` enqueues the kernel on these operands
    into ``out`` again and nothing else, on the current stream of the
    current device; ``chosen`` another variant or tiling than the plan's
    (``simt`` by name, the wide tilings).  For timing a launch apart from
    the wrapper, and for capture into a CUDA graph."""
    ops = kernel_operands(params, y_plane, uv_plane, window, cfg, chosen)
    chosen, out, args = _arguments(*ops, cfg, chosen)
    index = y_plane.device.index

    def launch(keep=(ops, out)):   # the operands live as long as launch does
        _enqueue(chosen, args, index)

    return out, launch


def nv12_search_tokens(params: Params, y_plane: torch.Tensor,
                       uv_plane: torch.Tensor, window: pp.CropWindow,
                       cfg: ModelConfig, mode: str = "loop") -> torch.Tensor:
    """Fused NV12 frame -> embedded search tokens (N, D), pos embed
    included.  ``y_plane`` (H, W) and ``uv_plane`` (H/2, W/2, 2) uint8;
    ``window`` one crop window (0-d tensors); a frame larger than
    ``cfg.preprocess_band`` is banded as ``preprocess_nv12`` bands it.  The
    CUDA kernel for CUDA planes (raises if it cannot launch): on ready
    parameters one ``torch.empty`` and one launch, nothing read back; the
    plain version for CPU planes."""
    if not y_plane.is_cuda:
        return nv12_search_tokens_reference(params, y_plane, uv_plane, window,
                                            cfg, mode)
    _check_planes(y_plane, uv_plane, window, cfg, mode)
    return launch(*kernel_operands(params, y_plane, uv_plane, window, cfg),
                  cfg)
