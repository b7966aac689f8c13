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

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from ..config import ModelConfig
from . import cuda_build
from . import preprocess as pp
from .colorspace import BT601_COEFFS

Params = Dict[str, Any]

__all__ = ["nv12_search_tokens", "nv12_search_tokens_reference",
           "kernel_operands", "launch", "LAUNCHES"]

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

MODES = ("loop", "transpose")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_PATCH = 32     # 2 tokens x patch^2 x 3 float32 pixels well inside 48 KB


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


def nv12_search_tokens_reference(params: Params, y_plane: torch.Tensor,
                                 uv_plane: torch.Tensor,
                                 window: pp.CropWindow, cfg: ModelConfig,
                                 mode: str = "loop") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX kernel body operation
    by operation (dense sampling matrices generated from index grids,
    chroma matrices generated pair-folded on the interleaved byte columns),
    rounding where it rounds.  (N, D) tokens in the compute dtype."""
    _check_planes(y_plane, uv_plane, window, cfg, mode)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    f32 = torch.float32
    dev = y_plane.device
    out_size, patch = cfg.search_size, cfg.patch_size
    g = out_size // patch
    n_tok = g * g
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

    w_embed, pos_bias = _embed_operands(params, dt)
    crop = torch.stack(planes, dim=-1)                   # (S, S, 3) float32
    if mode == "transpose":
        x = crop.reshape(g, patch, g, patch, 3).permute(0, 2, 1, 3, 4)
        tok = mm(x.reshape(n_tok, patch * patch * 3).to(dt), w_embed)
    else:
        inter = crop.reshape(out_size, out_size * 3)
        kp = patch * 3
        tok = torch.zeros((n_tok, w_embed.shape[1]), dtype=f32, device=dev)
        for p in range(patch):
            a = inter[p * g:(p + 1) * g].reshape(n_tok, kp)
            tok = tok + mm(a.to(dt), w_embed[p * kp:(p + 1) * kp])
    return (tok.to(dt) + pos_bias).to(dt)


def _library():
    lib = cuda_build.load("fused_prep_embed")
    fn = lib.fused_prep_embed_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float] * 6
                       + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
    return lib


def kernel_operands(params: Params, y_plane: torch.Tensor,
                    uv_plane: torch.Tensor, window: pp.CropWindow,
                    cfg: ModelConfig):
    """What the kernel reads, made with a few small PyTorch ops: the
    contiguous planes, the float32 scalars [start_y, start_x, scale] and the
    int32 origin [row0, col0] of the band (all on the device: nothing is
    read back), the embed weight and pos + bias in the compute dtype, and
    the band's size."""
    dev = y_plane.device
    if uv_plane.device != dev:
        raise ValueError("y_plane and uv_plane lie on different devices")
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    sy, sx, origin, bh, bw = _band(y_plane, window, cfg.preprocess_band)
    scal = torch.stack([sy, sx, window.size / cfg.search_size]).to(
        device=dev, dtype=torch.float32)
    origin = origin.to(device=dev, dtype=torch.int32)
    w_embed, pos_bias = _embed_operands(params, dt)
    return (y_plane.contiguous(), uv_plane.contiguous(), scal, origin,
            w_embed.contiguous(), pos_bias.contiguous(), bh, bw)


def launch(y_plane: torch.Tensor, uv_plane: torch.Tensor, scal: torch.Tensor,
           origin: torch.Tensor, w_embed: torch.Tensor,
           pos_bias: torch.Tensor, bh: int, bw: int,
           cfg: ModelConfig) -> torch.Tensor:
    """One launch of the kernel on :func:`kernel_operands`; raises on what
    the kernel does not take or if the launch fails."""
    global LAUNCHES
    dev = y_plane.device
    if not y_plane.is_cuda:
        raise ValueError("the fused preprocess + embed kernel needs CUDA "
                         "tensors")
    if cfg.patch_size > _MAX_PATCH:
        raise ValueError(f"patch size {cfg.patch_size} above {_MAX_PATCH}")
    dt = w_embed.dtype
    if dt not in _DTYPE_CODES or pos_bias.dtype != dt:
        raise TypeError(f"the kernel takes float32 or bfloat16 weights, got "
                        f"{dt} and {pos_bias.dtype}")
    n_tok, dim = (cfg.search_size // cfg.patch_size) ** 2, w_embed.shape[1]
    if tuple(w_embed.shape) != (cfg.patch_size ** 2 * 3, dim) \
            or tuple(pos_bias.shape) != (n_tok, dim):
        raise ValueError(
            f"patch embed {tuple(w_embed.shape)} / pos embed "
            f"{tuple(pos_bias.shape)} do not fit search {cfg.search_size}, "
            f"patch {cfg.patch_size}")
    vec = 16 // w_embed.element_size()
    if dim % vec or dim // vec > 256 or w_embed.data_ptr() % 16:
        raise ValueError(f"embed dim {dim} must be a multiple of {vec} up to "
                         f"{256 * vec}, the weight 16-byte aligned")
    if scal.dtype != torch.float32 or scal.numel() != 3 \
            or origin.dtype != torch.int32 or origin.numel() != 2:
        raise ValueError("scal must be 3 float32, origin 2 int32")
    for t in (uv_plane, scal, origin, w_embed, pos_bias):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("every operand must be contiguous on the "
                             "planes' device")
    lib = _library()
    with torch.cuda.device(dev):
        out = torch.empty((n_tok, dim), dtype=dt, device=dev)
        err = lib.fused_prep_embed_forward(
            _DTYPE_CODES[dt], y_plane.shape[1], bh, bw, cfg.search_size,
            cfg.patch_size, dim, *cfg.norm_mean, *cfg.norm_std,
            y_plane.data_ptr(), uv_plane.data_ptr(), scal.data_ptr(),
            origin.data_ptr(), w_embed.data_ptr(), pos_bias.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_prep_embed_forward failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def nv12_search_tokens(params: Params, y_plane: torch.Tensor,
                       uv_plane: torch.Tensor, window: pp.CropWindow,
                       cfg: ModelConfig, mode: str = "loop") -> torch.Tensor:
    """Fused NV12 frame -> embedded search tokens (N, D), pos embed
    included.  ``y_plane`` (H, W) and ``uv_plane`` (H/2, W/2, 2) uint8;
    ``window`` one crop window (0-d tensors); a frame larger than
    ``cfg.preprocess_band`` is banded as ``preprocess_nv12`` bands it.  The
    CUDA kernel for CUDA planes (raises if it cannot launch), the plain
    version for CPU planes."""
    if not y_plane.is_cuda:
        return nv12_search_tokens_reference(params, y_plane, uv_plane, window,
                                            cfg, mode)
    _check_planes(y_plane, uv_plane, window, cfg, mode)
    return launch(*kernel_operands(params, y_plane, uv_plane, window, cfg),
                  cfg)
