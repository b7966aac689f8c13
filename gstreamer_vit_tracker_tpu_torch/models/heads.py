"""Score / offset / size prediction heads + hanning-penalty decode.

Port of ``gstreamer_vit_tracker_tpu/models/heads.py``.  From the encoded
search tokens the model emits

* ``score``   (B, fs, fs)     per-cell target-centre confidence in [0, 1]
* ``offset``  (B, fs, fs, 2)  sub-cell (dx, dy) of the centre, in [0, 1]
* ``size``    (B, fs, fs, 2)  (w, h) normalised to the crop, in [0, 1]

and the tracker decodes ``argmax(score * hann)`` into a bbox plus the
confidence that the session thresholds.  Maps are NHWC and conv kernels
HWIO at this module's boundary, as in JAX; the convolutions themselves
run as ``F.conv2d`` (NCHW / OIHW), as the JAX package leaves them to XLA.

Two heads: ``conv``, the learned towers (OSTrack's centre head), and
``corr``, a training-free correlation of the search map with the central
template tokens (SiamFC-style), which runs the whole tracking loop without
trained weights.  A float32 convolution on the card is true float32 only
with ``torch.backends.cudnn.allow_tf32`` off, which the port's entry points
set (``device.true_float32``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from .vit import _trunc_normal

Params = Dict[str, Any]


def init_head_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Seeded conv-head towers on the CPU: score, offset and size, each
    three 3x3 convs D -> D/2 -> D/4 -> D/8 and a 1x1 output conv, kernels
    HWIO from :func:`_trunc_normal` at std 0.05, biases 0."""
    d = cfg.embed_dim
    chans = [d, d // 2, d // 4, d // 8]

    def tower(out_ch):
        layers = [{"kernel": _trunc_normal(gen, (3, 3, chans[i], chans[i + 1]),
                                           std=0.05),
                   "bias": torch.zeros(chans[i + 1])}
                  for i in range(len(chans) - 1)]
        layers.append({"kernel": _trunc_normal(gen, (1, 1, chans[-1], out_ch),
                                               std=0.05),
                       "bias": torch.zeros(out_ch)})
        return layers

    return {"score": tower(1), "offset": tower(2), "size": tower(2)}


def _conv_stack(x: torch.Tensor, layers) -> torch.Tensor:
    """x: (B, fs, fs, C) NHWC.  SAME convs with ReLU between layers, the
    last layer linear.  Each conv's output is in x's dtype and the bias is
    added after it, as JAX does (conv, then ``+ bias``)."""
    x = x.permute(0, 3, 1, 2)
    for i, layer in enumerate(layers):
        w = layer["kernel"].to(x.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
        x = F.conv2d(x, w, padding="same") \
            + layer["bias"].to(x.dtype)[None, :, None, None]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x.permute(0, 2, 3, 1)


def conv_head(params: Params, feat: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """feat: (B, Nx, D) encoded search tokens -> (score, offset, size) maps
    from the three separate towers."""
    b = feat.shape[0]
    fs = cfg.feat_size
    fmap = feat.reshape(b, fs, fs, cfg.embed_dim)
    score = torch.sigmoid(_conv_stack(fmap, params["score"])[..., 0].float())
    offset = torch.sigmoid(_conv_stack(fmap, params["offset"]).float())
    size = torch.sigmoid(_conv_stack(fmap, params["size"]).float())
    return score, offset, size


def group_head_params(head: Params) -> Params:
    """Derive the 4-conv grouped head from the tower params, on the host,
    once per checkpoint load: layer 0 concatenates the towers' kernels
    along output channels, layers 1-3 are block-diagonal (each tower's
    weights on the diagonal, zeros off it).  Same maps as the towers, 4
    convs instead of 12."""
    towers = [head["score"], head["offset"], head["size"]]
    like = towers[0][0]["kernel"]
    out: Params = {"layers": []}
    for j in range(len(towers[0])):
        ks = [t[j]["kernel"].detach().cpu().numpy() for t in towers]
        bs = [t[j]["bias"].detach().cpu().numpy() for t in towers]
        if j == 0:
            kernel = np.concatenate(ks, axis=-1)
        else:
            kh, kw = ks[0].shape[:2]
            cin = sum(k.shape[2] for k in ks)
            cout = sum(k.shape[3] for k in ks)
            kernel = np.zeros((kh, kw, cin, cout), ks[0].dtype)
            ci = co = 0
            for k in ks:
                kernel[:, :, ci:ci + k.shape[2], co:co + k.shape[3]] = k
                ci += k.shape[2]
                co += k.shape[3]
        out["layers"].append({
            "kernel": torch.as_tensor(kernel, device=like.device),
            "bias": torch.as_tensor(np.concatenate(bs), device=like.device)})
    # The final layer's output widths (score 1, offset 2, size 2) are the
    # head contract that conv_head_grouped slices by.
    splits = tuple(int(t[-1]["kernel"].shape[3]) for t in towers)
    if splits != (1, 2, 2):
        raise ValueError(f"head output widths {splits}, expected (1, 2, 2)")
    return out


def conv_head_grouped(gparams: Params, feat: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same maps as :func:`conv_head` from the derived grouped kernels."""
    b = feat.shape[0]
    fs = cfg.feat_size
    x = _conv_stack(feat.reshape(b, fs, fs, cfg.embed_dim), gparams["layers"])
    x = x.float()
    score = torch.sigmoid(x[..., 0])
    offset = torch.sigmoid(x[..., 1:3])
    size = torch.sigmoid(x[..., 3:5])
    return score, offset, size


# ---------------------------------------------------------------------------
# Correlation head (training-free)
# ---------------------------------------------------------------------------

def corr_head(z_tok: torch.Tensor, x_feat: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-free SiamFC-style head: the central template token grid
    (the object fills the centre half of the 2x-context template crop) is
    cross-correlated, as a conv kernel, with the search token map; template
    and search share one px-per-cell scale, so the peak sits on the object's
    centre.

    Both maps are centred by the mean search token and L2-normalised per
    token, so a true match scores ~1.0.  Offsets are parabolic sub-cell
    peaks (:func:`_parabolic_offsets`) plus the half-cell anchor of an even
    kernel, sizes are zero (the decode then carries the previous size).

    The per-sample correlation is one grouped ``F.conv2d`` with the batch
    folded into the channels, padded as XLA's ``SAME``: (tc-1)//2 low and
    tc//2 high, so an even kernel's peak lands half a cell early, as in JAX.
    """
    b = x_feat.shape[0]
    tz = cfg.template_feat_size
    fs = cfg.feat_size
    d = x_feat.shape[-1]
    q = tz // 4
    tc = tz - 2 * q

    zmap = z_tok.float().reshape(b, tz, tz, d)[:, q:tz - q, q:tz - q, :]
    xmap = x_feat.float().reshape(b, fs, fs, d)
    mu = xmap.mean(dim=(1, 2), keepdim=True)
    xc = xmap - mu
    zc = zmap - mu
    xc = xc / (torch.linalg.vector_norm(xc, dim=-1, keepdim=True) + 1e-6)
    zc = zc / (torch.linalg.vector_norm(zc, dim=-1, keepdim=True) + 1e-6)

    lo, hi = (tc - 1) // 2, tc // 2
    x = F.pad(xc.permute(0, 3, 1, 2).reshape(1, b * d, fs, fs),
              (lo, hi, lo, hi))
    w = zc.permute(0, 3, 1, 2)                       # (b, d, tc, tc) OIHW
    corr = F.conv2d(x, w, groups=b).reshape(b, fs, fs)
    score = torch.clamp(corr / (tc * tc), 0.0, 1.0)

    anchor = 0.5 if tc % 2 == 0 else 0.0
    offset = _parabolic_offsets(score) + anchor
    size = torch.zeros((b, fs, fs, 2), dtype=torch.float32,
                       device=score.device)
    return score, offset, size


def _parabolic_offsets(score: torch.Tensor) -> torch.Tensor:
    """Sub-cell peak offsets from a (B, fs, fs) score map: the three-point
    parabola ``d = 0.5 * (s+ - s-) / (2*s0 - s- - s+)`` along each axis
    (edge-replicated at the border), clamped to +-0.5 cells; returns
    (B, fs, fs, 2) in [0, 1], 0.5 being the cell centre."""
    pad = F.pad(score[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    s0 = score
    s_l = pad[:, 1:-1, :-2]
    s_r = pad[:, 1:-1, 2:]
    s_u = pad[:, :-2, 1:-1]
    s_d = pad[:, 2:, 1:-1]
    eps = 1e-6
    dx = 0.5 * (s_r - s_l) / torch.clamp_min(2.0 * s0 - s_l - s_r, eps)
    dy = 0.5 * (s_d - s_u) / torch.clamp_min(2.0 * s0 - s_u - s_d, eps)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)
    return torch.stack([dx + 0.5, dy + 0.5], dim=-1)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def hanning_2d(fs: int, mode: str = "interior", device=None) -> torch.Tensor:
    """Separable 2-D hann window (float32) applied to the score map before
    the argmax.

    ``"interior"``: ``0.5 - 0.5*cos(2*pi*(i+1)/(N+1))``, the window
    cv2.TrackerVit multiplies into its confidence map (border cells keep a
    small weight).  ``"opencv"``: ``sin(pi*i/(N-1))`` per axis with exact
    zeros on the border, as cv2.createHanningWindow.

    The angle is formed in float32 as in JAX; sin and cos are taken in
    float64 and rounded, which reproduces XLA's float32 sin and cos at the
    presets' map sizes, where PyTorch's float32 ones differ by an ulp.
    """
    i = torch.arange(fs, dtype=torch.float32, device=device)
    if mode == "opencv":
        w = torch.sin((math.pi * i / (fs - 1)).double()).float()
        w[0] = 0.0
        w[fs - 1] = 0.0
    elif mode == "interior":
        c = torch.cos((2.0 * math.pi * (i + 1) / (fs + 1)).double()).float()
        w = 0.5 - 0.5 * c
    else:
        raise ValueError(f"unknown hann mode {mode!r}")
    return torch.outer(w, w)


def decode_maps(score: torch.Tensor, offset: torch.Tensor, size: torch.Tensor,
                hann: torch.Tensor, prev_size_norm: torch.Tensor,
                hann_weight: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode head maps into (bbox_norm, confidence).

    score (..., fs, fs), offset/size (..., fs, fs, 2), ``prev_size_norm``
    (..., 2), the previous (w, h) in crop units, taken where the size head
    predicts 0; the leading dimensions (none for one target, (S, M) for a
    batch) pass through.  Returns ``bbox_norm`` = (..., 4) (cx, cy, w, h)
    in [0, 1] crop coordinates and the penalised max score (...).  The peak
    is the first maximum (``torch.argmax``, like numpy's); its row of the
    (offset, size, cell) table is read with one gather, no host read.
    """
    fs = score.shape[-1]
    lead = score.shape[:-2]
    penalised = score * (1.0 - hann_weight + hann_weight * hann)
    flat = penalised.reshape(*lead, fs * fs)
    idx = torch.argmax(flat, dim=-1, keepdim=True)             # (..., 1)
    table = torch.cat([offset.reshape(*lead, fs * fs, 2).float(),
                       size.reshape(*lead, fs * fs, 2).float(),
                       _decode_grid(fs, flat.device).expand(*lead, fs * fs, 2)],
                      dim=-1)
    # [ox, oy, sw, sh, ix, iy] of the peak cell
    off_sz_pos = torch.take_along_dim(table, idx[..., None], dim=-2).squeeze(-2)
    cxy = (off_sz_pos[..., 4:6] + off_sz_pos[..., 0:2]) / fs
    sz = off_sz_pos[..., 2:4]
    wh = torch.where(sz > 0, sz, prev_size_norm)
    conf = torch.take_along_dim(flat, idx, dim=-1).squeeze(-1)
    return torch.cat([cxy, wh], dim=-1), conf


@functools.lru_cache(maxsize=None)
def _decode_grid(fs: int, device: torch.device) -> torch.Tensor:
    """(fs*fs, 2) float32 (ix, iy) of each flattened score-map cell, made
    once per (fs, device)."""
    ii = np.arange(fs * fs)
    return torch.as_tensor(np.stack([ii % fs, ii // fs], 1).astype(np.float32),
                           device=device)
