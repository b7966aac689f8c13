"""A plain float32 reference of one tracker update, written for the benchmark.

It computes, from the raw inputs alone (the NV12 frame, the box the step
starts from, the count of low-confidence frames before it, and the flat
weights the benchmark made or loaded), what one update of an OSTrack-style
one-stream tracker gives:

    crop window (context factor, lost-window ramp, band clamp)
      -> bilinear NV12 crop/resize (luma at full, chroma at half
         resolution, zero outside the frame) -> BT.601 -> ImageNet normalise
      -> 16x16 patch embed + position embeddings
      -> [template tokens; search tokens] through pre-LN ViT blocks
         (tanh GELU, LayerNorm eps 1e-6) -> final LayerNorm
      -> three conv towers (score, offset, size; 3x3 convs with ReLU, a 1x1
         conv, sigmoid) -> hann-penalised score map
      -> the box each cell of the map would give (size-rate clamp,
         size freeze under half confidence, window freeze under the
         threshold, clamp to the frame).

Everything is float32 plain PyTorch (TF32 off on a card), with no kernels,
caches or compiled graphs, and imports nothing of the measured program.
``precision="float8"`` computes the same in float8 e4m3 (a per-tensor
scale on each tensor): every weight, and every value the step stores (the
normalised crop, the tokens, the residual stream after each add, the
LayerNorm outputs, qkv, the attention probabilities and output, the MLP
hidden, each head conv's output) is rounded to it, with the arithmetic
between in float32.  That is the control a comparison has to reject.

Weights come as a flat mapping of ``/``-joined keys (``backbone/blocks/3/
qkv/kernel``, ``head/score/0/kernel``; linear kernels (in, out), conv
kernels HWIO).  The model's sizes come from the configuration file's
fields.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
# BT.601 limited range, the integer coefficients over 256.
C_Y, C_RV, C_GU, C_GV, C_BU = (298 / 256, 409 / 256, -100 / 256, -208 / 256,
                               516 / 256)
FP8_MAX = 448.0   # largest finite float8 e4m3fn


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


PRECISIONS = {"float32": _exact, "float8": _fp8}


class Window(NamedTuple):
    cx: torch.Tensor      # (N,)
    cy: torch.Tensor
    size: torch.Tensor


class Maps(NamedTuple):
    """The step's outputs for N samples: the penalised score map (N, C)
    over the C = fs * fs cells in raster order, the offset and size maps
    (N, C, 2), and the search window."""

    penalised: torch.Tensor
    offset: torch.Tensor
    size: torch.Tensor
    window: Window


def crop_window(box: torch.Tensor, factor) -> Window:
    """A square window of side ceil(factor * sqrt(w * h)) (at least 2)
    centred on each (x, y, w, h) box, w and h floored at 1."""
    w = box[:, 2].clamp_min(1.0)
    h = box[:, 3].clamp_min(1.0)
    size = torch.ceil(factor * torch.sqrt(w * h)).clamp_min(2.0)
    return Window(box[:, 0] + 0.5 * w, box[:, 1] + 0.5 * h, size)


def sampling(out: int, src: int, start: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """(N, out, src) bilinear weights, half-pixel centres: output i samples
    source coordinate start + (i + 0.5) * scale - 0.5; a source pixel j
    weighs max(0, 1 - |s - j|), so samples outside the source weigh 0."""
    dev = start.device
    i = torch.arange(out, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(src, dtype=torch.float32, device=dev)[None, None, :]
    s = start[:, None, None] + (i + 0.5) * scale[:, None, None] - 0.5
    return (1.0 - (s - j).abs()).clamp_min(0.0)


def _half(m: torch.Tensor) -> torch.Tensor:
    """Weights on a 2x-subsampled source whose pixels each stand for two."""
    return m.reshape(*m.shape[:-1], m.shape[-1] // 2, 2).sum(-1)


def _band_origin(centre: torch.Tensor, limit: int, band: int) -> torch.Tensor:
    """The band's first row (or column): centred on the window, inside the
    frame, even."""
    o = torch.round(centre - band / 2).to(torch.int64)
    o = o.clamp(0, max(limit - band, 0))
    return torch.div(o, 2, rounding_mode="floor") * 2


def nv12_crop(y: torch.Tensor, uv: torch.Tensor, win: Window, out: int,
              mean, std, band: Optional[int]) -> torch.Tensor:
    """Normalised RGB crops (N, out, out, 3) of NV12 frames y (N, H, W),
    uv (N, H/2, W/2, 2), uint8.  With ``band``, each frame is first cut to
    the band x band region centred on its window (a frame no larger than
    the band is left whole), and pixels outside it count as outside."""
    n, h, w = y.shape
    dev = y.device
    sy = win.cy - 0.5 * win.size
    sx = win.cx - 0.5 * win.size
    yf = y.float() - 16.0
    uf = uv[..., 0].float() - 128.0
    vf = uv[..., 1].float() - 128.0
    if band is not None and (h > band or w > band):
        bh, bw = min(band, h), min(band, w)
        r0 = _band_origin(win.cy, h, band)
        c0 = _band_origin(win.cx, w, band)
        idx = torch.arange(n, device=dev)[:, None, None]
        rows = r0[:, None] + torch.arange(bh, device=dev)
        cols = c0[:, None] + torch.arange(bw, device=dev)
        yf = yf[idx, rows[:, :, None], cols[:, None, :]]
        rows2 = r0[:, None] // 2 + torch.arange(bh // 2, device=dev)
        cols2 = c0[:, None] // 2 + torch.arange(bw // 2, device=dev)
        uf = uf[idx, rows2[:, :, None], cols2[:, None, :]]
        vf = vf[idx, rows2[:, :, None], cols2[:, None, :]]
        sy = sy - r0.float()
        sx = sx - c0.float()
        h, w = bh, bw
    scale = win.size / out
    ry = sampling(out, h, sy, scale)
    cx = sampling(out, w, sx, scale)
    ry2, cx2 = _half(ry), _half(cx)
    yc = ry @ yf @ cx.transpose(1, 2)
    uc = ry2 @ uf @ cx2.transpose(1, 2)
    vc = ry2 @ vf @ cx2.transpose(1, 2)
    rgb = torch.stack([C_Y * yc + C_RV * vc,
                       C_Y * yc + C_GU * uc + C_GV * vc,
                       C_Y * yc + C_BU * uc], dim=-1)
    rgb = rgb.clamp(0.0, 255.0) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    return (rgb - m) / s


def hann(fs: int, device) -> torch.Tensor:
    """(fs * fs,) separable hann window, 0.5 - 0.5 cos(2 pi (i + 1) /
    (fs + 1)) per axis, raster order."""
    i = torch.arange(fs, dtype=torch.float64)
    w = (0.5 - 0.5 * torch.cos(2.0 * math.pi * (i + 1) / (fs + 1))).float()
    return torch.outer(w, w).reshape(-1).to(device)


class Reference:
    """The model of one configuration over the flat weights ``flat``
    (tensors or arrays, copied to ``device`` in float32)."""

    def __init__(self, fields: Mapping, flat: Mapping, device,
                 precision: str = "float32"):
        self.f = dict(fields)
        self.dev = torch.device(device)
        self.q = PRECISIONS[precision]
        self.w: Dict[str, torch.Tensor] = {
            k: torch.as_tensor(v).to(self.dev, torch.float32)
            for k, v in flat.items()}
        self.patch = int(self.f["patch_size"])
        self.dim = int(self.f["embed_dim"])
        self.fs = int(self.f["search_size"]) // self.patch
        self.hann = hann(self.fs, self.dev)

    # -- products ------------------------------------------------------------

    def _linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.q(x @ self.q(self.w[name + "/kernel"])
                      + self.w[name + "/bias"])

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + LN_EPS)
        return self.q(y * self.w[name + "/scale"] + self.w[name + "/bias"])

    def _embed(self, img: torch.Tensor, pos: str) -> torch.Tensor:
        n, hh, ww, c = img.shape
        p = self.patch
        x = img.reshape(n, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = self.q(x.reshape(n, (hh // p) * (ww // p), p * p * c))
        return self.q(self._linear(x, "backbone/patch_embed") + self.w[pos])

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        pre = f"backbone/blocks/{i}/"
        heads = int(self.f["num_heads"])
        n, s, d = x.shape
        dh = d // heads
        qkv = self._linear(self._ln(x, pre + "ln1"), pre + "qkv")
        q, k, v = (t.reshape(n, s, heads, dh).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        p = self.q(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh),
                                 dim=-1))
        o = self.q(p @ v).transpose(1, 2).reshape(n, s, d)
        x = self.q(x + self._linear(o, pre + "proj"))
        h = self._linear(self._ln(x, pre + "ln2"), pre + "mlp1")
        g = self.q(F.gelu(h, approximate="tanh"))
        return self.q(x + self._linear(g, pre + "mlp2"))

    def _tower(self, fmap: torch.Tensor, name: str) -> torch.Tensor:
        x = fmap
        layers = sum(1 for k in self.w if k.startswith(f"head/{name}/")
                     and k.endswith("/kernel"))
        for j in range(layers):
            k = self.w[f"head/{name}/{j}/kernel"].permute(3, 2, 0, 1)
            x = self.q(F.conv2d(x, self.q(k), padding="same")
                       + self.w[f"head/{name}/{j}/bias"][None, :, None, None])
            if j < layers - 1:
                x = torch.relu(x)
        return torch.sigmoid(x).permute(0, 2, 3, 1).reshape(
            x.shape[0], -1, x.shape[1])

    # -- the entry points ----------------------------------------------------

    def template(self, y, uv, box: torch.Tensor,
                 band: Optional[int]) -> torch.Tensor:
        """(N, Nz, D) template tokens of the boxes on their first frames."""
        win = crop_window(box, float(self.f["template_factor"]))
        img = nv12_crop(y, uv, win, int(self.f["template_size"]),
                        self.f["norm_mean"], self.f["norm_std"], band)
        return self._embed(img, "backbone/pos_embed_z")

    def step(self, y, uv, prev: torch.Tensor, lost: torch.Tensor,
             z: torch.Tensor, band: Optional[int]) -> Maps:
        """One update of N samples: frames y (N, H, W) / uv (N, H/2, W/2,
        2), the boxes they start from (N, 4), their low-confidence counts
        before the step (N,), their template tokens (N, Nz, D)."""
        f = self.f
        factor = torch.full_like(prev[:, 0], float(f["search_factor"]))
        growth = float(f["lost_window_growth"])
        if growth > 1.0:
            factor = factor * torch.pow(
                torch.full_like(factor, growth), lost.float()).clamp_max(
                    float(f["lost_window_max_growth"]))
        win = crop_window(prev, factor)
        if band is not None and growth > 1.0:
            win = win._replace(size=win.size.clamp_max(float(band)))
        img = nv12_crop(y, uv, win, int(f["search_size"]), f["norm_mean"],
                        f["norm_std"], band)
        x = torch.cat([z, self._embed(img, "backbone/pos_embed_x")], dim=1)
        for i in range(int(f["depth"])):
            x = self._block(x, i)
        feat = self._ln(x, "backbone/norm")[:, z.shape[1]:]
        fmap = feat.transpose(1, 2).reshape(x.shape[0], self.dim, self.fs,
                                            self.fs)
        score = self._tower(fmap, "score")[..., 0]
        return Maps(score * self.hann, self._tower(fmap, "offset"),
                    self._tower(fmap, "size"), win)

    def cell_boxes(self, maps: Maps, prev: torch.Tensor, conf: torch.Tensor,
                   frame_wh) -> torch.Tensor:
        """(N, C, 4) the box each cell of the map gives, as the peak, after
        the box rules, under the confidence ``conf`` (N,) that gates them."""
        f = self.f
        fs = self.fs
        cells = torch.arange(fs * fs, device=prev.device)
        grid = torch.stack([cells % fs, cells // fs], -1).float()
        side = maps.window.size[:, None, None]
        origin = torch.stack([maps.window.cx, maps.window.cy], -1)[:, None] \
            - 0.5 * side
        cxy = origin + (grid + maps.offset) / fs * side
        lim = torch.tensor(frame_wh, dtype=torch.float32, device=prev.device)
        prev_wh = prev[:, None, 2:4]
        sz = torch.where(maps.size > 0, maps.size, prev_wh / side)
        wh = torch.minimum((sz * side).clamp_min(1.0), lim)
        rate = float(f["size_rate_limit"])
        if rate > 0.0:
            wh = torch.minimum(torch.maximum(wh, prev_wh / (1.0 + rate)),
                               prev_wh * (1.0 + rate))
        gate = conf[:, None, None]
        if float(f["size_conf_freeze"]) > 0.0:
            wh = torch.where(gate > float(f["size_conf_freeze"]), wh,
                             prev_wh.expand_as(wh))
        xy = torch.minimum((cxy - 0.5 * wh).clamp_min(0.0), lim - wh)
        box = torch.cat([xy, wh], -1)
        if float(f["window_freeze_threshold"]) > 0.0:
            box = torch.where(gate > float(f["window_freeze_threshold"]), box,
                              prev[:, None, :].expand_as(box))
        return box
