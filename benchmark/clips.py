"""Seeded synthetic NV12 clips: a textured target moving over a textured
background, made on the device in a few large calls.

Each stream gets its own background, target texture, colour and path.  The
target's size comes from the mix's list of sizes, dealt to the streams in
an order drawn from the seed, so every seed tracks the same set of sizes.
Its path is a drift plus a slow sway, reflected at the frame's margins,
on even pixels (so the chroma of a 4:2:0 frame lines up).  Each frame adds
a little sensor noise.  A clip of T frames is played forward and then
backward (:func:`pingpong`), so the motion never jumps.

Parameters (the mix's ``clips`` object): ``frames``, ``height``,
``width``, ``sizes`` (a list of [w, h]), ``speed_px`` (drift a frame),
``sway_px`` (amplitude of the sway), ``margin_px``, ``noise`` (luma
standard deviation of the per-frame noise).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F


class Clips(NamedTuple):
    y: torch.Tensor       # (T, S, H, W) uint8
    uv: torch.Tensor      # (T, S, H/2, W/2, 2) uint8
    boxes: torch.Tensor   # (T, S, 4) float32 (x, y, w, h), the target's


def pingpong(step: int, frames: int) -> int:
    """The clip frame of step ``step`` when a clip of ``frames`` frames
    plays forward, then backward, and so on: 0, 1, ..., T-1, T-2, ..., 1,
    0, 1, ..."""
    period = 2 * (frames - 1)
    r = step % period
    return r if r < frames else period - r


def _smooth(gen, shape, size, device) -> torch.Tensor:
    """Standard-normal noise on a coarse grid, bilinearly upsampled."""
    low = torch.randn(shape, generator=gen, device=device)
    return F.interpolate(low, size=size, mode="bilinear", align_corners=False)


def make(params: Mapping, streams: int, gen: torch.Generator,
         device) -> Clips:
    t_n = int(params["frames"])
    h, w = int(params["height"]), int(params["width"])
    sizes = [tuple(int(v) for v in s) for s in params["sizes"]]
    order = torch.randperm(len(sizes), generator=gen, device=device).tolist()
    margin = float(params["margin_px"])

    # Backgrounds: broad shapes plus finer texture; chroma at half size.
    bg = (120.0 + 40.0 * _smooth(gen, (streams, 1, h // 48 + 2, w // 48 + 2),
                                 (h, w), device)
          + 18.0 * _smooth(gen, (streams, 1, h // 6 + 2, w // 6 + 2), (h, w),
                           device))[:, 0]
    bg_uv = (128.0 + 22.0 * _smooth(gen, (streams, 2, h // 64 + 2,
                                          w // 64 + 2), (h // 2, w // 2),
                                    device)).permute(0, 2, 3, 1)

    # Paths: (T, S) top-left corners.
    u = torch.rand((6, streams), generator=gen, device=device)
    t = torch.arange(t_n, dtype=torch.float32, device=device)[:, None]
    heading = 2.0 * math.pi * u[0]
    speed = float(params["speed_px"]) * (0.5 + u[1])
    sway = float(params["sway_px"])
    phase = 2.0 * math.pi * u[2]
    wt = torch.tensor([sizes[order[i % len(sizes)]][0]
                       for i in range(streams)], device=device)
    ht = torch.tensor([sizes[order[i % len(sizes)]][1]
                       for i in range(streams)], device=device)

    def path(lo, span, start, vel, sway_fn):
        raw = lo + start * span + vel * t + sway * sway_fn
        m = torch.remainder(raw - lo, 2.0 * span)
        return lo + torch.where(m < span, m, 2.0 * span - m)

    span_x = (w - wt - 2 * margin).float()
    span_y = (h - ht - 2 * margin).float()
    xs = path(margin, span_x, u[3], speed * torch.cos(heading),
              torch.sin(2.0 * math.pi * t / t_n + phase))
    ys = path(margin, span_y, u[4], speed * torch.sin(heading),
              torch.sin(4.0 * math.pi * t / t_n + phase))
    xs = (torch.round(xs / 2) * 2).long().cpu()
    ys = (torch.round(ys / 2) * 2).long().cpu()

    y = torch.empty((t_n, streams, h, w), dtype=torch.uint8, device=device)
    uv = torch.empty((t_n, streams, h // 2, w // 2, 2), dtype=torch.uint8,
                     device=device)
    for s in range(streams):
        tw, th = int(wt[s]), int(ht[s])
        tex = (128.0 + 70.0 * torch.sign(_smooth(
            gen, (1, 1, th // 10 + 2, tw // 10 + 2), (th, tw), device))
            * _smooth(gen, (1, 1, th // 4 + 2, tw // 4 + 2), (th, tw),
                      device).abs().clamp_max(1.0))[0, 0]
        tint = 128.0 + 45.0 * (2.0 * torch.rand(2, generator=gen,
                                                device=device) - 1.0)
        tex_uv = tint + 8.0 * _smooth(gen, (1, 2, th // 16 + 2, tw // 16 + 2),
                                      (th // 2, tw // 2), device)[0].permute(
                                          1, 2, 0)
        for f in range(t_n):
            x0, y0 = int(xs[f, s]), int(ys[f, s])
            frame = bg[s].clone()
            frame[y0:y0 + th, x0:x0 + tw] = tex
            y[f, s] = frame.clamp(16.0, 235.0).to(torch.uint8)
            fuv = bg_uv[s].clone()
            fuv[y0 // 2:(y0 + th) // 2, x0 // 2:(x0 + tw) // 2] = tex_uv
            uv[f, s] = fuv.clamp(16.0, 240.0).to(torch.uint8)
    noise = float(params["noise"])
    if noise > 0.0:
        for f in range(t_n):
            n = noise * torch.randn((streams, h, w), generator=gen,
                                    device=device)
            y[f] = (y[f].float() + n).clamp(16.0, 235.0).to(torch.uint8)
    boxes = torch.stack([xs.float(), ys.float(),
                         wt.cpu().float().expand(t_n, streams),
                         ht.cpu().float().expand(t_n, streams)], -1)
    return Clips(y, uv, boxes)
