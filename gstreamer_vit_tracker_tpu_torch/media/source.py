"""Frame sources: synthetic video, file playback, optional V4L2.

The reference's only source is a V4L2 camera (reference main.rs:32,
pipeline_ir.rs:21-41).  For a portable framework we add deterministic
synthetic video (the test/bench workhorse — SURVEY.md §4 "tracker
integration: synthetic video (moving patterned square)") and file playback,
with the same iterator interface.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["SyntheticSource", "HeldoutSource", "FileSource", "V4L2Source",
           "rgb_to_nv12_planes", "rgb_to_yuy2"]


def rgb_to_yuy2(rgb: np.ndarray) -> np.ndarray:
    """Forward BT.601 RGB -> packed YUY2 rows (H, W*2) uint8; chroma is
    averaged over horizontal pixel pairs (4:2:2)."""
    h, w = rgb.shape[:2]
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256
    u = 128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256
    v = 128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256
    u2 = u.reshape(h, w // 2, 2).mean(axis=-1)
    v2 = v.reshape(h, w // 2, 2).mean(axis=-1)
    quads = np.empty((h, w // 2, 4), np.float32)
    quads[..., 0] = y[:, 0::2]
    quads[..., 1] = u2
    quads[..., 2] = y[:, 1::2]
    quads[..., 3] = v2
    return np.clip(np.round(quads), 0, 255).astype(np.uint8).reshape(h, w * 2)


def rgb_to_nv12_planes(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Forward BT.601 limited-range RGB -> NV12 planes (Y (H,W), UV
    (H/2, W/2, 2)).  Chroma is averaged over each 2x2 block (standard 4:2:0
    downsampling)."""
    h, w = rgb.shape[:2]
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256
    u = 128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256
    v = 128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256
    u = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    v = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    y = np.clip(np.round(y), 16, 235).astype(np.uint8)
    uv = np.stack([np.clip(np.round(u), 16, 240),
                   np.clip(np.round(v), 16, 240)], axis=-1).astype(np.uint8)
    return y, uv


def _upsample_grid(coarse: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear upsample of an (n+1, n+1, 3) control grid to (H, W, 3).

    Separable: rows first on the (n+1)-wide grid, then columns — 2 full-
    size products instead of the naive 4-term form's 12 (H, W, 3)
    temporaries.  Kept in f64 so outputs stay bit-identical (after uint8
    quantisation) to the original expression; this is the host datagen
    hot spot (~90% of scene-pool construction, CPU train bottleneck)."""
    n = coarse.shape[0] - 1
    ys = np.linspace(0, n, height)
    xs = np.linspace(0, n, width)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, n)
    x1 = np.minimum(x0 + 1, n)
    fy = (ys - y0)[:, None, None]
    rows = (1 - fy) * coarse[y0] + fy * coarse[y1]        # (H, n+1, 3)
    fx = (xs - x0)[None, :, None]
    return (1 - fx) * rows[:, x0] + fx * rows[:, x1]


def _bilinear_resize_f32(img: np.ndarray, out: int) -> np.ndarray:
    """Square bilinear resize (half-pixel centres), float32 out."""
    n = img.shape[0]
    s = (np.arange(out) + 0.5) * (n / out) - 0.5
    j0 = np.clip(np.floor(s).astype(int), 0, n - 1)
    j1 = np.minimum(j0 + 1, n - 1)
    f = np.clip(s - np.floor(s), 0.0, 1.0)
    imgf = img.astype(np.float32)
    rows = (imgf[j0] * (1 - f)[:, None, None] + imgf[j1] * f[:, None, None])
    return (rows[:, j0] * (1 - f)[None, :, None]
            + rows[:, j1] * f[None, :, None])


def _rotate_patch(patch: np.ndarray, alpha: Optional[np.ndarray],
                  angle_deg: float
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Rotate ``patch`` (s, s, 3) about its centre by ``angle_deg`` into
    the SAME s×s footprint: corners that rotate out of the square are
    masked to alpha 0 (scene shows through), corners of the square that
    the rotated source doesn't cover likewise.  Bilinear, pure numpy."""
    if abs(angle_deg) % 360.0 < 1e-9:
        return patch, alpha
    s = patch.shape[0]
    c = (s - 1) / 2.0
    a = np.deg2rad(angle_deg)
    ca, sa = np.cos(a), np.sin(a)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    xs = ca * (xx - c) + sa * (yy - c) + c     # inverse map: dest -> src
    ys = -sa * (xx - c) + ca * (yy - c) + c
    eps = 1e-3          # right-angle cos/sin fuzz must not drop edge rows
    valid = ((xs >= -eps) & (xs <= s - 1 + eps)
             & (ys >= -eps) & (ys <= s - 1 + eps))
    x0 = np.clip(np.floor(xs).astype(int), 0, s - 1)
    y0 = np.clip(np.floor(ys).astype(int), 0, s - 1)
    x1 = np.minimum(x0 + 1, s - 1)
    y1 = np.minimum(y0 + 1, s - 1)
    fx = np.clip(xs - x0, 0.0, 1.0)[..., None]
    fy = np.clip(ys - y0, 0.0, 1.0)[..., None]
    pf = patch.astype(np.float32)
    out = ((1 - fy) * ((1 - fx) * pf[y0, x0] + fx * pf[y0, x1])
           + fy * ((1 - fx) * pf[y1, x0] + fx * pf[y1, x1]))
    av = valid.astype(np.float32)
    if alpha is not None:
        fx2, fy2 = fx[..., 0], fy[..., 0]
        asrc = ((1 - fy2) * ((1 - fx2) * alpha[y0, x0] + fx2 * alpha[y0, x1])
                + fy2 * ((1 - fx2) * alpha[y1, x0] + fx2 * alpha[y1, x1]))
        av = av * asrc
    return np.clip(np.round(out), 0, 255).astype(np.uint8), av


class SyntheticSource:
    """Deterministic moving-target video.

    A patterned square glides over a smooth textured background along a
    Lissajous path.  ``bbox_at(i)`` gives the ground-truth box, enabling
    IoU assertions (the parity harness the reference never had,
    SURVEY.md §4).

    The world can be hardened beyond the reference's fixed-appearance
    assumption (the real tracker faces scale change, occlusion and
    lookalike clutter — reference tracker_context.rs:120-138
    consumes per-frame bbox+score under arbitrary real motion):

    * ``scale_range=(lo, hi)`` — the target's rendered size sweeps
      log-sinusoidally between ``lo*obj_size`` and ``hi*obj_size`` with
      period ``scale_period`` frames (exercises the size head's runtime
      decode, which a constant-size target never touches).
    * ``occlusion=(period, length)`` — every ``period`` frames a textured
      occluder sweeps across the target for ``length`` frames, covering it
      completely at the midpoint; ``visible_frac_at(i)`` reports the
      un-occluded fraction so evals can assert the Lost machine engages
      rather than silently drifting.
    * ``n_distractors=N`` — N same-construction lookalike patches glide on
      their own Lissajous paths underneath the target.
    * ``shake_px=A`` — camera shake: the whole scene (background, target,
      distractors, occluder) translates by a shared smooth pseudo-random
      offset of amplitude ±A px per axis; ground truth moves with it, so
      evals see the violent inter-frame motion a handheld/vehicle camera
      produces.
    * ``rotation_dpf=D`` — in-plane rotation: the target spins D degrees
      per frame about its centre (rendered into its own footprint, so the
      gt box stays the s×s square while the appearance continuously
      rotates away from the frame-0 template — real targets are rarely
      axis-locked).
    * ``noise_sigma=S`` — per-frame additive Gaussian sensor noise of
      std S applied to the whole frame (IR cameras — the reference's
      actual input, pipeline_ir.rs:27-41 — are noisy); deterministic per
      (seed, frame).
    * ``exit_spec=(period, length)`` — every ``period`` frames the target
      LEAVES the frame through the right edge and re-enters the same way
      over a ``length``-frame window (trapezoid: out over the first 30%,
      fully off-frame for the middle 40%, back over the last 30%).
      ``visible_frac_at`` reports the in-frame fraction, so the same
      hidden-confidence / re-acquisition eval metrics that gate occlusion
      also gate frame exit — the other way a real target disappears, and
      one the occlusion machinery does not automatically cover (there is
      no occluder appearance to reject, just absence + frame-border
      zero-padding).
    * ``morph_rate=M`` — STRUCTURAL appearance drift: the target's
      texture linearly cross-fades toward a second patch of a different
      construction family (fraction M per frame, clamped at 1.0).
      Unlike ``appearance_drift`` (brightness-only, trainable away with
      fade augmentation), no static template survives a full texture
      replacement — this is the regime the online template update
      (config.template_update_*) exists for: each per-frame step is
      small, so a confident-frame re-embed tracks the morph while the
      frame-0 template correlates with a texture that no longer exists.
    """

    def __init__(self, width: int = 640, height: int = 512, fps: int = 60,
                 obj_size: int = 64, seed: int = 0, fmt: str = "rgb",
                 speed: float = 2.0, appearance_drift: float = 0.0,
                 scale_range: Optional[Tuple[float, float]] = None,
                 scale_period: int = 300,
                 occlusion: Optional[Tuple[int, int]] = None,
                 n_distractors: int = 0, shake_px: float = 0.0,
                 rotation_dpf: float = 0.0, noise_sigma: float = 0.0,
                 morph_rate: float = 0.0,
                 exit_spec: Optional[Tuple[int, int]] = None,
                 patch_style: str = "quad", bg_style: str = "smooth",
                 mask_style: str = "none", edge_fade: float = 0.0,
                 bg_motion: int = 0,
                 bg_motion_sigma: Tuple[float, float] = (16.0, 56.0),
                 bg_motion_col: float = 70.0):
        assert fmt in ("rgb", "nv12", "yuy2")
        assert patch_style in ("quad", "noise", "grad", "stripes", "tiles")
        assert bg_style in ("smooth", "octave")
        assert mask_style in ("none", "ellipse", "diamond", "blob")
        # appearance_drift > 0 darkens the target over time (tests the
        # online template update, BASELINE.json config 3).
        self.appearance_drift = appearance_drift
        self.patch_style = patch_style
        self.width = width
        self.height = height
        self.fps = fps
        self.obj_size = obj_size
        self.fmt = fmt
        self.speed = speed
        self.scale_range = scale_range
        self.scale_period = scale_period
        self.occlusion = occlusion
        self.exit_spec = exit_spec
        self.n_distractors = n_distractors
        self.shake_px = shake_px
        self.rotation_dpf = float(rotation_dpf)
        self.noise_sigma = float(noise_sigma)
        self._noise_seed = seed + 91_007
        self._patch_cache: dict = {}
        rng = np.random.default_rng(seed)
        # Separate rng stream: drawing shake phases from `rng` would shift
        # the bit-pinned background/patch draws for every existing scene.
        srng = np.random.default_rng(seed + 77_003)
        self._shake_phase = srng.uniform(0, 2 * np.pi, 4)
        # Background.  "smooth" (default): one coarse-noise grid,
        # bilinear-upsampled (the original family — draw order unchanged,
        # so default scenes are bit-identical to earlier rounds).
        # "octave": two value-noise octaves (training-time appearance
        # diversity; the held-out eval family stays distinct: smoothstep
        # interpolation, 3 octaves, polygon target — HeldoutSource).
        if bg_style == "smooth":
            coarse = rng.integers(40, 140, size=(8, 8, 3)).astype(np.float32)
            bg = _upsample_grid(coarse, height, width)
        else:
            bg = np.zeros((height, width, 3), np.float32)
            for g, amp in ((5, 0.62), (17, 0.38)):
                grid = rng.integers(30, 150, size=(g + 1, g + 1, 3)
                                    ).astype(np.float32)
                bg += amp * _upsample_grid(grid, height, width)
        self.background = np.clip(bg, 0, 255).astype(np.uint8)
        # Object patch styles.  "quad" (default): smooth aperiodic
        # high-saturation 4x4 grid with a bright border.  (A periodic
        # checkerboard would alias under correlation — multiple shifts
        # match equally well.)  The others diversify the appearance family
        # for training: "noise" (finer 8x8 grid, border), "grad"
        # (two-colour linear gradient, NO border — breaks any learned
        # bright-frame shortcut), "stripes" (two-colour diagonal stripes,
        # no border).
        s = obj_size
        yy, xx = np.mgrid[0:s, 0:s]
        border = (yy < 3) | (yy >= s - 3) | (xx < 3) | (xx >= s - 3)
        if patch_style == "quad":
            pc = rng.integers(0, 256, size=(4, 4, 3)).astype(np.float32)
            patch = _upsample_grid(pc, s, s)
            patch[border] = (250, 250, 250)
        elif patch_style == "noise":
            pc = rng.integers(0, 256, size=(8, 8, 3)).astype(np.float32)
            patch = _upsample_grid(pc, s, s)
            patch[border] = (250, 250, 250)
        elif patch_style == "grad":
            c0 = rng.uniform(0, 255, 3).astype(np.float32)
            c1 = rng.uniform(0, 255, 3).astype(np.float32)
            ang = rng.uniform(0, 2 * np.pi)
            t = (np.cos(ang) * xx + np.sin(ang) * yy).astype(np.float32)
            t = (t - t.min()) / max(t.max() - t.min(), 1e-6)
            patch = c0 * (1 - t[..., None]) + c1 * t[..., None]
        elif patch_style == "tiles":
            # 2D-PERIODIC lattice (round-5): a k x k colour cell tiled
            # rep times, nearest-sampled to s px.  Periodic textures
            # correlate at many shifts — the regime where the size head
            # must learn to read the silhouette BOUNDARY, not texture
            # extent (the independent world's halftone-dots failure
            # mode; construction here is a square colour tiling, a
            # different family from that world's dot lattices).
            k = int(rng.integers(2, 4))
            rep = int(rng.integers(3, 9))
            if rng.random() < 0.5:
                # Two-tone variant (diversity v3): a binary k x k pattern
                # of exactly two colours — the high-frequency two-colour
                # periodic regime (fences, halftones, checkers) where
                # appearance models alias worst.
                c2 = rng.uniform(0, 255, (2, 3)).astype(np.float32)
                bits = rng.integers(0, 2, size=(k, k))
                cell = c2[bits]
            else:
                cell = rng.integers(0, 256,
                                    size=(k, k, 3)).astype(np.float32)
            t2 = np.tile(cell, (rep, rep, 1))
            n2 = t2.shape[0]
            idx = (np.arange(s) * n2) // s
            patch = t2[idx][:, idx]
        else:                                   # stripes
            c0 = rng.uniform(0, 255, 3).astype(np.float32)
            c1 = rng.uniform(0, 255, 3).astype(np.float32)
            period = float(rng.integers(6, 17))
            ang = rng.uniform(0, 2 * np.pi)
            t = np.cos(ang) * xx + np.sin(ang) * yy
            stripe = ((t // (period / 2)) % 2).astype(np.float32)
            patch = c0 * (1 - stripe[..., None]) + c1 * stripe[..., None]
        self.patch = np.clip(patch, 0, 255).astype(np.uint8)
        # Texture-morph endpoint: a patch from a DIFFERENT construction
        # family (grad <-> stripes — both borderless, so the morph also
        # dissolves any learned bright-frame cue).  Dedicated rng stream:
        # default scenes stay bit-identical when morph is off.
        self.morph_rate = float(morph_rate)
        self._morph_patch = None
        if self.morph_rate > 0.0:
            mrng = np.random.default_rng(seed + 55_009)
            c0 = mrng.uniform(0, 255, 3).astype(np.float32)
            c1 = mrng.uniform(0, 255, 3).astype(np.float32)
            ang = mrng.uniform(0, 2 * np.pi)
            if patch_style == "grad":
                period = float(mrng.integers(6, 17))
                t = np.cos(ang) * xx + np.sin(ang) * yy
                stripe = ((t // (period / 2)) % 2).astype(np.float32)
                mp = c0 * (1 - stripe[..., None]) + c1 * stripe[..., None]
            else:
                t = (np.cos(ang) * xx + np.sin(ang) * yy).astype(np.float32)
                t = (t - t.min()) / max(t.max() - t.min(), 1e-6)
                mp = c0 * (1 - t[..., None]) + c1 * t[..., None]
            self._morph_patch = np.clip(mp, 0, 255).astype(np.uint8)
        # Lookalike distractors: same construction recipe, different draws.
        self._distractors = []
        for _ in range(n_distractors):
            dc = rng.integers(0, 256, size=(4, 4, 3)).astype(np.float32)
            dp = _upsample_grid(dc, s, s)
            dp[border] = (250, 250, 250)
            self._distractors.append(np.clip(dp, 0, 255).astype(np.uint8))
        # Occluder: a flat-ish textured slab, unlike both background and
        # target (it represents a foreground object passing in front).
        occ = rng.integers(70, 110, size=(6, 6, 3)).astype(np.float32)
        self._occ_tex = np.clip(
            _bilinear_resize_f32(occ, 64) + rng.normal(0, 6, (64, 64, 3)),
            0, 255).astype(np.uint8)
        # Non-rectangular silhouettes + soft edges (training-time shape
        # diversity): "ellipse"/"diamond" alpha-mask the target so the gt
        # box contains visible background, and ``edge_fade`` ramps the
        # alpha to 0 over the outer fraction of the silhouette — real
        # targets are rarely axis-aligned rects with hard edges, and a
        # model trained only on those under-boxes soft-edged shapes (the
        # held-out eval's observed failure mode).  Constructions are
        # deliberately distinct from HeldoutSource's convex-gradient
        # polygons (that family stays eval-only).  Defaults draw nothing
        # from ``rng`` — default scenes stay bit-identical across rounds.
        self.mask_style, self.edge_fade = mask_style, float(edge_fade)
        if mask_style != "none":
            self._ax_frac = float(rng.uniform(0.85, 1.0))
            self._ay_frac = float(rng.uniform(0.85, 1.0))
            if mask_style == "blob":
                # Rotated harmonic silhouette r(theta) = 1 + sum a_k
                # cos(k theta + phi_k): a GENERAL smooth-shape family
                # (lobed blobs through rounded near-rects) for the
                # round-5 generalisation fine-tune — real targets are
                # rarely axis-aligned conics.  Amplitudes kept small so
                # the silhouette stays star-convex and inside the box.
                self._blob_amp = rng.uniform(0.04, 0.14, 4)
                self._blob_phase = rng.uniform(0, 2 * np.pi, 4)
                self._blob_rot = float(rng.uniform(0, 2 * np.pi))
        else:
            self._ax_frac = self._ay_frac = 1.0
        # Dynamic background (round-5): ``bg_motion=N`` composites N soft
        # moving colour blobs onto the background every frame — real
        # scenes have moving structure (clouds, shadows, lights), and a
        # re-detection ramp trained only on STATIC backgrounds latches
        # onto anything that moves.  Dedicated rng stream + gated draws:
        # default scenes stay bit-identical.
        self.bg_motion = int(bg_motion)
        self._bg_blobs = []
        if self.bg_motion:
            lo, hi = bg_motion_sigma
            brng = np.random.default_rng(seed + 33_331)
            for _ in range(self.bg_motion):
                sig = float(brng.uniform(lo, hi))
                r = int(2.2 * sig)
                g = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float32)
                a = np.exp(-(g[0] ** 2 + g[1] ** 2) / (2 * sig * sig))
                col = brng.uniform(-bg_motion_col, bg_motion_col,
                                   3).astype(np.float32)
                self._bg_blobs.append({
                    "alpha": a, "col": col, "r": r,
                    "x": float(brng.uniform(0, width)),
                    "y": float(brng.uniform(0, height)),
                    "vx": float(brng.uniform(-1.4, 1.4)),
                    "vy": float(brng.uniform(-1.4, 1.4))})

    def scale_at(self, i: int) -> float:
        """Target render scale at frame ``i`` (1.0 without a schedule).
        Log-sinusoid between scale_range bounds, period ``scale_period``."""
        if self.scale_range is None:
            return 1.0
        lo, hi = np.log(self.scale_range[0]), np.log(self.scale_range[1])
        mid, amp = (lo + hi) / 2, (hi - lo) / 2
        return float(np.exp(mid + amp * np.sin(2 * np.pi * i / self.scale_period)))

    def _size_at(self, i: int) -> int:
        return max(8, int(round(self.obj_size * self.scale_at(i))))

    def _max_size(self) -> int:
        if self.scale_range is None:
            return self.obj_size
        return max(8, int(round(self.obj_size * self.scale_range[1])))

    def shake_at(self, i: int) -> Tuple[int, int]:
        """Global camera offset (dx, dy) at frame ``i`` — two
        incommensurate sinusoids per axis (smooth but aperiodic), integer
        so the background roll and the gt shift agree exactly."""
        if not self.shake_px:
            return 0, 0
        p = self._shake_phase
        t = i * 0.55
        dx = 0.5 * self.shake_px * (np.sin(1.0 * t + p[0])
                                    + np.sin(2.618 * t + p[1]))
        dy = 0.5 * self.shake_px * (np.sin(1.13 * t + p[2])
                                    + np.sin(2.244 * t + p[3]))
        return int(round(dx)), int(round(dy))

    def bbox_at(self, i: int) -> Tuple[float, float, float, float]:
        """Ground-truth (x, y, w, h) at frame ``i``."""
        s = self._size_at(i)
        smax = self._max_size()
        ax = (self.width - smax - 20) / 2
        ay = (self.height - smax - 20) / 2
        t = i * self.speed / 100.0
        cx = self.width / 2 + ax * np.sin(1.0 * t)
        cy = self.height / 2 + ay * np.sin(0.7 * t + 1.0)
        sx, sy = self.shake_at(i)
        x = cx - s / 2 + sx
        if self.exit_spec is not None:
            # Push the left edge to (width + s) at full displacement —
            # one target-size beyond the right frame edge, fully out even
            # while the Lissajous base keeps oscillating underneath.
            x += self._exit_frac_at(i) * (self.width + s - x)
        return (float(x), float(cy - s / 2 + sy), float(s), float(s))

    def _exit_frac_at(self, i: int) -> float:
        """Trapezoid frame-exit profile in [0, 1] (0 = on the normal
        path, 1 = fully off-frame).  Windows are centred mid-period like
        occluder_rect_at so frame 0 always inits on a clean scene."""
        if self.exit_spec is None:
            return 0.0
        period, length = self.exit_spec
        p = (i - period // 2) % period
        if p >= length:
            return 0.0
        u = p / max(length - 1, 1)
        ramp = 0.3
        if u < ramp:
            return u / ramp
        if u > 1.0 - ramp:
            return (1.0 - u) / ramp
        return 1.0

    def occluder_rect_at(self, i: int) -> Optional[Tuple[int, int, int, int]]:
        """Occluder (x, y, w, h) at frame ``i``, or None when inactive.

        The occluder sweeps horizontally across the target over the
        occlusion window: clear of it at the endpoints, fully covering it
        at the midpoint (its extent exceeds the target's on both axes)."""
        if self.occlusion is None:
            return None
        period, length = self.occlusion
        # Windows are centred mid-period so every sequence starts with a
        # clean tracking stretch before the first occlusion (an occlusion
        # in the first frames would corrupt the very init the eval seeds).
        p = (i - period // 2) % period
        if p >= length:
            return None
        u = p / max(length - 1, 1)
        x, y, w, h = self.bbox_at(i)
        cx, cy = x + w / 2, y + h / 2
        ow, oh = int(round(1.4 * w)), int(round(1.4 * h))
        ocx = cx + (1.0 - 2.0 * u) * (w + ow) / 2
        return (int(round(ocx - ow / 2)), int(round(cy - oh / 2)), ow, oh)

    def visible_frac_at(self, i: int) -> float:
        """Fraction of the target neither occluded nor out of frame at
        frame ``i`` (conservative when both apply: occluded area is
        subtracted even where it overlaps the off-frame part)."""
        x, y, w, h = self.bbox_at(i)
        if x >= 0.0 and y >= 0.0 and x + w <= self.width \
                and y + h <= self.height:
            vis = 1.0    # exactly: evals key reacquire windows off == 1.0
        else:
            fx = max(0.0, min(x + w, float(self.width)) - max(x, 0.0))
            fy = max(0.0, min(y + h, float(self.height)) - max(y, 0.0))
            vis = (fx * fy) / (w * h)
        occ = self.occluder_rect_at(i)
        if occ is not None:
            ox, oy, ow, oh = occ
            ix = max(0.0, min(x + w, ox + ow) - max(x, ox))
            iy = max(0.0, min(y + h, oy + oh) - max(y, oy))
            vis -= (ix * iy) / (w * h)
        return float(max(0.0, vis))

    def _patch_at(self, size: int, which: int = -1) -> np.ndarray:
        """Target (which=-1) or distractor patch resized to ``size`` px."""
        key = (size, which)
        cached = self._patch_cache.get(key)
        if cached is None:
            base = self.patch if which < 0 else self._distractors[which]
            cached = (base if size == base.shape[0] else
                      np.clip(np.round(_bilinear_resize_f32(base, size)),
                              0, 255).astype(np.uint8))
            if len(self._patch_cache) > 64:
                self._patch_cache.clear()
            self._patch_cache[key] = cached
        return cached

    def morph_frac_at(self, i: int) -> float:
        """Texture cross-fade fraction at frame ``i`` (0 = original)."""
        return min(1.0, self.morph_rate * i) if self.morph_rate else 0.0

    def _target_patch_at(self, size: int, i: int) -> np.ndarray:
        """Target patch at ``size`` px including the frame-``i`` texture
        morph (``morph_rate``); falls back to the static patch."""
        patch = self._patch_at(size)
        m = self.morph_frac_at(i)
        if m <= 0.0:
            return patch
        key = ("morphB", size)
        mb = self._patch_cache.get(key)
        if mb is None:
            mp = self._morph_patch
            mb = (mp if size == mp.shape[0] else
                  np.clip(np.round(_bilinear_resize_f32(mp, size)),
                          0, 255).astype(np.uint8))
            if len(self._patch_cache) > 64:
                self._patch_cache.clear()
            self._patch_cache[key] = mb
        return np.clip(np.round((1.0 - m) * patch.astype(np.float32)
                                + m * mb.astype(np.float32)),
                       0, 255).astype(np.uint8)

    def _bg_at(self, i: int, sx: int = 0, sy: int = 0) -> np.ndarray:
        """Background at frame ``i``: static copy, plus the ``bg_motion``
        moving blobs (positions wrap; they pan with camera shake like the
        rest of the scene)."""
        if sx or sy:
            img = np.roll(self.background, (sy, sx), axis=(0, 1))
        else:
            img = self.background.copy()
        if not self.bg_motion:
            return img
        for b in self._bg_blobs:
            bx = (b["x"] + b["vx"] * i) % self.width + sx
            by = (b["y"] + b["vy"] * i) % self.height + sy
            x, y = int(round(bx)) - b["r"], int(round(by)) - b["r"]
            sh, sw = b["alpha"].shape
            x0, y0 = max(0, x), max(0, y)
            x1, y1 = min(self.width, x + sw), min(self.height, y + sh)
            if x1 <= x0 or y1 <= y0:
                continue
            # Region-local blend: full-frame float conversion here would
            # dominate datagen cost on the 1-core host.
            al = b["alpha"][y0 - y:y1 - y, x0 - x:x1 - x, None]
            reg = img[y0:y1, x0:x1].astype(np.float32)
            img[y0:y1, x0:x1] = np.clip(reg + al * b["col"],
                                        0, 255).astype(np.uint8)
        return img

    def _alpha_at(self, size: int) -> Optional[np.ndarray]:
        """Target alpha mask at ``size`` px (None = opaque rectangle).
        Binary silhouette for ellipse/diamond; ``edge_fade`` f ramps alpha
        1 -> 0 over the outer f fraction of the silhouette radius."""
        if self.mask_style == "none" and self.edge_fade <= 0.0:
            return None
        key = ("alpha", size)
        a = self._patch_cache.get(key)
        if a is None:
            c = (size - 1) / 2.0
            yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
            dx, dy = xx - c, yy - c
            ax = max(self._ax_frac * size / 2.0, 1.0)
            ay = max(self._ay_frac * size / 2.0, 1.0)
            if self.mask_style == "ellipse":
                r = np.sqrt((dx / ax) ** 2 + (dy / ay) ** 2)
            elif self.mask_style == "diamond":
                r = np.abs(dx) / ax + np.abs(dy) / ay
            elif self.mask_style == "blob":
                theta = np.arctan2(dy, dx) + self._blob_rot
                rad = np.ones_like(theta)
                for k, (amp, ph) in enumerate(zip(self._blob_amp,
                                                  self._blob_phase)):
                    rad += amp * np.cos((k + 2) * theta + ph)
                # Mean-normalise so the silhouette FILLS its gt box
                # (max-normalising shrank coverage to ~38% — label
                # noise for the size head); lobes that poke past the
                # box simply truncate at its edge.
                rad /= rad.mean()
                r = np.sqrt((dx / ax) ** 2 + (dy / ay) ** 2) / rad
            else:   # rectangular extent, fade toward the box edges
                r = np.maximum(np.abs(dx), np.abs(dy)) / (size / 2.0)
            if self.edge_fade > 0.0:
                a = np.clip((1.0 - r) / self.edge_fade, 0.0, 1.0
                            ).astype(np.float32)
            else:
                a = (r <= 1.0).astype(np.float32)
            if len(self._patch_cache) > 64:
                self._patch_cache.clear()
            self._patch_cache[key] = a
        return a

    def _paste(self, img: np.ndarray, patch: np.ndarray, x: int, y: int,
               alpha: Optional[np.ndarray] = None):
        """Paste ``patch`` at top-left (x, y), cropped to the frame;
        ``alpha`` (HxW float in [0,1]) blends it over the scene."""
        ph, pw = patch.shape[:2]
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(self.width, x + pw), min(self.height, y + ph)
        if x1 <= x0 or y1 <= y0:
            return
        ps = patch[y0 - y:y1 - y, x0 - x:x1 - x]
        if alpha is None:
            img[y0:y1, x0:x1] = ps
        else:
            al = alpha[y0 - y:y1 - y, x0 - x:x1 - x][..., None]
            reg = img[y0:y1, x0:x1].astype(np.float32)
            img[y0:y1, x0:x1] = np.clip(
                np.round(al * ps.astype(np.float32) + (1.0 - al) * reg),
                0, 255).astype(np.uint8)

    def frame_rgb_at(self, x: float, y: float, i: int = 0,
                     scale: float = 1.0, rotation_deg: float = 0.0,
                     fade: float = 1.0
                     ) -> Tuple[np.ndarray, Tuple[float, float, float, float]]:
        """Render the scene with the target at an arbitrary top-left
        (clamped inside the frame); returns (frame, actual bbox).  Used by
        the training data generator to place targets hard against frame
        borders — the zero-padding regime the Lissajous path rarely
        reaches (round-2 long-horizon robustness work).  ``scale`` renders
        the target at ``scale * obj_size`` px (size-head training);
        ``rotation_deg`` renders it spun in-plane about its centre
        (rotation-robustness training: template and search can be rendered
        at different angles); ``fade`` scales the target's brightness
        (fade-robustness training: template and search can be rendered at
        MISMATCHED brightness, the regime the drift scenario's static
        template faces — it composes multiplicatively with any
        ``appearance_drift``-driven fade)."""
        img = self._bg_at(i)
        w = h = max(8, int(round(self.obj_size * scale)))
        xi = max(0, min(self.width - w, int(round(x))))
        yi = max(0, min(self.height - h, int(round(y))))
        patch = self._target_patch_at(w, i)
        if self.appearance_drift:
            fade = fade * max(0.25, 1.0 - self.appearance_drift * i)
        if fade != 1.0:
            patch = (patch.astype(np.float32) * fade).astype(np.uint8)
        alpha = self._alpha_at(w)
        if rotation_deg:
            patch, alpha = _rotate_patch(patch, alpha, rotation_deg)
        if alpha is None:
            img[yi:yi + h, xi:xi + w] = patch
        else:
            self._paste(img, patch, xi, yi, alpha)
        return img, (float(xi), float(yi), float(w), float(h))

    def object_bbox_at(self, k: int, i: int) -> Tuple[float, float, float, float]:
        """Ground truth for object ``k`` at frame ``i``: object 0 is the
        primary target (:meth:`bbox_at`), objects 1..n_distractors are the
        lookalike distractors — every rendered patch has a known
        trajectory, which turns any distractor scene into a ground-truthed
        MULTI-object scene (the app's ``--objects N`` and the eval's
        multi-object scenario both lean on this)."""
        if k == 0:
            return self.bbox_at(i)
        dx, dy = self._distractor_pos(k - 1, i)
        s = self.obj_size
        return (float(dx), float(dy), float(s), float(s))

    def _distractor_pos(self, j: int, i: int) -> Tuple[int, int]:
        s = self.obj_size
        ax = (self.width - s - 20) / 2
        ay = (self.height - s - 20) / 2
        t = i * self.speed / 100.0
        cx = self.width / 2 + ax * np.sin(0.9 * t + 2.1 + 2.39 * j)
        cy = self.height / 2 + ay * np.sin(0.6 * t + 4.0 + 1.7 * j)
        sx, sy = self.shake_at(i)
        return (int(round(cx - s / 2)) + sx, int(round(cy - s / 2)) + sy)

    def frame_rgb(self, i: int) -> np.ndarray:
        x, y, w, h = self.bbox_at(i)
        if not (self._distractors or self.occlusion is not None
                or self.scale_range is not None or self.shake_px
                or self.rotation_dpf or self.noise_sigma
                or self.exit_spec is not None):
            # frame_rgb_at clamps the target inside the frame; any world
            # that can place it at/over the border must take the full
            # _paste path below, which crops instead.
            img, _ = self.frame_rgb_at(x, y, i)
            return img
        sx, sy = self.shake_at(i)
        # Camera pan: the background translates with the scene (wraps
        # at the frame edge — cheap and textured enough to be benign);
        # bg_motion blobs ride on top inside _bg_at.
        img = self._bg_at(i, sx, sy)
        for j in range(len(self._distractors)):       # under the target
            dx, dy = self._distractor_pos(j, i)
            self._paste(img, self._patch_at(self.obj_size, j), dx, dy)
        patch = self._target_patch_at(int(w), i)
        if self.appearance_drift:
            fade = max(0.25, 1.0 - self.appearance_drift * i)
            patch = (patch.astype(np.float32) * fade).astype(np.uint8)
        alpha = self._alpha_at(int(w))
        if self.rotation_dpf:
            patch, alpha = _rotate_patch(patch, alpha,
                                         self.rotation_dpf * i)
        self._paste(img, patch, int(round(x)), int(round(y)), alpha)
        occ = self.occluder_rect_at(i)                # over the target
        if occ is not None:
            ox, oy, ow, oh = occ
            side = max(ow, oh)
            tex = self._patch_cache.get(("occ", side))
            if tex is None:   # ow/oh repeat across frames; cache per size
                tex = np.clip(np.round(_bilinear_resize_f32(
                    self._occ_tex, side)), 0, 255).astype(np.uint8)
                if len(self._patch_cache) > 64:
                    self._patch_cache.clear()
                self._patch_cache[("occ", side)] = tex
            self._paste(img, tex[:oh, :ow], ox, oy)
        if self.noise_sigma:
            # Sensor noise is post-scene (it rides on everything, occluder
            # included), fresh each frame, deterministic per (seed, i).
            nrng = np.random.default_rng((self._noise_seed, i))
            img = np.clip(
                img.astype(np.float32)
                + nrng.normal(0.0, self.noise_sigma, img.shape),
                0, 255).astype(np.uint8)
        return img

    def frame(self, i: int):
        rgb = self.frame_rgb(i)
        if self.fmt == "rgb":
            return rgb
        if self.fmt == "yuy2":
            return rgb_to_yuy2(rgb)
        return rgb_to_nv12_planes(rgb)

    def __iter__(self) -> Iterator:
        i = 0
        while True:
            yield self.frame(i)
            i += 1


class HeldoutSource:
    """Held-out eval world: a DIFFERENT generator family from the training
    distribution (SyntheticSource), used only for generalisation evals.

    Background: multi-octave value noise (Perlin-ish) instead of a single
    bilinear-upsampled coarse grid.  Target: a filled convex polygon with a
    radial colour gradient instead of a bordered square patch.  Same
    iterator/bbox interface as SyntheticSource so evals are drop-in; never
    used by train/data.py — IoU here measures out-of-family transfer
    (quality claims on the training family alone overstate robustness).
    """

    def __init__(self, width: int = 640, height: int = 512, fps: int = 60,
                 obj_size: int = 64, seed: int = 0, fmt: str = "rgb",
                 speed: float = 2.0):
        assert fmt in ("rgb", "nv12", "yuy2")
        self.width, self.height, self.fps = width, height, fps
        self.obj_size, self.fmt, self.speed = obj_size, fmt, speed
        rng = np.random.default_rng(seed + 7919)
        # Multi-octave value noise background.
        bg = np.zeros((height, width, 3), np.float32)
        for octave, amp in ((4, 60.0), (11, 30.0), (29, 14.0)):
            coarse = rng.uniform(0, 1, (octave + 1, octave + 1, 3)).astype(np.float32)
            ys = np.linspace(0, octave, height)
            xs = np.linspace(0, octave, width)
            y0 = np.floor(ys).astype(int)
            x0 = np.floor(xs).astype(int)
            fy = ((ys - y0) ** 2 * (3 - 2 * (ys - y0)))[:, None, None]
            fx = ((xs - x0) ** 2 * (3 - 2 * (xs - x0)))[None, :, None]
            y1 = np.minimum(y0 + 1, octave)
            x1 = np.minimum(x0 + 1, octave)
            bg += amp * ((1 - fy) * (1 - fx) * coarse[y0][:, x0]
                         + (1 - fy) * fx * coarse[y0][:, x1]
                         + fy * (1 - fx) * coarse[y1][:, x0]
                         + fy * fx * coarse[y1][:, x1])
        self.background = np.clip(bg + 40, 0, 255).astype(np.uint8)
        # Convex-polygon target with a radial two-colour gradient.
        s = obj_size
        k = int(rng.integers(5, 9))
        # Deliberate discarded draw: an earlier construction sampled free
        # angles here; the draw is kept so the rng stream (and thus every
        # held-out scene all published heldout IoU numbers were measured
        # on) stays stable.  Do not remove without re-baselining.
        rng.uniform(0, 2 * np.pi, k)
        # Near-even vertex spacing + high radii keep the polygon fat (a
        # thin sliver would make the gt box mostly background).
        ang = 2 * np.pi * np.arange(k) / k + rng.uniform(-0.3, 0.3, k)
        rad = rng.uniform(0.78, 0.98, k) * (s / 2 - 1)
        vx = s / 2 + rad * np.cos(ang)
        vy = s / 2 + rad * np.sin(ang)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        inside = np.ones((s, s), bool)
        ccx, ccy = float(vx.mean()), float(vy.mean())
        for a in range(k):
            b = (a + 1) % k
            ex, ey = vx[b] - vx[a], vy[b] - vy[a]
            side = ex * (yy - vy[a]) - ey * (xx - vx[a])
            # Half-plane sign chosen so the vertex centroid is inside
            # (orientation-independent convexity test).
            ref = ex * (ccy - vy[a]) - ey * (ccx - vx[a])
            inside &= (side * np.sign(ref)) >= 0
        c0 = rng.uniform(120, 255, 3).astype(np.float32)
        c1 = rng.uniform(0, 120, 3).astype(np.float32)
        r = np.sqrt((xx - s / 2) ** 2 + (yy - s / 2) ** 2) / (s / 2)
        grad = c0[None, None] * (1 - r[..., None]) + c1[None, None] * r[..., None]
        self._mask = inside
        self._poly = np.clip(grad, 0, 255).astype(np.uint8)
        # Ground truth is the polygon's TIGHT bounding box (a tracker that
        # boxes the visible shape must not be scored against the padded
        # patch square it cannot see).
        mys, mxs = np.where(inside)
        self._mask_box = (int(mxs.min()), int(mys.min()),
                          int(mxs.max() - mxs.min() + 1),
                          int(mys.max() - mys.min() + 1))

    def _origin_at(self, i: int) -> Tuple[int, int]:
        """Top-left of the patch square at frame ``i`` (render anchor)."""
        s = self.obj_size
        ax = (self.width - s - 20) / 2
        ay = (self.height - s - 20) / 2
        t = i * self.speed / 100.0
        # Different path frequencies from the training family.
        cx = self.width / 2 + ax * np.sin(0.85 * t + 0.4)
        cy = self.height / 2 + ay * np.sin(1.15 * t + 2.2)
        xi = max(0, min(self.width - s, int(round(cx - s / 2))))
        yi = max(0, min(self.height - s, int(round(cy - s / 2))))
        return xi, yi

    def bbox_at(self, i: int) -> Tuple[float, float, float, float]:
        xi, yi = self._origin_at(i)
        mx, my, mw, mh = self._mask_box
        return (float(xi + mx), float(yi + my), float(mw), float(mh))

    def frame_rgb(self, i: int) -> np.ndarray:
        img = self.background.copy()
        xi, yi = self._origin_at(i)
        s = self.obj_size
        region = img[yi:yi + s, xi:xi + s]
        region[self._mask] = self._poly[self._mask]
        return img

    def frame(self, i: int):
        rgb = self.frame_rgb(i)
        if self.fmt == "rgb":
            return rgb
        if self.fmt == "yuy2":
            return rgb_to_yuy2(rgb)
        return rgb_to_nv12_planes(rgb)

    def __iter__(self) -> Iterator:
        i = 0
        while True:
            yield self.frame(i)
            i += 1


class FileSource:
    """Plays back recorded video from a file.

    ``.y4m``  — YUV4MPEG2 raw video (what ``ffmpeg -i clip.mp4 out.y4m``
                produces); decoded frame-at-a-time to NV12 planes feeding
                the fused NV12 preprocess path (media/y4m.py).
    ``.npz``  — NV12 plane stacks: arrays ``y`` (N, H, W) and ``uv``
                (N, H/2, W/2, 2).
    ``.npy``  — RGB stack (N, H, W, 3) uint8.
    ``.mp4/.avi/.mkv/.mov/.webm`` — compressed containers decoded through
                OpenCV's VideoCapture when cv2 is importable (the reference
                consumes live camera video, reference pipeline_ir.rs:21-41;
                this covers its recorded-clip analog without any new
                dependency).  Frames come back RGB; decode is sequential
                with a cursor — random back-seeks reopen the file.
    """

    _CV2_EXTS = (".mp4", ".avi", ".mkv", ".mov", ".webm")

    def __init__(self, path: str, fps: int = 60, loop: bool = False):
        self.fps = fps
        self.loop = loop
        self._y4m = None
        self._cap = None
        if path.lower().endswith(self._CV2_EXTS):
            try:
                import cv2
            except ImportError as e:
                raise RuntimeError(
                    f"reading {path!r} needs OpenCV (cv2) for decode; "
                    "convert to .y4m (ffmpeg -i clip.mp4 clip.y4m) for the "
                    "dependency-free path") from e
            self._cv2 = cv2
            self._path = path
            cap = cv2.VideoCapture(path)
            if not cap.isOpened():
                raise RuntimeError(f"cv2 could not open video {path!r}")
            self._cap = cap
            self._cursor = 0
            self.fmt = "rgb"
            self.num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if self.num_frames <= 0:
                raise RuntimeError(
                    f"cv2 reports no frame count for {path!r} (stream or "
                    "broken index); only seekable recorded files are "
                    "supported here")
            self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            file_fps = cap.get(cv2.CAP_PROP_FPS)
            if file_fps and file_fps > 0:
                self.fps = file_fps
        elif path.endswith(".y4m"):
            from .y4m import Y4MReader

            self._y4m = Y4MReader(path)
            self.fmt = "nv12"
            self.num_frames = self._y4m.num_frames
            self.height, self.width = self._y4m.height, self._y4m.width
            if self._y4m.fps:
                self.fps = self._y4m.fps
        elif path.endswith(".npz"):
            data = np.load(path)
            self._y, self._uv = data["y"], data["uv"]
            self.fmt = "nv12"
            self.num_frames = len(self._y)
            self.height, self.width = self._y.shape[1:3]
        else:
            self._frames = np.load(path)
            self.fmt = "rgb"
            self.num_frames = len(self._frames)
            self.height, self.width = self._frames.shape[1:3]

    def frame(self, i: int):
        if self.loop:
            i = i % self.num_frames
        if self._cap is not None:
            return self._frame_cv2(i)
        if self._y4m is not None:
            return self._y4m.frame_nv12(i)
        if self.fmt == "rgb":
            return self._frames[i]
        return self._y[i], self._uv[i]

    def _frame_cv2(self, i: int):
        if i < self._cursor:            # back-seek: reopen from the start
            self._cap.release()
            self._cap = self._cv2.VideoCapture(self._path)
            self._cursor = 0
        while self._cursor < i:         # skip forward without decoding
            self._cap.grab()
            self._cursor += 1
        ok, bgr = self._cap.read()
        if not ok:
            raise IndexError(f"frame {i} past end of {self._path!r}")
        self._cursor = i + 1
        return np.ascontiguousarray(bgr[..., ::-1])  # BGR -> RGB

    def __iter__(self) -> Iterator:
        i = 0
        while self.loop or i < self.num_frames:
            yield self.frame(i)
            i += 1


class V4L2Source:
    """Real V4L2 capture (YUY2) via the framework's own ioctl/mmap stack
    (media/v4l2.py): VIDIOC_S_FMT negotiation, mmap streaming buffers,
    QBUF/DQBUF ring — the caps the reference's v4l2src negotiates
    (pipeline_ir.rs:21-41: YUY2 640x512@60, io-mode dmabuf; mmap streaming
    is the userspace analog).  Used only when a camera node exists — the
    reference hard-fails without one (main.rs:34-36); we degrade to the
    synthetic source instead."""

    def __init__(self, device: str = "/dev/video21", width: int = 640,
                 height: int = 512, fps: int = 60, pixfmt: str = "yuy2"):
        if not os.path.exists(device):
            raise FileNotFoundError(f"Camera not found: {device}")
        from .v4l2 import PIX_FMT_MJPEG, PIX_FMT_YUYV, V4L2Capture

        if pixfmt not in ("yuy2", "mjpeg"):
            raise ValueError(f"unsupported V4L2 pixfmt {pixfmt!r} "
                             "(yuy2 | mjpeg)")
        self.device = device
        self.fps = fps
        self.pixfmt = pixfmt
        # MJPEG cameras deliver JPEG per frame (how most USB cams reach
        # >30fps); decoded host-side to RGB before the device preprocess.
        self.fmt = "rgb" if pixfmt == "mjpeg" else "yuy2"
        self._cap = V4L2Capture(
            device, width, height, fps=fps,
            pixelformat=PIX_FMT_MJPEG if pixfmt == "mjpeg"
            else PIX_FMT_YUYV)
        # Negotiated geometry may differ from the request; expose the
        # ACTUAL frame shape to the pipeline.
        self._started = False
        self.width = width
        self.height = height

    def open(self):
        self._cap.start()
        self.width = self._cap.width
        self.height = self._cap.height
        self._started = True

    def frame(self, i: int) -> np.ndarray:
        if not self._started:
            self.open()
        data = self._cap.read_frame()
        if self.pixfmt == "mjpeg":
            from .mjpeg import decode_jpeg

            return decode_jpeg(data.tobytes())
        n = self.width * self.height * 2
        if data.size < n:
            data = np.pad(data, (0, n - data.size))
        # Packed YUY2 rows, the tracker's "yuy2" frame layout.
        return data[:n].reshape(self.height, self.width * 2)

    def close(self):
        if self._started:
            self._cap.stop()
            self._started = False


class FlakySource:
    """Fault-injection wrapper: drops, repeats, or corrupts frames.

    The reference has no fault-injection hooks (SURVEY.md §5); this wrapper
    adds them for resilience testing — the session machine must survive
    stalled/corrupted input by riding its Lost/auto-reset path rather than
    crashing.
    """

    def __init__(self, inner, drop_every: int = 0, corrupt_every: int = 0,
                 fault_every: int = 0, seed: int = 0):
        self.inner = inner
        self.drop_every = drop_every
        self.corrupt_every = corrupt_every
        # Transport-fault injection (soak testing, scripts/soak.py): every
        # ``fault_every`` frames one OSError is raised — the app's fault
        # loop must call :meth:`reopen` (the camera-reconnect path,
        # app/main.py) before frames flow again, exactly like a real
        # MJPEG/V4L2 transport drop (media/mjpeg.py reconnect semantics).
        self.fault_every = fault_every
        self.width = inner.width
        self.height = inner.height
        self.fps = getattr(inner, "fps", 60)
        self.fmt = getattr(inner, "fmt", "rgb")
        self._rng = np.random.default_rng(seed)
        self._last = None
        self._fault_fired_at = -1
        self._needs_reopen = False
        self.reopen_count = 0

    def reopen(self) -> None:
        self._needs_reopen = False
        self.reopen_count += 1
        if hasattr(self.inner, "reopen"):
            self.inner.reopen()

    def frame(self, i: int):
        if self._needs_reopen:
            raise OSError("injected transport fault: source not reopened")
        if (self.fault_every and i and i % self.fault_every == 0
                and i != self._fault_fired_at):
            self._fault_fired_at = i
            self._needs_reopen = True
            raise OSError("injected transport fault")
        f = self.inner.frame(i)
        if self.drop_every and i and i % self.drop_every == 0:
            # Dropped frame: deliver the previous one again (camera stall).
            f = self._last if self._last is not None else f
        elif self.corrupt_every and i and i % self.corrupt_every == 0:
            if isinstance(f, tuple):
                y, uv = f
                f = (self._rng.integers(0, 256, y.shape).astype(np.uint8), uv)
            else:
                f = self._rng.integers(0, 256, np.asarray(f).shape).astype(np.uint8)
        self._last = f
        return f
