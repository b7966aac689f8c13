"""Independent evaluation world (VERDICT r4 item 2).

A ground-truthed synthetic video generator sharing NO renderer code with
``media/source.py``'s training/eval families — every texture, background,
motion and occluder construction here comes from a different procedural
family, so scores on this world bound renderer overfitting in a way the
sibling ``HeldoutSource`` (same module, related noise machinery) cannot:

* **target textures** — analytic, resolution-independent fields sampled
  per frame: sinusoidal *plasma* interference, concentric *rings*,
  flat-celled *voronoi*, and halftone *dots*.  The trainer only ever saw
  upsampled random grids, linear gradients, straight stripes
  (SyntheticSource) and convex-gradient polygons (HeldoutSource).
* **background** — layered-sprite compositing: a two-colour diagonal
  wash plus slowly drifting soft Gaussian blob sprites (the scene itself
  is mildly animated, unlike every training background, which is static).
* **motion law** — per-seed random 3-term Fourier series per axis
  (incommensurate frequencies, richer acceleration spectrum than the
  fixed two-sine Lissajous of the training world).
* **silhouette** — rotated superellipse (exponent in [2.6, 4]) with soft
  edge; distinct from ellipse/diamond masks and polygon silhouettes.
* **occluder** — an opaque ring-textured superellipse slab sweeping
  VERTICALLY across the target (training world: flat-noise rectangle,
  horizontal sweep).

The scenario hardening surface mirrors the eval contract exactly
(scripts/eval_tracking.py::make_source): scale_range/scale_period,
occlusion=(period, length), n_distractors, shake_px, appearance_drift,
morph_rate, rotation_dpf, noise_sigma, exit_spec=(period, length), with
``bbox_at`` / ``object_bbox_at`` / ``visible_frac_at`` ground truth.
Scenario *semantics* (what the schedule means) are shared by definition;
every *implementation* is re-derived here.

The port's own copy of ``gstreamer_vit_tracker_tpu/media/indie.py`` (numpy
only): its frames and boxes are bit-equal to the JAX package's
(``tests/test_torch_indie.py``).  Like the original it imports nothing
from ``media.source``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["IndependentSource"]


# ---------------------------------------------------------------------------
# Analytic texture fields (evaluated at any size — scale changes re-sample
# the *function*, no image resampling family is involved)
# ---------------------------------------------------------------------------

def _palette(rng: np.random.Generator, n: int = 3) -> np.ndarray:
    """n saturated colours with guaranteed mutual contrast."""
    hues = (rng.uniform(0, 1) + np.arange(n) / n) % 1.0
    cols = []
    for h in hues:
        # Minimal HSV->RGB, v in [0.55, 1], s in [0.6, 1].
        s = rng.uniform(0.6, 1.0)
        v = rng.uniform(0.55, 1.0) * 255.0
        k = (np.array([5.0, 3.0, 1.0]) + h * 6.0) % 6.0
        f = v - v * s * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)
        cols.append(f)
    return np.asarray(cols, np.float32)


def _tex_plasma(size: int, p: dict) -> np.ndarray:
    u, v = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    field = np.zeros((size, size), np.float32)
    for f, a, ph in zip(p["freqs"], p["angles"], p["phases"]):
        field += np.cos(2 * np.pi * f * (np.cos(a) * u + np.sin(a) * v) + ph)
    t = (field - field.min()) / max(float(np.ptp(field)), 1e-6)
    c = p["colors"]
    return c[0] * (1 - t[..., None]) + c[1] * t[..., None]


def _tex_rings(size: int, p: dict) -> np.ndarray:
    u, v = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    r = np.hypot(u - p["cx"], v - p["cy"])
    t = 0.5 + 0.5 * np.cos(2 * np.pi * p["freq"] * r + p["phase"])
    c = p["colors"]
    return c[0] * (1 - t[..., None]) + c[1] * t[..., None]


def _tex_voronoi(size: int, p: dict) -> np.ndarray:
    u, v = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    d = np.stack([(u - sy) ** 2 + (v - sx) ** 2
                  for sx, sy in p["sites"]], axis=0)
    lab = d.argmin(axis=0)
    return p["site_colors"][lab].astype(np.float32)


def _tex_dots(size: int, p: dict) -> np.ndarray:
    u, v = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    n = p["lattice"]
    # Hexagonal-ish dot lattice: distance to the nearest lattice point.
    gu, gv = u * n, v * n + 0.5 * np.floor(u * n)
    du, dv = gu - np.floor(gu) - 0.5, gv - np.floor(gv) - 0.5
    dot = (np.hypot(du, dv) < p["radius"]).astype(np.float32)
    c = p["colors"]
    return c[0] * (1 - dot[..., None]) + c[1] * dot[..., None]


_FAMILIES = ("plasma", "rings", "voronoi", "dots")


def _tex_params(rng: np.random.Generator, family: str) -> dict:
    colors = _palette(rng, 3)
    if family == "plasma":
        return {"freqs": rng.uniform(1.5, 5.0, 3),
                "angles": rng.uniform(0, np.pi, 3),
                "phases": rng.uniform(0, 2 * np.pi, 3), "colors": colors}
    if family == "rings":
        return {"cx": rng.uniform(0.2, 0.8), "cy": rng.uniform(0.2, 0.8),
                "freq": rng.uniform(2.5, 6.0),
                "phase": rng.uniform(0, 2 * np.pi), "colors": colors}
    if family == "voronoi":
        k = int(rng.integers(5, 9))
        return {"sites": rng.uniform(0, 1, (k, 2)),
                "site_colors": _palette(rng, k)}
    return {"lattice": float(rng.integers(4, 8)),
            "radius": rng.uniform(0.2, 0.38), "colors": colors}


def _render_tex(family: str, size: int, p: dict) -> np.ndarray:
    fn = {"plasma": _tex_plasma, "rings": _tex_rings,
          "voronoi": _tex_voronoi, "dots": _tex_dots}[family]
    return np.clip(fn(size, p), 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

class IndependentSource:
    """Eval-only world; see module docstring.  Interface mirrors the eval
    contract of the training-family sources (frame_rgb / frame / bbox_at /
    object_bbox_at / visible_frac_at / scenario kwargs)."""

    def __init__(self, width: int = 640, height: int = 512, fps: int = 60,
                 obj_size: int = 64, seed: int = 0, fmt: str = "rgb",
                 speed: float = 2.0, appearance_drift: float = 0.0,
                 scale_range: Optional[Tuple[float, float]] = None,
                 scale_period: int = 300,
                 occlusion: Optional[Tuple[int, int]] = None,
                 n_distractors: int = 0, shake_px: float = 0.0,
                 rotation_dpf: float = 0.0, noise_sigma: float = 0.0,
                 morph_rate: float = 0.0,
                 exit_spec: Optional[Tuple[int, int]] = None):
        assert fmt == "rgb", "IndependentSource is an RGB eval world"
        self.width, self.height, self.fps, self.fmt = width, height, fps, fmt
        self.obj_size, self.speed = obj_size, speed
        self.appearance_drift = float(appearance_drift)
        self.scale_range, self.scale_period = scale_range, scale_period
        self.occlusion, self.exit_spec = occlusion, exit_spec
        self.n_distractors = n_distractors
        self.shake_px = float(shake_px)
        self.rotation_dpf = float(rotation_dpf)
        self.noise_sigma = float(noise_sigma)
        self.morph_rate = float(morph_rate)
        self._seed = seed

        rng = np.random.default_rng((seed, 0xD1E))
        # Target texture + a morph endpoint from a DIFFERENT family.
        fam_i = int(rng.integers(len(_FAMILIES)))
        self._family = _FAMILIES[fam_i]
        self._tex = _tex_params(rng, self._family)
        self._family_b = _FAMILIES[(fam_i + 1 + int(rng.integers(
            len(_FAMILIES) - 1))) % len(_FAMILIES)]
        self._tex_b = _tex_params(rng, self._family_b)
        # Silhouette: rotated superellipse, soft edge.
        self._sil_p = float(rng.uniform(2.6, 4.0))
        self._sil_rot = float(rng.uniform(0, np.pi))
        self._sil_ab = (float(rng.uniform(0.88, 1.0)),
                        float(rng.uniform(0.88, 1.0)))
        # Motion: random 3-term Fourier series per axis, weights sum to 1.
        def fourier():
            w = rng.uniform(0.3, 1.0, 3)
            return {"w": w / w.sum(),
                    "om": rng.uniform(0.35, 1.7, 3),
                    "ph": rng.uniform(0, 2 * np.pi, 3)}
        self._mx, self._my = fourier(), fourier()
        # Camera shake: its own 3-term series per axis (smooth, aperiodic).
        self._sx, self._sy = fourier(), fourier()
        # Distractors: same family, fresh parameter draws + own paths.
        self._d_tex = [(self._family, _tex_params(rng, self._family))
                       for _ in range(n_distractors)]
        self._d_path = [(fourier(), fourier()) for _ in range(n_distractors)]
        # Background: diagonal two-colour wash + drifting blob sprites.
        pad = int(np.ceil(self.shake_px)) + 2
        self._pad = pad
        bh, bw = height + 2 * pad, width + 2 * pad
        c = _palette(rng, 2) * 0.55          # dimmer than targets
        yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
        t = (xx / bw + yy / bh) / 2.0
        self._base = (c[0] * (1 - t[..., None]) + c[1] * t[..., None])
        self._blobs = []
        for _ in range(7):
            sig = float(rng.uniform(28.0, 90.0))
            r = int(2.5 * sig)
            g = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float32)
            a = np.exp(-(g[0] ** 2 + g[1] ** 2) / (2 * sig * sig))
            col = _palette(rng, 1)[0] * rng.uniform(0.4, 0.9)
            self._blobs.append({
                "sprite": a[..., None] * col, "alpha": a,
                "x0": float(rng.uniform(0, bw)), "y0": float(rng.uniform(0, bh)),
                "vx": float(rng.uniform(-0.18, 0.18)),
                "vy": float(rng.uniform(-0.18, 0.18)), "r": r})
        # Occluder: opaque ring-textured superellipse (exponent 4) slab.
        self._occ_tex_p = _tex_params(rng, "rings")
        self._cache: dict = {}

    # -- schedules (scenario semantics; shared by definition with the eval
    # contract, re-derived here) ---------------------------------------------

    def scale_at(self, i: int) -> float:
        if self.scale_range is None:
            return 1.0
        lo, hi = np.log(self.scale_range[0]), np.log(self.scale_range[1])
        return float(np.exp((lo + hi) / 2 + (hi - lo) / 2
                            * np.sin(2 * np.pi * i / self.scale_period)))

    def _size_at(self, i: int) -> int:
        return max(8, int(round(self.obj_size * self.scale_at(i))))

    def _max_size(self) -> int:
        if self.scale_range is None:
            return self.obj_size
        return max(8, int(round(self.obj_size * self.scale_range[1])))

    def _eval_fourier(self, f: dict, t: float) -> float:
        return float(np.sum(f["w"] * np.sin(f["om"] * t + f["ph"])))

    def shake_at(self, i: int) -> Tuple[int, int]:
        if not self.shake_px:
            return 0, 0
        t = i * 0.6
        return (int(round(self.shake_px * self._eval_fourier(self._sx, t))),
                int(round(self.shake_px * self._eval_fourier(self._sy, t))))

    def _centre_at(self, i: int, path=None) -> Tuple[float, float]:
        smax = self._max_size()
        ax = (self.width - smax - 24) / 2
        ay = (self.height - smax - 24) / 2
        t = i * self.speed / 100.0
        mx, my = path if path is not None else (self._mx, self._my)
        return (self.width / 2 + ax * self._eval_fourier(mx, t),
                self.height / 2 + ay * self._eval_fourier(my, t))

    def _exit_frac_at(self, i: int) -> float:
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

    def bbox_at(self, i: int) -> Tuple[float, float, float, float]:
        s = self._size_at(i)
        cx, cy = self._centre_at(i)
        dx, dy = self.shake_at(i)
        x = cx - s / 2 + dx
        if self.exit_spec is not None:
            # Leave through the LEFT edge: at full displacement the right
            # edge sits one target-size beyond x = 0.
            x += self._exit_frac_at(i) * (-(2 * s) - x)
        return (float(x), float(cy - s / 2 + dy), float(s), float(s))

    def object_bbox_at(self, k: int, i: int
                       ) -> Tuple[float, float, float, float]:
        if k == 0:
            return self.bbox_at(i)
        s = self.obj_size
        cx, cy = self._centre_at(i, self._d_path[k - 1])
        dx, dy = self.shake_at(i)
        return (float(cx - s / 2 + dx), float(cy - s / 2 + dy),
                float(s), float(s))

    def occluder_rect_at(self, i: int
                         ) -> Optional[Tuple[int, int, int, int]]:
        if self.occlusion is None:
            return None
        period, length = self.occlusion
        p = (i - period // 2) % period
        if p >= length:
            return None
        u = p / max(length - 1, 1)
        x, y, w, h = self.bbox_at(i)
        cx, cy = x + w / 2, y + h / 2
        ow, oh = int(round(1.5 * w)), int(round(1.5 * h))
        # VERTICAL sweep: above the target at u=0, centred at u=0.5.
        ocy = cy + (1.0 - 2.0 * u) * (h + oh) / 2
        return (int(round(cx - ow / 2)), int(round(ocy - oh / 2)), ow, oh)

    def visible_frac_at(self, i: int) -> float:
        x, y, w, h = self.bbox_at(i)
        if 0.0 <= x and 0.0 <= y and x + w <= self.width \
                and y + h <= self.height:
            vis = 1.0
        else:
            fx = max(0.0, min(x + w, float(self.width)) - max(x, 0.0))
            fy = max(0.0, min(y + h, float(self.height)) - max(y, 0.0))
            vis = (fx * fy) / (w * h)
        occ = self.occluder_rect_at(i)
        if occ is not None:
            ox, oy, ow, oh = occ
            ix = max(0.0, min(x + w, ox + ow) - max(x, ox))
            iy = max(0.0, min(y + h, oy + oh) - max(y, oy))
            # The superellipse occluder is opaque past 92% of its radius
            # budget over the whole target box at midpoint (exponent 4,
            # 1.5x size) — treat box overlap as covered, same convention
            # as the eval metrics expect.
            vis -= (ix * iy) / (w * h)
        return float(max(0.0, vis))

    def morph_frac_at(self, i: int) -> float:
        return min(1.0, self.morph_rate * i) if self.morph_rate else 0.0

    # -- sprites ---------------------------------------------------------------

    def _silhouette(self, size: int, theta: float) -> np.ndarray:
        """Soft superellipse alpha in the rotated frame (rotation also
        spins the silhouette)."""
        c = (size - 1) / 2.0
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        dx, dy = xx - c, yy - c
        a = self._sil_rot + theta
        rx = np.cos(a) * dx + np.sin(a) * dy
        ry = -np.sin(a) * dx + np.cos(a) * dy
        ax = self._sil_ab[0] * size / 2.0
        ay = self._sil_ab[1] * size / 2.0
        p = self._sil_p
        r = (np.abs(rx / ax) ** p + np.abs(ry / ay) ** p) ** (1.0 / p)
        return np.clip((1.05 - r) / 0.12, 0.0, 1.0).astype(np.float32)

    def _target_sprite(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb float sprite, alpha) at frame i: analytic texture at the
        frame's size, rotated in-footprint, morphed, faded."""
        size = self._size_at(i)
        theta = np.deg2rad(self.rotation_dpf * i) if self.rotation_dpf else 0.0
        tex = _render_tex(self._family, size, self._tex)
        m = self.morph_frac_at(i)
        if m > 0.0:
            tex = (1 - m) * tex + m * _render_tex(self._family_b, size,
                                                  self._tex_b)
        if theta:
            # Inverse nearest-neighbour rotation inside the footprint.
            c = (size - 1) / 2.0
            yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
            rx = np.cos(theta) * (xx - c) + np.sin(theta) * (yy - c) + c
            ry = -np.sin(theta) * (xx - c) + np.cos(theta) * (yy - c) + c
            xi = np.clip(np.round(rx).astype(np.int32), 0, size - 1)
            yi = np.clip(np.round(ry).astype(np.int32), 0, size - 1)
            inside = ((rx >= -0.5) & (rx <= size - 0.5)
                      & (ry >= -0.5) & (ry <= size - 0.5))
            tex = tex[yi, xi]
            alpha = self._silhouette(size, theta) * inside
        else:
            alpha = self._silhouette(size, 0.0)
        if self.appearance_drift:
            tex = tex * max(0.25, 1.0 - self.appearance_drift * i)
        return tex, alpha

    def _occluder_sprite(self, ow: int, oh: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        key = ("occ", ow, oh)
        got = self._cache.get(key)
        if got is None:
            tex = _render_tex("rings", max(ow, oh), self._occ_tex_p)[:oh, :ow]
            c_x, c_y = (ow - 1) / 2.0, (oh - 1) / 2.0
            yy, xx = np.mgrid[0:oh, 0:ow].astype(np.float32)
            r = (np.abs((xx - c_x) / (ow / 2.0)) ** 4
                 + np.abs((yy - c_y) / (oh / 2.0)) ** 4) ** 0.25
            alpha = (r <= 1.0).astype(np.float32)
            got = (tex * 0.6 + 40.0, alpha)     # dimmed: foreground slab
            if len(self._cache) > 32:
                self._cache.clear()
            self._cache[key] = got
        return got

    def _distractor_sprite(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        key = ("dis", k)
        got = self._cache.get(key)
        if got is None:
            fam, p = self._d_tex[k]
            tex = _render_tex(fam, self.obj_size, p)
            got = (tex, self._silhouette(self.obj_size, 0.0))
            self._cache[key] = got
        return got

    # -- compositing -------------------------------------------------------------

    def _blend(self, canvas: np.ndarray, sprite: np.ndarray,
               alpha: np.ndarray, x: int, y: int) -> None:
        sh, sw = sprite.shape[:2]
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(self.width, x + sw), min(self.height, y + sh)
        if x1 <= x0 or y1 <= y0:
            return
        sp = sprite[y0 - y:y1 - y, x0 - x:x1 - x]
        al = alpha[y0 - y:y1 - y, x0 - x:x1 - x, None]
        region = canvas[y0:y1, x0:x1]
        canvas[y0:y1, x0:x1] = region * (1.0 - al) + sp * al

    def frame_rgb(self, i: int) -> np.ndarray:
        dx, dy = self.shake_at(i)
        pad = self._pad
        canvas = self._base[pad - dy:pad - dy + self.height,
                            pad - dx:pad - dx + self.width].copy()
        # Drifting blob layer (positions wrap inside the padded base).
        bh, bw = self._base.shape[:2]
        for b in self._blobs:
            bx = (b["x0"] + b["vx"] * i) % bw - pad + dx
            by = (b["y0"] + b["vy"] * i) % bh - pad + dy
            al = b["alpha"][..., None] * 0.55
            x, y = int(round(bx)) - b["r"], int(round(by)) - b["r"]
            sh, sw = b["alpha"].shape
            x0, y0 = max(0, x), max(0, y)
            x1, y1 = min(self.width, x + sw), min(self.height, y + sh)
            if x1 > x0 and y1 > y0:
                sp = b["sprite"][y0 - y:y1 - y, x0 - x:x1 - x]
                a = al[y0 - y:y1 - y, x0 - x:x1 - x]
                canvas[y0:y1, x0:x1] = canvas[y0:y1, x0:x1] * (1 - a) + sp
        # Distractors under the target.
        for k in range(self.n_distractors):
            sp, al = self._distractor_sprite(k)
            x, y, _w, _h = self.object_bbox_at(k + 1, i)
            self._blend(canvas, sp, al, int(round(x)), int(round(y)))
        # Target.
        sp, al = self._target_sprite(i)
        x, y, _w, _h = self.bbox_at(i)
        self._blend(canvas, sp, al, int(round(x)), int(round(y)))
        # Occluder on top.
        occ = self.occluder_rect_at(i)
        if occ is not None:
            ox, oy, ow, oh = occ
            osp, oal = self._occluder_sprite(ow, oh)
            self._blend(canvas, osp, oal, ox, oy)
        if self.noise_sigma:
            nrng = np.random.default_rng((self._seed + 0xA11CE, i))
            canvas = canvas + nrng.normal(0.0, self.noise_sigma,
                                          canvas.shape)
        return np.clip(canvas, 0, 255).astype(np.uint8)

    def frame(self, i: int) -> np.ndarray:
        return self.frame_rgb(i)
