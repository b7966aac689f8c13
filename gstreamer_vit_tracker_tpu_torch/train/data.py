"""Synthetic template/search training pairs.

Deterministic generator producing (template crop, search crop, gt bbox in
crop-normalised coords) batches from procedurally generated scenes — the
same moving-patterned-target family as media.source.SyntheticSource, which
keeps the whole train/eval story self-contained (the reference repo ships
no data or training assets at all).

The port's own copy of ``gstreamer_vit_tracker_tpu/train/data.py`` (numpy
only, on the port's ``media/source.py``): for one seed its batches are
bit-equal to the JAX package's (``tests/test_torch_data.py``).
``set_diversity`` is module-level state here as there.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..config import ModelConfig
from ..media.source import SyntheticSource


def _normalize(img: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return (x - np.asarray(cfg.norm_mean)) / np.asarray(cfg.norm_std)


def _crop_np(img: np.ndarray, cx: float, cy: float, size: float,
             out: int) -> np.ndarray:
    """Host-side bilinear square crop with zero padding — pure numpy
    (dispatching device ops per training sample would bottleneck the input
    pipeline), with the same half-pixel-centre geometry as
    ops.resample.sampling_matrix so train and serve crops match."""
    h, w = img.shape[:2]
    scale = size / out
    sy = (cy - 0.5 * size) + (np.arange(out) + 0.5) * scale - 0.5
    sx = (cx - 0.5 * size) + (np.arange(out) + 0.5) * scale - 0.5

    def axis_weights(s, n):
        j0 = np.floor(s).astype(np.int64)
        f = s - j0
        w0 = np.where((j0 >= 0) & (j0 < n), 1.0 - f, 0.0)
        w1 = np.where((j0 + 1 >= 0) & (j0 + 1 < n), f, 0.0)
        return np.clip(j0, 0, n - 1), np.clip(j0 + 1, 0, n - 1), w0, w1

    y0, y1, wy0, wy1 = axis_weights(sy, h)
    x0, x1, wx0, wx1 = axis_weights(sx, w)
    imgf = img.astype(np.float32)
    a = imgf[np.ix_(y0, x0)] * (wy0[:, None] * wx0[None, :])[..., None]
    b = imgf[np.ix_(y0, x1)] * (wy0[:, None] * wx1[None, :])[..., None]
    c = imgf[np.ix_(y1, x0)] * (wy1[:, None] * wx0[None, :])[..., None]
    d = imgf[np.ix_(y1, x1)] * (wy1[:, None] * wx1[None, :])[..., None]
    return a + b + c + d


_SOURCE_POOL: dict = {}
_SOURCE_POOL_MAX = 256

# Scene-size diversity: targets near the edges of a large frame see much
# more zero padding in their search windows than on a small frame; training
# over several scene scales keeps the heads calibrated at the borders.
# Weighted list — small scenes are cheap and frequent, 1080p rarer (frame
# copies are ~6 MB each on the 1-core host).
_SCENE_SIZES = ((320, 256), (640, 512), (480, 384), (960, 768),
                (320, 256), (640, 512), (480, 384), (1920, 1080))


# Appearance diversity across the pool: the "quad" family dominates (it is
# the eval family) but gradient/stripe/noise targets and octave backgrounds
# break texture- and border-specific shortcuts, which transfers to unseen
# families (the held-out eval world).
_PATCH_STYLES = ("quad", "quad", "quad", "noise", "grad", "stripes")
_BG_STYLES = ("smooth", "smooth", "octave")
# Silhouette diversity (round-3 heldout work): non-rectangular targets
# (alpha-masked ellipse/diamond, gt box unchanged) and soft edges (alpha
# ramp over the outer fraction of the silhouette).  Trains "box the full
# extent even when the boundary fades into the background" — the observed
# heldout failure mode (soft-edged polygons boxed tighter than gt).
# Frequencies are deliberately LOW: a first cut at 40% masked + 50% faded
# targets made the from-scratch model under-commit everywhere (basic IoU
# 0.976 -> 0.916, conf ~0.65 on clean sequences) — too much boundary
# ambiguity reads as label noise.  ~25% masked, ~25% mildly faded keeps
# the clean-rect majority that anchors confidence.
_MASK_STYLES = ("none",) * 6 + ("ellipse", "diamond")
_EDGE_FADES = (0.0, 0.0, 0.0, 0.25)

# Round-5 diversity v2 (the independent-world generalisation fine-tune,
# VERDICT r4 items 2/8): adds the rotated harmonic-blob silhouette family
# and moving-background blobs (bg_motion) to ~1/3 of scenes, and slightly
# raises the soft-edge frequency.  The balance lesson above holds:
# the clean-rect majority that anchors confidence is preserved.
_MASK_STYLES_V2 = ("none",) * 5 + ("ellipse", "diamond", "blob")
_EDGE_FADES_V2 = (0.0, 0.0, 0.25, 0.12)
_PATCH_STYLES_V2 = ("quad", "quad", "noise", "grad", "stripes", "tiles")
# v3 (round-5 second iteration): the v2-trained checkpoint stopped the
# lattice balloon but still loses periodic-texture targets where big
# moving background blobs re-tint the search context (measured f35-80 on
# the independent dots seeds).  v3 doubles the tiles share (now with the
# two-tone high-frequency variant, media/source.py), and raises moving-
# background coverage to 1/2 of scenes with bigger, stronger blobs —
# the context-invariance regime, weighted harder.  Clean-rect majority
# still preserved (4/6 unmasked, 2/6 patches periodic).
_PATCH_STYLES_V3 = ("quad", "noise", "grad", "stripes", "tiles", "tiles")
_BGM_STRONG = dict(bg_motion_sigma=(24.0, 80.0), bg_motion_col=90.0)
_DIVERSITY = "v1"


def set_diversity(v: str) -> None:
    """Select the scene-style tables ('v1' = shipped recipe, 'v2'/'v3' =
    round-5 generalisation tables).  Clears the scene pool on change."""
    global _DIVERSITY
    assert v in ("v1", "v2", "v3")
    if v != _DIVERSITY:
        _SOURCE_POOL.clear()
    _DIVERSITY = v


def _pooled_source(seed: int, obj: int) -> SyntheticSource:
    """Scene construction dominates sample cost; reuse a bounded pool of
    pre-built scenes (seeds repeat, frames/jitter still vary)."""
    w, h = _SCENE_SIZES[seed % len(_SCENE_SIZES)]
    k0, ob = seed % 16, (obj // 8) * 8
    key = (k0, ob, w, _DIVERSITY)
    # Appearance styles are DETERMINISTIC functions of the key (not of the
    # full seed): every style combination would otherwise multiply the key
    # space ~20x past _SOURCE_POOL_MAX, and scene construction — not crop
    # sampling — dominates datagen cost on the 1-core host (measured: an
    # independent-style key space dropped datagen from ~50 to ~5
    # samples/s).  Styles still cover all families across the 16 k0 x obj
    # bands x sizes; a cache hit always returns exactly the styles this
    # key maps to.
    v23 = _DIVERSITY in ("v2", "v3")
    masks = _MASK_STYLES_V2 if v23 else _MASK_STYLES
    fades = _EDGE_FADES_V2 if v23 else _EDGE_FADES
    patches = {"v1": _PATCH_STYLES, "v2": _PATCH_STYLES_V2,
               "v3": _PATCH_STYLES_V3}[_DIVERSITY]
    pi = (k0 * 2 + ob // 8) % len(patches)
    bi = (k0 + w) % len(_BG_STYLES)
    mi = (k0 + ob // 8 + w) % len(masks)
    fi = (k0 // 2 + ob // 8) % len(fades)
    if _DIVERSITY == "v3":
        bgm = 5 if (k0 + ob // 8 + w // 160) % 2 == 0 else 0
        bgm_kw = _BGM_STRONG if bgm else {}
    else:
        bgm = 4 if (_DIVERSITY == "v2"
                    and (k0 + ob // 8 + w // 160) % 3 == 0) else 0
        bgm_kw = {}
    src = _SOURCE_POOL.get(key)
    if src is None:
        if len(_SOURCE_POOL) >= _SOURCE_POOL_MAX:
            _SOURCE_POOL.clear()
        src = SyntheticSource(
            w, h, obj_size=obj, seed=k0 * 131 + obj,
            patch_style=patches[pi], bg_style=_BG_STYLES[bi],
            mask_style=masks[mi], edge_fade=fades[fi], bg_motion=bgm,
            **bgm_kw)
        _SOURCE_POOL[key] = src
    return src


def _border_position(rng: np.random.Generator, span: int, obj: int) -> float:
    """Top-left coordinate hugging one border of a ``span``-wide axis:
    within half an object of the edge, so the search window (4x the object)
    is dominated by zero padding on that side."""
    off = rng.integers(0, max(obj // 2, 1))
    return float(off if rng.random() < 0.5 else span - obj - off)


def sample_raw(rng: np.random.Generator, cfg: ModelConfig,
               border_frac: float = 0.4, distractor_frac: float = 0.35,
               occlusion_frac: float = 0.3, full_occ_frac: float = 0.12,
               redetect_frac: float = 0.15, rotation_frac: float = 0.0,
               fade_frac: float = 0.0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One (template u8, search u8, gt) training triple; gt is
    (cx, cy, w, h, visible) in search-crop-normalised coords.

    With probability ``border_frac`` the target is placed hard against a
    frame border/corner instead of on the Lissajous path — the regime where
    the round-1 checkpoint lost targets (search windows there are heavily
    zero-padded, and the padding fraction grows with scene size).

    Hard-world samples (round-3 robustness — the real tracker faces scale
    change, lookalike clutter and occlusion, tracker_context.rs:120-138):

    * the target renders at a per-sample scale (size head sees real size
      variation in PIXELS, not just window-scale jitter);
    * ``distractor_frac``: a lookalike patch from a DIFFERENT scene lands
      near (never centred on) the target — discrimination supervision;
    * ``occlusion_frac``: an occluding slab covers part of the target
      (labels intact), or — ``full_occ_frac`` of all samples — covers it
      entirely, labelled ``visible=0`` (trains the all-negative score map
      the Lost machine's 0.25 threshold depends on).

    The template crop is taken BEFORE distractor/occluder pasting: the
    template is always clean, matching serve-time init on a confirmed box.

    ``rotation_frac`` (default OFF): that fraction of samples renders the
    target spun in-plane — template at a random base angle, search at a
    DIFFERENT angle (base + uniform ±180°) via a second render of the same
    scene — so matching must survive arbitrary template/search rotation
    mismatch, the regime a frame-0 template faces on a spinning target
    (eval `--scenario rotation`).  Rotation-invariant cues (colour layout)
    are all that survives large mismatch; keep the fraction modest or the
    correlation supervision reads as label noise.

    ``fade_frac`` (default OFF): that fraction of samples darkens the
    TARGET in the search render to 30-100% brightness while the template
    stays bright (half the time) or is darkened to a near-matching level
    (the other half — an online-updated template a few frames stale).
    ``visible`` stays 1.0: a darkened target is still the target, which
    is exactly the cue the occlusion negatives (gray slabs, also dark)
    otherwise teach the confidence head to collapse on — observed as the
    deep-fade tail of the drift scenario losing track after the
    occlusion-balanced fine-tune (eval `--scenario drift`,
    appearance_drift >= 0.005).
    """
    seed = int(rng.integers(0, 2 ** 31))
    obj = int(rng.integers(32, 72))
    src = _pooled_source(seed, obj)
    scale = float(np.exp(rng.uniform(np.log(0.7), np.log(1.5))))
    sobj = max(8, int(round(obj * scale)))
    theta = delta = 0.0
    fade_z = fade_x = 1.0
    if rotation_frac and rng.random() < rotation_frac:
        theta = float(rng.uniform(0.0, 360.0))
        delta = float(rng.uniform(-180.0, 180.0))
    if fade_frac and rng.random() < fade_frac:
        fade_x = float(np.exp(rng.uniform(np.log(0.3), np.log(1.0))))
        if rng.random() < 0.5:      # updated-template regime: mild mismatch
            fade_z = float(np.clip(
                fade_x * np.exp(rng.uniform(np.log(0.8), np.log(1.25))),
                0.25, 1.0))
    if rng.random() < border_frac:
        # Border sample: at least one axis pinned to an edge.
        axes = rng.integers(0, 3)  # 0: x edge, 1: y edge, 2: corner
        px = (_border_position(rng, src.width, sobj) if axes != 1
              else float(rng.integers(0, max(src.width - sobj, 1) + 1)))
        py = (_border_position(rng, src.height, sobj) if axes != 0
              else float(rng.integers(0, max(src.height - sobj, 1) + 1)))
        fi_ = 0
    else:
        fi_ = int(rng.integers(0, 200))
        px, py, _, _ = src.bbox_at(fi_)
    frame, (x, y, w, h) = src.frame_rgb_at(px, py, fi_, scale=scale,
                                           rotation_deg=theta, fade=fade_z)
    cx, cy = x + w / 2, y + h / 2

    # Template: window around the target, mildly jittered (the online
    # template update re-crops at the *predicted* box, never exactly gt).
    tj = float(np.exp(rng.uniform(np.log(0.95), np.log(1.05))))
    zsize = float(np.ceil(cfg.template_factor * np.sqrt(w * h) * tj))
    zx = cx + rng.uniform(-0.05, 0.05) * w
    zy = cy + rng.uniform(-0.05, 0.05) * h
    z = _crop_np(frame, zx, zy, zsize, cfg.template_size)

    dfi = 0
    if src.bg_motion and rng.random() < 0.5:
        # Moving-structure mismatch: re-render the SEARCH side a few
        # frames later so the bg_motion blobs have moved between the
        # template capture and the search frame while the target stayed
        # put — the cue that moving background structure is not the
        # target (the independent world's drifting-blob failure mode).
        dfi = int(rng.integers(1, 40))
    if delta or fade_x != fade_z or dfi:
        # Search-side render at a mismatched angle / brightness / time
        # (same scene/position — bbox is invariant by construction).
        frame, _ = src.frame_rgb_at(px, py, fi_ + dfi, scale=scale,
                                    rotation_deg=theta + delta,
                                    fade=fade_x)

    # --- Hard-world pasting (after the template crop, before the search
    # crop, in place on the shared frame buffer).
    visible = 1.0
    if rng.random() < distractor_frac:
        src2 = _pooled_source(seed + 3, obj)
        dsize = max(8, int(round(w * rng.uniform(0.7, 1.3))))
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(0.9, 2.2) * w
        dx = int(round(cx + rad * np.cos(ang) - dsize / 2))
        dy = int(round(cy + rad * np.sin(ang) - dsize / 2))
        src._paste(frame, src2._patch_at(dsize), dx, dy,
                   src2._alpha_at(dsize))
    u = rng.random()
    if u < full_occ_frac:
        # Full occlusion: slab bigger than the target, centred on it.
        # MEASURED DEAD END (round 3, do not revisit without new data):
        # "diversified" negatives — slabs at randomized base brightness
        # 30-160 plus darkened TEXTURED patches from another scene —
        # were supposed to break the brightness shortcut that fade_frac
        # positives erode.  A/B at identical hyperparams (2000 steps,
        # lr 1e-4, full-occ 0.35, fade 0.1, flagship warm-start): they
        # sharpen the hidden-confidence collapse (hidden max 0.73 ->
        # 0.34) but over-suppress confidence on legitimately dark
        # targets — deep-fade drift fell 0.948/0-lost -> 0.916/20-lost
        # and overall confidence dropped ~0.96 -> ~0.65.  The plain
        # mid-gray slab at full-occ-frac 0.35 + fade-frac 0.1 already
        # restores the committed collapse (hidden_below_thr_frac 0.944)
        # while keeping deep drift at 0.948.
        ow, oh = int(round(1.3 * w)), int(round(1.3 * h))
        occ = np.clip(rng.normal(0, 8, (oh, ow, 3))
                      + rng.integers(70, 110), 0, 255).astype(np.uint8)
        src._paste(frame, occ,
                   int(round(cx - ow / 2 + rng.uniform(-0.05, 0.05) * w)),
                   int(round(cy - oh / 2 + rng.uniform(-0.05, 0.05) * h)))
        visible = 0.0
    elif u < occlusion_frac:
        # Partial occlusion: a side strip, 25-60% of the width.
        ow = max(2, int(round(w * rng.uniform(0.25, 0.6))))
        oh = int(round(1.2 * h))
        occ = np.clip(rng.normal(0, 8, (oh, ow, 3))
                      + rng.integers(70, 110), 0, 255).astype(np.uint8)
        ox_ = int(round(x if rng.random() < 0.5 else x + w - ow))
        src._paste(frame, occ, ox_, int(round(cy - oh / 2)))

    # Search: window around a jittered box (simulating motion between
    # frames); gt expressed inside that window.  The window SCALE is
    # jittered log-uniformly: at serve time the window is sized from the
    # *predicted* previous box, so the normalised gt size must vary in
    # training — without this the size label is the constant
    # w/ceil(4w) ~= 0.25, the head learns to echo 0.25 of any window, and
    # the serve loop turns ceil()'s upward bias into a ~1 px/frame box
    # inflation that diverges within ~40 frames (observed round 2).
    if rng.random() < redetect_frac:
        # Re-detection regime: the serve-time lost ramp expands the search
        # window up to lost_window_max_growth x (tracker/core.py) with the
        # target far off-centre (it drifted while hidden).  Train that
        # geometry: wide window, large centre offset, small normalised
        # size.
        sj = float(np.exp(rng.uniform(np.log(1.4), np.log(3.6))))
        # Offset up to +-1.4*w*sj = 70% of the way to the window edge
        # (window half-extent is 2*w*sj), i.e. gt centre lands anywhere
        # in [0.15, 0.85] of the crop.
        jx = cx + rng.uniform(-1.4, 1.4) * w * sj
        jy = cy + rng.uniform(-1.4, 1.4) * h * sj
    else:
        sj = float(np.exp(rng.uniform(np.log(0.7), np.log(1.4))))
        jx = cx + rng.uniform(-0.5, 0.5) * w
        jy = cy + rng.uniform(-0.5, 0.5) * h
    ssize = float(np.ceil(cfg.search_factor * np.sqrt(w * h) * sj))
    xim = _crop_np(frame, jx, jy, ssize, cfg.search_size)

    ox, oy = jx - ssize / 2, jy - ssize / 2
    gt = np.array([(cx - ox) / ssize, (cy - oy) / ssize,
                   w / ssize, h / ssize, visible], np.float32)
    to_u8 = lambda a: np.clip(np.round(a), 0, 255).astype(np.uint8)  # noqa: E731
    return to_u8(z), to_u8(xim), gt


def make_batch(rng: np.random.Generator, batch: int, cfg: ModelConfig,
               border_frac: float = 0.4
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (z_imgs (B,Hz,Wz,3), x_imgs (B,Hx,Wx,3), gt (B,5)) —
    normalised crops + (cx, cy, w, h, visible) in search-crop-normalised
    coords (visible=0 marks fully-occluded negatives)."""
    z_list, x_list, gt_list = [], [], []
    for _ in range(batch):
        z, x, gt = sample_raw(rng, cfg, border_frac)
        z_list.append(_normalize(z, cfg))
        x_list.append(_normalize(x, cfg))
        gt_list.append(gt)
    return (np.stack(z_list), np.stack(x_list), np.stack(gt_list))


def make_dataset(seed: int, n: int, cfg: ModelConfig,
                 border_frac: float = 0.4, log_every: int = 0,
                 **sample_kw) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pre-generate an n-sample dataset as uint8 crop stacks.

    Host data generation is far slower than a training step, so long runs
    pre-generate once, move the stacks to the device, and sample
    minibatches there (train.step.train_scan), with augmentation restoring
    variety.  ``sample_kw`` passes through to
    :func:`sample_raw` (e.g. ``full_occ_frac``)."""
    rng = np.random.default_rng(seed)
    zs, xs, gts = [], [], []
    for i in range(n):
        z, x, gt = sample_raw(rng, cfg, border_frac, **sample_kw)
        zs.append(z)
        xs.append(x)
        gts.append(gt)
        if log_every and (i + 1) % log_every == 0:
            print(f"  dataset {i + 1}/{n}", flush=True)
    return np.stack(zs), np.stack(xs), np.stack(gts)


def batch_iterator(seed: int, batch: int, cfg: ModelConfig
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        yield make_batch(rng, batch, cfg)
