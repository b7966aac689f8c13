"""PyTorch port: ``ops/fused_prep_embed.py`` (TPU kernel 5's counterpart)
against the JAX package on the CPU.

JAX's ``fpe.nv12_search_tokens`` runs the Pallas kernel in interpret mode on
the CPU; on CPU planes the port's ``nv12_search_tokens`` is its plain
version ``nv12_search_tokens_reference``, which the CUDA kernel is held to
on the card.  The cases are those of ``tests/test_fused_prep_embed.py``,
on seeded numpy frames and weights fed to both sides: both modes in
float32 (atol 1e-4, rtol 1e-4), a window hanging off the frame edge, a
banded 1080p frame, bf16 (0.05), the embed widths 48, 80, 160, 384 and 768
in both dtypes, each also against the port's unfused chain
``preprocess_nv12`` -> ``embed_search``; and ``core.update(
fused_prep=True)`` against JAX's over 5 frames (bbox 0.25 px, score 0.02).
:func:`plan` is held over every embed width from 1 to 1024.

What the CUDA route adds and a CPU run can check: the window geometry the
kernel works out on the device (``window_geometry`` in
``csrc/fused_prep_embed.cu``), written here in numpy float32 operation by
operation, equals ``_band`` bit for bit on a half-to-even tie, the band's
corners, a frame smaller than the band and a window larger than it; the
embed operands are made once per parameter set (reused, rebuilt after an
in-place update, bypassed under a gradient); the planes and the window's
scalars reach the launch as they lie.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import fused_prep_embed as jfpe  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import preprocess as jpp  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit as tvit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack as tvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as tfpe  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402

CPU = torch.device("cpu")
# A narrow model at the flagship's crop geometry: search 128, patch 16.
KW = dict(template_size=64, search_size=128, patch_size=16, embed_dim=48,
          depth=1, num_heads=2)


def _cfgs(dtype, **over):
    kw = dict(KW, dtype=dtype, **over)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _embed_params(cfg, seed):
    """Only what the fused path reads: patch embed and search pos embed."""
    rng = np.random.default_rng(seed)
    k = cfg.patch_size ** 2 * 3
    host = {"patch_embed": {
        "kernel": (0.05 * rng.standard_normal((k, cfg.embed_dim))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(cfg.embed_dim)).astype(np.float32)},
        "pos_embed_x": (0.1 * rng.standard_normal(
            (cfg.num_search_tokens, cfg.embed_dim))).astype(np.float32)}
    jparams = {"backbone": jax.tree.map(jnp.asarray, host)}
    tparams = {"backbone": {
        "patch_embed": {f: torch.from_numpy(a)
                        for f, a in host["patch_embed"].items()},
        "pos_embed_x": torch.from_numpy(host["pos_embed_x"])}}
    return jparams, tparams


def _nv12(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2, 2), dtype=np.uint8))


def _case(dtype, shape, box, seed, mode, tol, **over):
    cfg_j, cfg_t = _cfgs(dtype, **over)
    jparams, tparams = _embed_params(cfg_t, seed)
    y, uv = _nv12(shape, seed)
    jwin = jpp.crop_window(jnp.asarray(box, jnp.float32), cfg_j.search_factor)
    twin = tpp.crop_window(torch.tensor(box), cfg_t.search_factor)
    ref = jfpe.nv12_search_tokens(jparams, jnp.asarray(y), jnp.asarray(uv),
                                  jwin, cfg_j, mode=mode)    # interpret mode
    ty, tuv = torch.from_numpy(y), torch.from_numpy(uv)
    got = tfpe.nv12_search_tokens(tparams, ty, tuv, twin, cfg_t, mode=mode)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert got.dtype == tdt
    assert got.shape == (cfg_t.num_search_tokens, cfg_t.embed_dim)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)
    # ... and the port's unfused chain gives the same tokens.
    x_img = tpp.preprocess_nv12(ty, tuv, twin, cfg_t.search_size,
                                cfg_t.norm_mean, cfg_t.norm_std, dtype=tdt,
                                band=cfg_t.preprocess_band)
    chain = tvit.embed_search(tparams["backbone"], x_img[None], cfg_t)[0]
    np.testing.assert_allclose(got.float().numpy(), chain.float().numpy(),
                               atol=tol, rtol=tol)
    # On CPU planes the wrapper is the plain version, nothing else.
    assert torch.equal(got, tfpe.nv12_search_tokens_reference(
        tparams, ty, tuv, twin, cfg_t, mode=mode))


@pytest.mark.parametrize("mode", ["transpose", "loop"])
def test_matches_pallas_kernel_f32(mode):
    _case("float32", (256, 320), [150.0, 100.0, 32.0, 32.0], 0, mode, 1e-4)


@pytest.mark.parametrize("mode", ["transpose", "loop"])
def test_zero_padding_at_frame_edge(mode):
    """Window hanging off the frame: padding decodes to black."""
    _case("float32", (256, 320), [-10.0, 230.0, 40.0, 40.0], 1, mode, 1e-4)


def test_banded_1080p_matches():
    """Frame larger than the band: the fused path bands identically (the
    flagship's band, 1152)."""
    cfg = ModelConfig(**KW)
    assert cfg.preprocess_band == 1152 < 1920
    _case("float32", (1080, 1920), [1500.0, 700.0, 64.0, 64.0], 2, "loop",
          1e-4)


def test_small_band_at_the_frame_corner():
    """A band narrower than the window's reach, clamped into the corner:
    the out-of-band fringe samples as zero, exactly as JAX's slice."""
    _case("float32", (300, 400), [330.0, 250.0, 60.0, 50.0], 3, "transpose",
          1e-4, preprocess_band=192)


def test_bf16_close_to_pallas_bf16():
    _case("bfloat16", (256, 320), [130.0, 90.0, 36.0, 36.0], 4, "loop", 0.05)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
@pytest.mark.parametrize("dim", [48, 80, 160, 384, 768])
def test_embed_widths_match_pallas(dim, dtype, tol):
    """The embed widths the kernel runs padded (no multiple of 32, or more
    than one cluster of 32-column tiles), through the plain version."""
    _case(dtype, (256, 320), [140.0, 110.0, 40.0, 36.0], 10 + dim % 7,
          "transpose" if dim % 3 else "loop", tol, embed_dim=dim,
          num_heads=dim // 16)


def test_plan_takes_every_width():
    """Every embed width from 1 to 1024 plans in both dtypes, to a padded
    width its tiles and clusters cover exactly; ``simt`` only by name."""
    for dim in range(1, 1025):
        for dt in (torch.float32, torch.bfloat16):
            p = tfpe.plan(dim, dt)
            if dt == torch.float32:
                # The narrowest tile that makes one cluster of at most 6,
                # else 32 columns in clusters of at most 6.
                one = [c for c in (8, 16, 24, 32) if -(-dim // c) <= 6]
                cols, most = (one[0] if one else 32), 6
                assert p.variant == "tf32x3", p
            else:
                # 32 columns in one cluster up to D 256, then 64 columns.
                cols, most = (32 if dim <= 256 else 64), 8
                assert p.variant == "mma", p
            assert (p.tokens, p.cols) == (16, cols), (dim, p)
            tiles, clusters = -(-dim // cols), p.width // (cols * p.cluster)
            # The fewest equal clusters, padding less than a tile a cluster.
            assert p.width % (cols * p.cluster) == 0 and p.cluster <= most, p
            assert clusters == -(-tiles // most), (dim, p)
            assert dim <= p.width < dim + cols * clusters, (dim, p)
            if tiles <= most:
                assert (p.cluster, p.width) == (tiles, cols * tiles), p
        s = tfpe.plan(dim, torch.float32, "simt")
        assert s == tfpe.Plan("simt", 2, 0, 1, -(-dim // 4) * 4)


def test_modes_agree_and_bad_arguments_raise():
    _, cfg = _cfgs("float32")
    _, tparams = _embed_params(cfg, 5)
    y, uv = map(torch.from_numpy, _nv12((128, 160), 5))
    win = tpp.crop_window(torch.tensor([60.0, 50.0, 20.0, 20.0]),
                          cfg.search_factor)
    a = tfpe.nv12_search_tokens(tparams, y, uv, win, cfg, mode="loop")
    b = tfpe.nv12_search_tokens(tparams, y, uv, win, cfg, mode="transpose")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="mode"):
        tfpe.nv12_search_tokens(tparams, y, uv, win, cfg, mode="fast")
    with pytest.raises(ValueError, match="uv_plane"):
        tfpe.nv12_search_tokens(tparams, y, uv[:, :-1], win, cfg)
    with pytest.raises(ValueError, match="y_plane"):
        tfpe.nv12_search_tokens(tparams, y.float(), uv, win, cfg)
    two = tpp.crop_window(torch.tensor([[60.0, 50.0, 20.0, 20.0]] * 2),
                          cfg.search_factor)
    with pytest.raises(ValueError, match="one window"):
        tfpe.nv12_search_tokens(tparams, y, uv, two, cfg)
    # The raw launch has no CPU mode.
    with pytest.raises(ValueError, match="CUDA"):
        tfpe.launch(*tfpe.kernel_operands(tparams, y, uv, win, cfg), cfg)


# ---------------------------------------------------------------------------
# What the CUDA route computes before its pixels, and its operands
# ---------------------------------------------------------------------------

def _rounded_origin(centre, band):
    """The band origin of ``band_origin`` in ``csrc/fused_prep_embed.cu``
    before its clamp and even snap: ``rintf(centre - band / 2)`` in numpy
    float32 (``np.rint`` rounds half to even, as ``rintf`` does)."""
    f = np.float32
    return np.rint(f(centre) - f(0.5) * f(band))


def _kernel_geometry(cx, cy, size, h, w, band, out_size):
    """``window_geometry`` of ``csrc/fused_prep_embed.cu`` in numpy float32:
    start = (centre - 0.5 * size) - origin; on each axis the origin is
    round(centre - band / 2) half to even (``rintf``), clamped to [0,
    max(limit - band, 0)] and snapped down to even, and a band exists only
    where the frame is larger than it on some axis; scale = size /
    out_size.  Returns (start_y, start_x, scale, row0, col0, bh, bw)."""
    f = np.float32
    half = f(0.5) * f(size)
    sy, sx = f(cy) - half, f(cx) - half
    scale = f(size) / f(out_size)
    if not band or not (h > band or w > band):
        return sy, sx, scale, 0, 0, h, w

    def origin(centre, limit):
        r = _rounded_origin(centre, band)
        return int(min(max(r, f(0.0)), f(max(limit - band, 0)))) & ~1

    row0, col0 = origin(cy, h), origin(cx, w)
    return (sy - f(row0), sx - f(col0), scale, row0, col0, min(band, h),
            min(band, w))


@pytest.mark.parametrize("frame,centre,size,band", [
    ((1080, 1920), (1000.5, 700.0), 64.0, 1152),    # cx - 576 = 424.5: a tie
    ((1080, 1920), (575.5, 700.0), 64.0, 1152),     # -0.5: a tie below 0
    ((300, 400), (401.5, 290.5), 60.0, 192),        # 305.5 / 194.5, clamped
    ((300, 400), (3.0, 1.5), 50.0, 192),            # the band's top-left corner
    ((1080, 1080), (900.0, 100.0), 300.0, 1152),    # a frame smaller than the band
    ((1080, 1920), (800.0, 500.0), 1544.0, 1152),   # a window larger than it
    ((256, 320), (150.0, 100.0), 32.0, None),       # no band at all
])
def test_kernel_geometry_equals_band(frame, centre, size, band):
    h, w = frame
    win = tpp.CropWindow(cx=torch.tensor(centre[0]), cy=torch.tensor(centre[1]),
                         size=torch.tensor(size))
    sy, sx, origin, bh, bw = tfpe._band(torch.empty(frame, dtype=torch.uint8),
                                        win, band)
    got = _kernel_geometry(*centre, size, h, w, band, 256)
    want = (sy.item(), sx.item(), (win.size / 256).item(), int(origin[0]),
            int(origin[1]), bh, bw)
    assert got == want
    assert all(type(v) is np.float32 for v in got[:3])


@pytest.mark.parametrize("centre,band", [
    (1000.5, 1152),                 # 424.5: half to even 424, away 425
    (575.5, 1152),                  # -0.5: half to even -0, away -1
    (400.5, 192),                   # 304.5: 304 against 305
])
def test_band_origin_ties_round_half_to_even(centre, band):
    # pp.band_origin rounds with torch.round, half to even; the kernel
    # rounds with rintf for it, and the numpy twin of its geometry with
    # np.rint.  On these ties half away from zero (roundf) gives another
    # value before the snap, so the rule is held here, un-snapped.
    v = np.float32(centre) - np.float32(0.5) * np.float32(band)
    assert abs(v - np.trunc(v)) == 0.5
    got = _rounded_origin(centre, band)
    assert got == torch.round(torch.tensor(float(v))).item()
    away = np.copysign(np.floor(abs(v) + np.float32(0.5)), v)
    assert got != away
    # It cannot be seen in the kernel's output: both clamp limits are even,
    # so the clamp and the even snap take n + 0.5 to the same origin
    # whichever way it rounds.  Every tie up to past the clamp, either way:
    hi = 1920 - band
    ties = np.arange(-4, hi + 4, dtype=np.float32) + np.float32(0.5)

    def snapped(r):
        return np.clip(r, 0, hi).astype(np.int64) & ~1

    np.testing.assert_array_equal(
        snapped(np.rint(ties)),
        snapped(np.copysign(np.floor(np.abs(ties) + 0.5), ties)))


def _unpadded(t, dim):
    """The first ``dim`` columns of a padded operand, its pad checked zero."""
    assert not t[..., dim:].any()
    return t[..., :dim]


def test_embed_operand_cache():
    _, cfg = _cfgs("bfloat16")
    _, tparams = _embed_params(cfg, 6)
    pe = tparams["backbone"]["patch_embed"]
    a = tfpe.embed_operands(tparams, torch.bfloat16)
    assert tfpe.embed_operands(tparams, torch.bfloat16) is a      # reused
    # D 48 runs padded to the plan's width, 64: zeros past column 48.
    assert a[0].shape[-1] == a[1].shape[-1] == 64
    assert torch.equal(_unpadded(a[0], 48), pe["kernel"].to(torch.bfloat16))
    assert torch.equal(_unpadded(a[1], 48), (tparams["backbone"]["pos_embed_x"]
                                             + pe["bias"]).to(torch.bfloat16))
    assert tfpe.embed_operands(tparams, torch.float32) is not a   # another dtype
    with torch.no_grad():
        pe["bias"].add_(1.0)          # an optimiser step: same tensor, new version
    b = tfpe.embed_operands(tparams, torch.bfloat16)
    assert b is not a and torch.equal(
        _unpadded(b[1], 48), (tparams["backbone"]["pos_embed_x"]
                              + pe["bias"]).to(torch.bfloat16))
    tparams["backbone"]["pos_embed_x"] = tparams["backbone"]["pos_embed_x"].clone()
    c = tfpe.embed_operands(tparams, torch.bfloat16)              # a new leaf
    assert c is not b and torch.equal(c[1], b[1])
    # Under a gradient nothing is kept: made on every call.
    pe["kernel"].requires_grad_(True)
    g1 = tfpe.embed_operands(tparams, torch.bfloat16)
    assert tfpe.embed_operands(tparams, torch.bfloat16) is not g1
    assert torch.equal(g1[0], c[0])
    with torch.no_grad():
        d = tfpe.embed_operands(tparams, torch.bfloat16)
        assert tfpe.embed_operands(tparams, torch.bfloat16) is d


def test_kernel_operands_are_taken_as_they_lie():
    # Ready parameters, contiguous planes and crop_window's scalars reach
    # the launch as the same tensors: no copy, no cast, no stacked scalars.
    _, cfg = _cfgs("float32")
    _, tparams = _embed_params(cfg, 7)
    y, uv = map(torch.from_numpy, _nv12((128, 160), 7))
    win = tpp.crop_window(torch.tensor([60.0, 50.0, 20.0, 20.0]),
                          cfg.search_factor)
    ops = tfpe.kernel_operands(tparams, y, uv, win, cfg)
    assert ops[0] is y and ops[1] is uv
    assert all(o is t for o, t in zip(ops[2:5], win))
    assert ops[5:] == tfpe.embed_operands(tparams, torch.float32)
    # A plane the kernel cannot read in place is copied, values unchanged.
    wide = torch.from_numpy(_nv12((128, 164), 7)[0])[:, :160]
    got = tfpe.kernel_operands(tparams, wide, uv, win, cfg)[0]
    assert got.is_contiguous() and torch.equal(got, wide)
    assert tfpe.plan(cfg.embed_dim, torch.float32) == tfpe.Plan(
        "tf32x3", 16, 8, 6, 48)
    assert tfpe.plan(cfg.embed_dim, torch.float32, "simt") == tfpe.Plan(
        "simt", 2, 0, 1, 48)
    assert tfpe.plan(192, torch.bfloat16) == tfpe.Plan("mma", 16, 32, 6, 192)
    # bf16 widths no multiple of 32, or above 256 (more than one cluster of
    # 32-column tiles), run padded: 200 on 7 tiles, 288 on 64-column tiles in
    # one cluster of 5.
    assert tfpe.plan(200, torch.bfloat16) == tfpe.Plan("mma", 16, 32, 7, 224)
    assert tfpe.plan(288, torch.bfloat16) == tfpe.Plan("mma", 16, 64, 5, 320)
    with pytest.raises(ValueError, match="below 1"):
        tfpe.plan(0, torch.bfloat16)
    # Above 1024 both dtypes plan (64 columns in 3 clusters of 6 at 1025);
    # simt, by name, stops at 1024.
    assert tfpe.plan(1025, torch.bfloat16) == tfpe.Plan("mma", 16, 64, 6, 1152)
    with pytest.raises(ValueError, match="simt takes"):
        tfpe.plan(1025, torch.float32, "simt")
    with pytest.raises(TypeError):
        tfpe.plan(192, torch.float16)
    with pytest.raises(TypeError):
        tfpe.plan(192, torch.bfloat16, "simt")


# ---------------------------------------------------------------------------
# The tracking step routed through the fused path
# ---------------------------------------------------------------------------

def _clip(n, h=256, w=320, box=(140, 100, 40, 32), step=(3, 2), seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg = (70 + 25 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
          + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.uint8)
    bg_uv = (128 + rng.normal(0, 3, (h // 2, w // 2, 2))).clip(
        0, 255).astype(np.uint8)
    bw, bh = box[2], box[3]
    ty, tx = np.mgrid[0:bh, 0:bw]
    tex = (185 + 60 * (((tx // 8) + (ty // 8)) % 2)).astype(np.uint8)
    frames = []
    for t in range(n):
        x0, y0 = box[0] + step[0] * t, box[1] + step[1] * t
        x0, y0 = x0 - x0 % 2, y0 - y0 % 2
        y, uv = bg.copy(), bg_uv.copy()
        y[y0:y0 + bh, x0:x0 + bw] = tex
        uv[y0 // 2:(y0 + bh) // 2, x0 // 2:(x0 + bw) // 2] = (90, 200)
        frames.append((y, uv))
    return frames, [float(v) for v in box]


@pytest.mark.parametrize("fused_prep", [True, "transpose"])
def test_update_fused_prep_matches_jax(fused_prep):
    cfg_j = dataclasses.replace(JAX_PRESETS["small"], preprocess_band=192)
    cfg_t = dataclasses.replace(PRESETS["small"], preprocess_band=192)
    path = tweights.checkpoint_path("small")
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg_j))
    jparams = jvittrack.with_grouped_head(jweights.load_npz(path, like))
    tparams = tvittrack.with_grouped_head(
        tweights.load_npz(path, cfg_t, device=CPU))
    frames, bbox = _clip(6)
    jupd = jax.jit(functools.partial(
        jcore.update, cfg=cfg_j, frame_format="nv12", use_pallas=False,
        fused=False, fused_prep=fused_prep))
    jst = jcore.init(jparams, tuple(map(jnp.asarray, frames[0])),
                     jnp.asarray(bbox), cfg_j, frame_format="nv12")
    tst = tcore.init(tparams, frames[0], bbox, cfg_t, frame_format="nv12",
                     device=CPU)
    pst = tst
    for i, f in enumerate(frames[1:], 1):
        jst, jb, jc = jupd(jparams, jst, tuple(map(jnp.asarray, f)))
        tst, tb, tc = tcore.update(tparams, tst, f, cfg_t, "nv12", CPU,
                                   fused_prep=fused_prep)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=0.25,
                                   err_msg=f"bbox, frame {i}")
        assert abs(float(tc) - float(jc)) <= 0.02, (i, float(tc), float(jc))
        # ... and the port's own plain step from the same clip.
        pst, pb, pc = tcore.update(tparams, pst, f, cfg_t, "nv12", CPU)
        np.testing.assert_allclose(tb.numpy(), pb.numpy(), atol=0.25)
        assert abs(float(tc) - float(pc)) <= 0.02
    assert float(tc) > 0.3      # it is tracking, not frozen on a lost box


def test_fused_prep_is_ignored_on_other_formats():
    """As in JAX: ``fused_prep`` with a non-NV12 frame takes the plain
    route."""
    cfg = PRESETS["small"]
    params = tvittrack.with_grouped_head(tweights.load_npz(
        tweights.checkpoint_path("small"), cfg, device=CPU))
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    st = tcore.init(params, rgb, [40.0, 30.0, 24.0, 20.0], cfg, device=CPU)
    _, b0, c0 = tcore.update(params, st, rgb, cfg, device=CPU)
    _, b1, c1 = tcore.update(params, st, rgb, cfg, device=CPU, fused_prep=True)
    assert torch.equal(b0, b1) and torch.equal(c0, c1)
