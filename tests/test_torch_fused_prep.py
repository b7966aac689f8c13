"""PyTorch port: ``ops/fused_prep_embed.py`` (TPU kernel 5's counterpart)
against the JAX package on the CPU.

JAX's ``fpe.nv12_search_tokens`` runs the Pallas kernel in interpret mode on
the CPU; on CPU planes the port's ``nv12_search_tokens`` is its plain
version ``nv12_search_tokens_reference``, which the CUDA kernel is held to
on the card.  The cases are those of ``tests/test_fused_prep_embed.py``,
on seeded numpy frames and weights fed to both sides: both modes in
float32 (atol 1e-4, rtol 1e-4), a window hanging off the frame edge, a
banded 1080p frame, bf16 (0.05), each also against the port's unfused
chain ``preprocess_nv12`` -> ``embed_search``; and ``core.update(
fused_prep=True)`` against JAX's over 5 frames (bbox 0.25 px, score 0.02).
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
