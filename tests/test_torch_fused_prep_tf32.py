"""PyTorch port: the ``tf32x3`` variant of the NV12-to-tokens kernel (kernel
5 in float32, ``csrc/fused_prep_embed.cu::embed_tf32_kernel``) on the CPU.

The kernel runs only on the card; what a CPU run can hold of it is its
arithmetic, emulated here step for step where it rounds:

* the pixels: the A tile the kernel makes, ``search_pixels_reference`` (the
  plain version's crop, patchified, k = (p, q, c));
* the operands: the operand cache's weight as two planes (2, K, W), hi =
  tf32(w) and lo = tf32(w - hi) by ``ops/vit_block.py::split_tf32``, and pos
  + bias (N, W), both zero in the columns past D where the plan pads D to
  W;
* the product: A split as its fragment is loaded, three products an 8-deep
  step (lo.hi, hi.lo, then hi.hi, each sum rounded toward zero as the
  tensor cores round it), a 32-deep chunk's even and odd steps in two fresh
  accumulators added in float32, warp w of 8 summing the chunks w, w + 8,
  ... and the eight warps' sums added in warp order, then pos + bias in
  float32: ``tests/test_torch_encoder_tf32.py``'s ``_products`` with 8
  groups, imported, not copied.

The emulation is held to the plain version (both modes) and to JAX's
``ops/fused_prep_embed.py::nv12_search_tokens`` in interpret mode, as the
JAX package's own tests run it, on the same seeded numpy planes and weights
at the ``small`` preset's shape (search 128, patch 16, D 96), corr-tiny's
(patch 8, K 192, D 64) and the flagship's (search 256, D 192), float32,
within 1e-4 absolute (``chip_smoke.py``'s ``PREP_F32_ATOL``).  A planted
fault, hi.hi alone in place of three products, misses that bound at all
three.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import fused_prep_embed as jfpe  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import preprocess as jpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as tfpe  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import vit_block  # noqa: E402
from test_torch_encoder_tf32 import _products  # noqa: E402

F32 = torch.float32
PREP_F32_ATOL = 1e-4     # chip_smoke.py: the card against the plain version
WARPS = 8                # a CTA's warps, each summing every 8th chunk of K


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small products: one intra-op thread, which runs them as fast
    alone and does not crawl beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset):
    cfg = dataclasses.replace(PRESETS[preset], dtype="float32")
    fields = {f.name for f in dataclasses.fields(JaxModelConfig)}
    return JaxModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                             if k in fields}), cfg


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    k, d = cfg.patch_size ** 2 * 3, cfg.embed_dim
    host = {"patch_embed": {
        "kernel": (0.05 * rng.standard_normal((k, d))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)},
        "pos_embed_x": (0.1 * rng.standard_normal(
            (cfg.num_search_tokens, d))).astype(np.float32)}
    jparams = {"backbone": jax.tree.map(jnp.asarray, host)}
    tparams = {"backbone": {
        "patch_embed": {f: torch.from_numpy(a)
                        for f, a in host["patch_embed"].items()},
        "pos_embed_x": torch.from_numpy(host["pos_embed_x"])}}
    return jparams, tparams


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2, 2), dtype=np.uint8))


def emulate(tparams, y, uv, win, cfg, three=True):
    """The tokens (N, D) as ``embed_tf32_kernel`` computes them."""
    chosen = tfpe.plan(cfg.embed_dim, F32)
    planes, pos_bias = tfpe.embed_operands(tparams, F32, chosen)
    pixels = tfpe.search_pixels_reference(y, uv, win, cfg)
    tok = _products(pixels, planes[0], planes[1], three, chunk=32, wgs=WARPS)
    return (tok + pos_bias)[:, :cfg.embed_dim]


# A window inside the frame and one over its edge, on a frame larger than
# the flagship's band (1152) in neither axis.
CASES = [((512, 640), (300.0, 200.0, 64.0, 64.0)),
         ((512, 640), (-20.0, 470.0, 80.0, 80.0))]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("preset", ["small", "corr-tiny", "vittrack-t"])
def test_emulation_matches_plain_and_pallas(preset, case):
    cfg_j, cfg = _cfg(preset)
    shape, box = CASES[case]
    jparams, tparams = _params(cfg, 20 + case)
    y, uv = _planes(shape, 20 + case)
    ty, tuv = torch.from_numpy(y), torch.from_numpy(uv)
    win = tpp.crop_window(torch.tensor(box), cfg.search_factor)
    got = emulate(tparams, ty, tuv, win, cfg)
    assert got.shape == (cfg.num_search_tokens, cfg.embed_dim)
    for mode in tfpe.MODES:
        plain = tfpe.nv12_search_tokens_reference(tparams, ty, tuv, win, cfg,
                                                  mode)
        err = (got - plain).abs().max().item()
        assert err <= PREP_F32_ATOL, (mode, err)
    jwin = jpp.crop_window(jnp.asarray(box, jnp.float32), cfg_j.search_factor)
    ref = np.asarray(jfpe.nv12_search_tokens(
        jparams, jnp.asarray(y), jnp.asarray(uv), jwin, cfg_j), np.float32)
    err = np.abs(got.numpy() - ref).max()
    assert err <= PREP_F32_ATOL, err
    # The planted fault: one TF32 product (hi.hi) in place of three.
    bad = emulate(tparams, ty, tuv, win, cfg, three=False)
    assert (bad - plain).abs().max().item() > PREP_F32_ATOL


@pytest.mark.parametrize("dim", [48, 64, 96, 200, 384, 1000])
def test_split_padded_planes(dim):
    # The operand cache's tf32x3 operands: the weight as its two planes
    # (2, K, W) and pos + bias (N, W), W the plan's width, hi and lo
    # split_tf32's, every column past D zero in both planes and in pos +
    # bias; made once per parameter set.
    cfg = dataclasses.replace(PRESETS["small"], embed_dim=dim,
                              num_heads=1)
    _, tparams = _params(cfg, dim)
    chosen = tfpe.plan(dim, F32)
    planes, pos_bias = tfpe.embed_operands(tparams, F32)
    assert tfpe.embed_operands(tparams, F32) == (planes, pos_bias)
    assert tfpe.embed_operands(tparams, F32)[0] is planes
    k, w = cfg.patch_size ** 2 * 3, chosen.width
    assert planes.shape == (2, k, w) and pos_bias.shape == (
        cfg.num_search_tokens, w)
    assert w >= dim and w % chosen.cols == 0
    assert not planes[..., dim:].any() and not pos_bias[..., dim:].any()
    pe = tparams["backbone"]["patch_embed"]
    hi, lo = vit_block.split_tf32(pe["kernel"])
    assert torch.equal(planes[0, :, :dim], hi)
    assert torch.equal(planes[1, :, :dim], lo)
    assert torch.equal(pos_bias[:, :dim],
                       tparams["backbone"]["pos_embed_x"] + pe["bias"])
    # simt by name reads the weight as one plane, padded to a multiple of 4.
    one, _ = tfpe.embed_operands(tparams, F32, tfpe.plan(dim, F32, "simt"))
    assert one.shape == (k, -(-dim // 4) * 4)
    assert torch.equal(one[:, :dim], pe["kernel"])


def test_profile_builds_rewrite_the_shipped_source(tmp_path, monkeypatch):
    # profile_prep.py times builds of csrc/fused_prep_embed.cu rewritten in
    # a copy: each rewrite finds its statement in the shipped source and
    # makes another source; a source that lacks one raises.
    from gstreamer_vit_tracker_tpu_torch import profile_prep

    srcs = profile_prep.sources()
    assert set(srcs) == {"shipped", "no pixels", "no product", "neither",
                         "3 stages", "4 stages", "512 threads",
                         "2 CTAs an SM"}
    assert len(set(srcs.values())) == len(srcs)
    for name in ("no pixels", "neither"):
        assert "make_pixels<bf16>(" not in srcs[name]
        assert "n0, kTileTokens, n_tok" not in srcs[name]
    assert srcs["no product"].count("c = chunks;") == 2
    (tmp_path / "fused_prep_embed.cu").write_text(
        srcs["shipped"].replace(profile_prep._TF32_LOOP, ""))
    monkeypatch.setattr(profile_prep.cuda_build, "CSRC", str(tmp_path))
    with pytest.raises(RuntimeError, match="no longer has"):
        profile_prep.sources()
