"""PyTorch port: kernels 1-4 at head dims above 128 and kernel 5 at patches
above 32, against the JAX package on the CPU.

On the card a head dim above 128 runs the attention in panels of 64
columns (``csrc/attention.cu``'s panel kernels, ``attention_panels_kernel``
of ``csrc/encoder_mma.cuh`` and ``encoder_tf32.cuh``), and a patch above 32
walks kernel 5's K in pieces of patch rows (``ops/fused_prep_embed.py::
piece_rows``).  On the CPU each wrapper is its plain twin, which these tests
hold to JAX at small sizes (template 32, search 64, depth 1, one intra-op
thread), on seeded numpy inputs fed to both sides:

* the port's ``encoder`` and ``block`` against JAX's ``vit_block.encoder``
  and ``block`` (Pallas, interpret mode) at head dims 192 and 256 (D 384
  and 512, 2 heads): bf16 within 0.05, float32 within 1e-3
  (``tests/test_torch_wide_encoder.py``'s tolerances);
* ``flash_attention`` and ``multihead_attention`` against JAX's at head dims
  192 and 256, at S 320 (JAX's single-block kernel) and S 1040 (its blocked
  ``_flash_kernel``): float32 within 2e-5 (``tests/test_torch_attention.py``),
  bf16 within one output ulp at the largest value;
* ``nv12_search_tokens`` against JAX's at patch 48 and 64, both modes, both
  dtypes (``tests/test_torch_fused_prep.py``'s tolerances: 1e-4 float32,
  0.05 bf16);
* ``core.update`` step by step, each port step from JAX's state before it,
  for a head-dim-256 model and a patch-64 model (through
  ``fused_prep=True``), within ``tests/test_torch_wide_encoder.py``'s
  ``STEP_TOLS``.

And the card's plans, taken here: ``vit_block.plan`` and
``attention.plan`` at head dims 136 to 1024 and kernel 5's ``plan`` at
patches 40 to 128, in both dtypes, raise nothing, state their pad or
pieces and fit the H100's 232,448 bytes of shared memory a block.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import attention as jattn  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import fused_prep_embed as jfpe  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import preprocess as jpp  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import vit_block as jvb  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention as tattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as tfpe  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import vit_block  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.profile_encoder import nv12_clip  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core  # noqa: E402

CPU = torch.device("cpu")
BF16, F32 = torch.bfloat16, torch.float32
H100_SMS, H100_OPTIN = 132, 232448
BF16_TOL = 0.05                      # tests/test_torch_wide_encoder.py
F32_ATOL = 1e-3
ATT_F32_TOL = 2e-5                   # tests/test_torch_attention.py
PREP_TOLS = {"float32": 1e-4, "bfloat16": 0.05}   # tests/test_torch_fused_prep.py
STEP_TOLS = {"float32": (1e-2, 1e-4), "bfloat16": (1.0, 0.01)}   # px, score
SMALL = dict(template_size=32, search_size=64, patch_size=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(d, depth, seed):
    """``depth`` seeded blocks of width ``d`` (MLP 4 d) as float32 numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.1, base=0.0):
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    h = 4 * d
    return [{"ln1": {"scale": w(d, base=1.0), "bias": w(d)},
             "ln2": {"scale": w(d, base=1.0), "bias": w(d)},
             "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5), "bias": w(3 * d)},
             "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d)},
             "mlp1": {"kernel": w(d, h, std=d ** -0.5), "bias": w(h)},
             "mlp2": {"kernel": w(h, d, std=h ** -0.5), "bias": w(d)}}
            for _ in range(depth)]


def _tree(blocks, to):
    return [{m: {f: to(a) for f, a in leaves.items()}
             for m, leaves in p.items()} for p in blocks]


def _close(got, ref, dtype, tol_f32, what):
    got = got.float().numpy() if dtype == BF16 else got.numpy()
    if dtype == BF16:
        np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol_f32,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("dh", [192, 256])
def test_encoder_and_block_match_pallas_at_wide_heads(dh, dtype):
    # Two heads of 192 and 256 (D 384 and 512), 20 tokens: the port's
    # encoder and block (the plain twins here) against JAX's Pallas kernels
    # in interpret mode.
    d = 2 * dh
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    blocks = _blocks(d, 1, seed=dh)
    x = 2.0 * np.random.default_rng(dh + 1).standard_normal(
        (2, 20, d)).astype(np.float32)
    jb = _tree(blocks, lambda a: jnp.asarray(a, jdt))
    tb = _tree(blocks, lambda a: torch.from_numpy(a).to(dtype))
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(dtype)
    for name, got, ref in (
            ("encoder", vit_block.encoder(tx[:1], tb, 2),
             jvb.encoder(jx[:1], jb, 2)),
            ("block", vit_block.block(tx, tb[0], 2), jvb.block(jx, jb[0], 2))):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == dtype and tuple(got.shape) == ref.shape
        _close(got, ref, dtype, F32_ATOL, name)


def _qkv(b, s, d, seed):
    rng = np.random.default_rng(seed + 31 * s + d)
    return [rng.standard_normal((b, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("s", [320, 1040])
@pytest.mark.parametrize("dh", [192, 256])
def test_attention_matches_jax_kernels_at_wide_heads(dh, s):
    # S 320 takes JAX's single-block kernel, S 1040 (1152 padded) its
    # blocked _flash_kernel; float32 and (at S 320) bf16.
    q, k, v = _qkv(1, s, dh, seed=dh)
    ref = np.asarray(jattn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           interpret=True))
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=ATT_F32_TOL,
                               atol=ATT_F32_TOL)
    # Two heads of dh through multihead_attention, JAX's Pallas route.
    q2, k2, v2 = _qkv(1, s, 2 * dh, seed=dh + 7)
    ref = np.asarray(jattn.multihead_attention(
        *map(jnp.asarray, (q2, k2, v2)), 2, use_pallas=True))
    got = tattn.multihead_attention(*map(torch.from_numpy, (q2, k2, v2)), 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=ATT_F32_TOL,
                               atol=ATT_F32_TOL)
    if s == 320:
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        ref = np.asarray(jattn.flash_attention(jq, jk, jv, interpret=True),
                         np.float32)
        got = tattn.flash_attention(*(torch.from_numpy(a).to(BF16)
                                      for a in (q, k, v)))
        assert got.dtype == BF16
        assert np.abs(got.float().numpy() - ref).max() <= \
            2.0 ** -7 * np.abs(ref).max()


def _nv12(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2, 2), dtype=np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["loop", "transpose"])
@pytest.mark.parametrize("patch,search", [(48, 96), (64, 128)])
def test_nv12_tokens_match_pallas_at_wide_patches(patch, search, mode, dtype):
    # Four tokens of patch 48 and 64 (K 6,912 and 12,288), D 32, a window
    # over the frame's edge: the port's plain version against JAX's kernel
    # in interpret mode.
    kw = dict(template_size=patch, search_size=search, patch_size=patch,
              embed_dim=32, depth=1, num_heads=2, dtype=dtype)
    cfg_j, cfg_t = JModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(patch)
    k = patch * patch * 3
    host = {"patch_embed": {
        "kernel": (0.02 * rng.standard_normal((k, 32))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(32)).astype(np.float32)},
        "pos_embed_x": (0.1 * rng.standard_normal(
            (cfg_t.num_search_tokens, 32))).astype(np.float32)}
    jparams = {"backbone": jax.tree.map(jnp.asarray, host)}
    tparams = {"backbone": {
        "patch_embed": {f: torch.from_numpy(a)
                        for f, a in host["patch_embed"].items()},
        "pos_embed_x": torch.from_numpy(host["pos_embed_x"])}}
    y, uv = _nv12((120, 160), patch)
    box = [-10.0, 30.0, 50.0, 40.0]
    ref = jfpe.nv12_search_tokens(
        jparams, jnp.asarray(y), jnp.asarray(uv),
        jpp.crop_window(jnp.asarray(box, jnp.float32), cfg_j.search_factor),
        cfg_j, mode=mode)
    got = tfpe.nv12_search_tokens(
        tparams, torch.from_numpy(y), torch.from_numpy(uv),
        tpp.crop_window(torch.tensor(box), cfg_t.search_factor), cfg_t,
        mode=mode)
    assert got.dtype == (BF16 if dtype == "bfloat16" else F32)
    assert tuple(got.shape) == (cfg_t.num_search_tokens, 32)
    tol = PREP_TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _model(spec, seed, std):
    """(JAX config, JAX params, port config, port params) of ``spec`` on
    the flagship's ModelConfig, seeded numpy weights (normal ``std``, LN
    scales 1 and biases 0) on both sides, carried to the port by
    ``params_from_flat``."""
    cfg_j, cfg_t = JModelConfig(**spec), ModelConfig(**spec)
    rng = np.random.default_rng(seed)

    def leaf(key, shape):
        if key.endswith("scale"):
            return np.ones(shape, np.float32)
        if key.endswith("bias"):
            return np.zeros(shape, np.float32)
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def build(tree, key=""):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, key) for v in tree]
        return leaf(key, tree)

    tree = build(weights.param_shapes(cfg_t))
    return (cfg_j, jvittrack.with_grouped_head(jax.tree.map(jnp.asarray,
                                                             tree)),
            cfg_t, vittrack.with_grouped_head(weights.params_from_flat(
                jweights._flatten(tree), cfg_t, device=CPU)))


# A head dim of 256 (D 512, 2 heads) at the small crops, weights as
# tests/test_torch_wide_encoder.py draws them (std 0.02); patch 64 at the
# flagship's crops (4 template and 16 search tokens), narrow, its weights
# at std 0.1: at 0.02 its 4 x 4 score map is flat to 1e-6 (every cell
# 0.40916), so the argmax is a tie that any other rounding order of the
# same function flips by a 64-pixel cell, the port's fused and plain
# routes against each other included.
MODELS = {"dh256": (dict(SMALL, embed_dim=512, depth=1, num_heads=2), 0.02),
          "patch64": (dict(template_size=128, search_size=256, patch_size=64,
                           embed_dim=64, depth=1, num_heads=2), 0.1)}


@pytest.fixture(scope="module")
def models():
    return {name: _model(spec, seed, std)
            for seed, (name, (spec, std)) in enumerate(MODELS.items(), 21)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_update_step_by_step_from_jax_state(models, name, dtype):
    cfg_j, jparams, cfg_t, tparams = models[name]
    cfg_j = dataclasses.replace(cfg_j, dtype=dtype)
    cfg_t = dataclasses.replace(cfg_t, dtype=dtype)
    fused_prep = name == "patch64"        # kernel 5's route at patch 64
    box_tol, score_tol = STEP_TOLS[dtype]
    frames, boxes = nv12_clip(3)
    jst = jcore.init(jparams, tuple(map(jnp.asarray, frames[0])),
                     jnp.asarray(list(boxes[0])), cfg_j, frame_format="nv12")
    jupd = jax.jit(functools.partial(jcore.update, cfg=cfg_j,
                                     frame_format="nv12",
                                     fused_prep=fused_prep))
    for i, f in enumerate(frames[1:]):
        tst = weights.state_from_numpy(jax.device_get(jst), cfg_t, device=CPU)
        jst, jb, jc = jupd(jparams, jst, tuple(map(jnp.asarray, f)))
        tst, tb, tc = core.update(tparams, tst, f, cfg_t, device=CPU,
                                  frame_format="nv12", fused_prep=fused_prep)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                                   atol=box_tol, err_msg=f"bbox, step {i + 1}")
        assert abs(float(tc) - float(jc)) <= score_tol, (i + 1, tc, jc)
        assert int(tst.lost_frames) == int(jst.lost_frames)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("dh", [136, 192, 256, 320, 512, 1024])
def test_plans_take_every_wide_head_dim(dh, dtype):
    # The encoder and attention plans of a head dim above 128: no raise,
    # bf16's mma padded to a whole 64-column panel, float32's tf32x3 to a
    # multiple of 8 (none of these), every CTA within the H100's opt-in.
    pad = {BF16: -(-dh // 64) * 64, F32: dh}[dtype]
    for heads, batch in ((2, 1), (1, 16)):
        d = heads * dh
        got = vit_block.plan(batch, 320, d, heads, 4 * d, dtype, H100_SMS)
        assert got.variant == ("mma" if dtype == BF16 else "tf32x3"), got
        assert (got.pad or dh) == pad, got
        width = got.width or d
        # One warpgroup a CTA (tf32x3 splits head dims up to 64 alone), but
        # in the bf16 prenormed products: two once 128-row CTAs fill the
        # card.
        assert got.warpgroups == (
            vit_block._ring_warpgroups(batch * 320, width, H100_SMS)
            if got.ln == "prenormed" else 1), got
        products = got.tiles if got.ln == "prenormed" else (got.tiles[0],
                                                            got.tiles[2])
        assert max(vit_block.ln_smem_bytes(got.variant, got.ln, width, t,
                                           got.warpgroups)
                   for t in products) <= H100_OPTIN
        assert vit_block.attention_smem_bytes(got.variant, pad) <= H100_OPTIN
    for s in (20, 320, 1040):
        got = tattn.plan(s, dh, dtype, H100_OPTIN, bh=4)
        assert got.variant == ("mma" if dtype == BF16 else "tf32x3"), got
        assert (got.pad or dh) == pad == tattn.entry_head_dims(dh, got)[0]
        assert tattn.entry_head_dims(dh, got)[1] == dh
        assert (got.kb, got.warpgroups) == (64, 1), got
        need = tattn.smem_bytes(got.route, got.variant, s, pad,
                                2 if dtype == BF16 else 4, got.kb, got.stages,
                                got.warpgroups, got.group)
        if dtype == F32:
            # The float32 panel kernel (csrc/panel_tf32.cuh): G panels of o a
            # CTA, q resident up to dh 512, one CTA an SM.
            assert got.group >= 1 and -(-dh // 64) % got.group == 0, got
            assert need <= H100_OPTIN, got
            assert tattn._refusal(got, s, pad, H100_OPTIN) is None
        else:
            # The panel kernel (csrc/panel_ring.cuh): G panels of o a CTA, q
            # resident, a ring of panel stages; single while its CTA fits
            # two an SM or the grid is no larger than the card.
            assert got.group >= 1 and (pad // 64) % got.group == 0, got
            assert need <= H100_OPTIN, got
            assert tattn._refusal(got, s, pad, H100_OPTIN) is None
    # float32 streams q through the ring above dh 512 (16 panels: seven
    # stages of 32 KB fill the card); bf16's q panels stay, beside a ring of
    # at most two key blocks' loads.
    assert tattn.smem_bytes("flash", "tf32x3", 320, 1024, 4, 64, 7, 1, 4) \
        == vit_block.attention_smem_bytes("tf32x3", 1024, 1, 4) \
        == 1024 + 7 * 32768 + 8 * (1 + 2 * 7) == 230520
    assert tattn.smem_bytes("flash", "mma", 4096, 1024, 2, 64, 12, 1, 4) \
        == vit_block.attention_smem_bytes("mma", 1024, 1, 2) \
        == 1024 + (16 + 12) * 8192 + 8 * (1 + 2 * 12) == 230600


# The bf16 panel attention's plans at Model A's head dim (256, 4 heads),
# dh 192 and 136 (4 heads, 136 padded to 192) and ModelConfig(num_heads=1)'s
# 1024, at batch 1 and 16 on an H100 (132 SMs, 232,448 bytes a block; G the
# cheapest count of panel products on the slowest SM, attention.panel_group):
# kernels 3/4 at S 320 and 100 on (batch x heads, S, dh) as the per-block
# route hands them over, and kernel 1/2's attention stage at S 320.  Each
# row: (route, G, ring stages, grid, shared-memory bytes).  The bytes are
# 1024 + (P + R) x 8192 + 8 (1 + 2 R), P = dh / 64 q panels and R ring
# stages (single: every load of the walk, blocks x (P + G)).
PANEL_PLANS = {
    (136, 1): {320: ("single", 1, 0, 60, 189768),
               100: ("single", 1, 0, 24, 91272),
               "encoder": (1, 8, 60, 91272)},
    (136, 16): {320: ("flash", 3, 10, 320, 107688),
                100: ("single", 3, 0, 128, 124104),
                "encoder": (3, 10, 320, 107688)},
    (192, 1): {320: ("single", 1, 0, 60, 189768),
               100: ("single", 1, 0, 24, 91272),
               "encoder": (1, 8, 60, 91272)},
    (192, 16): {320: ("flash", 3, 10, 320, 107688),
                100: ("single", 3, 0, 128, 124104),
                "encoder": (3, 10, 320, 107688)},
    (256, 1): {320: ("flash", 1, 9, 80, 107672),
               100: ("single", 1, 0, 32, 115880),
               "encoder": (1, 9, 80, 107672)},
    (256, 16): {320: ("flash", 4, 9, 320, 107672),
                100: ("flash", 2, 9, 256, 107672),
                "encoder": (2, 9, 640, 107672)},
    (1024, 1): {320: ("flash", 1, 12, 80, 230600),
                100: ("flash", 1, 12, 32, 230600),
                "encoder": (1, 12, 80, 230600)},
    (1024, 16): {320: ("flash", 4, 12, 320, 230600),
                 100: ("flash", 4, 12, 128, 230600),
                 "encoder": (2, 12, 640, 230600)},
}


def _panel_bytes(panels, stages):
    return 1024 + (panels + stages) * 8192 + 8 * (1 + 2 * stages)


@pytest.mark.parametrize("dh,batch", sorted(PANEL_PLANS))
def test_panel_plans_give_group_grid_and_bytes(dh, batch):
    heads = 1 if dh == 1024 else 4
    run = -(-dh // 64) * 64
    panels = run // 64
    for s in (320, 100):
        route, group, stages, grid, nbytes = PANEL_PLANS[dh, batch][s]
        got = tattn.plan(s, dh, BF16, H100_OPTIN, batch * heads, H100_SMS)
        assert (got.route, got.group, got.stages) == (route, group, stages)
        assert (got.pad or dh) == run
        assert -(-s // 64) * batch * heads * (panels // got.group) == grid
        ring = -(-s // 64) * (panels + group) if route == "single" else stages
        assert tattn.smem_bytes(route, "mma", s, run, 2, 64, stages, 1,
                                group) == _panel_bytes(panels, ring) == nbytes
        assert nbytes <= H100_OPTIN
        # Two CTAs an SM where the flash ring fits them.
        if route == "flash" and panels <= 4:
            assert 2 * (nbytes + 1024) <= 233472
    group, stages, grid, nbytes = PANEL_PLANS[dh, batch]["encoder"]
    d = heads * dh
    got = vit_block.plan(batch, 320, d, heads, 4 * d, BF16, H100_SMS)
    assert got.group == group and vit_block.group_refusal(
        "mma", run, got.group) is None
    assert tattn.panel_stages(panels, group, H100_OPTIN) == stages
    assert 5 * batch * heads * (panels // group) == grid
    assert vit_block.attention_smem_bytes("mma", run, 1, group) \
        == _panel_bytes(panels, stages) == nbytes <= H100_OPTIN


# The float32 panel attention's plans (csrc/panel_tf32.cuh, one CTA an SM,
# G by the same count with one pass) at dh 136, 192 and 256 (4 heads), at
# batch 1 and 16, on (batch x heads, S, dh) at S 320 and 64, and kernel
# 1/2's attention stage at S 320.  Each row: (route, G, ring stages, grid,
# shared-memory bytes).  The bytes are 1024 + P x 16384 + R x 32768 + 8 (1
# + 2 R): slack to a 1024-byte boundary, P = ceil(dh / 64) resident q panels
# and R ring stages (single: every load of the walk, blocks x (P + G)).
TF32_PANEL_PLANS = {
    (136, 1): {320: ("flash", 1, 5, 60, 214104),
               64: ("single", 1, 0, 12, 181320),
               "encoder": (1, 5, 60, 214104)},
    (136, 16): {320: ("flash", 3, 5, 320, 214104),
                64: ("flash", 3, 5, 64, 214104),
                "encoder": (3, 5, 320, 214104)},
    (192, 1): {320: ("flash", 1, 5, 60, 214104),
               64: ("single", 1, 0, 12, 181320),
               "encoder": (1, 5, 60, 214104)},
    (192, 16): {320: ("flash", 3, 5, 320, 214104),
                64: ("flash", 3, 5, 64, 214104),
                "encoder": (3, 5, 320, 214104)},
    (256, 1): {320: ("flash", 1, 5, 80, 230488),
               64: ("single", 1, 0, 16, 230488),
               "encoder": (1, 5, 80, 230488)},
    (256, 16): {320: ("flash", 4, 5, 320, 230488),
                64: ("flash", 2, 5, 128, 230488),
                "encoder": (4, 5, 320, 230488)},
}


def _tf32_panel_bytes(panels, stages):
    return 1024 + panels * 16384 + stages * 32768 + 8 * (1 + 2 * stages)


@pytest.mark.parametrize("dh,batch", sorted(TF32_PANEL_PLANS))
def test_tf32_panel_plans_give_group_grid_and_bytes(dh, batch):
    heads, panels = 4, -(-dh // 64)
    for s in (320, 64):
        route, group, stages, grid, nbytes = TF32_PANEL_PLANS[dh, batch][s]
        got = tattn.plan(s, dh, F32, H100_OPTIN, batch * heads, H100_SMS)
        assert (got.route, got.variant, got.group, got.stages, got.pad) == (
            route, "tf32x3", group, stages, 0)
        assert -(-s // 64) * batch * heads * (panels // got.group) == grid
        ring = -(-s // 64) * (panels + group) if route == "single" else stages
        assert tattn.smem_bytes(route, "tf32x3", s, dh, 4, 64, stages, 1,
                                group) == _tf32_panel_bytes(panels, ring) \
            == nbytes
        assert tattn._refusal(got, s, dh, H100_OPTIN) is None
        # One CTA an SM: two never fit beside q.
        assert 2 * (nbytes + 1024) > 233472 and nbytes <= H100_OPTIN
    group, stages, grid, nbytes = TF32_PANEL_PLANS[dh, batch]["encoder"]
    d = heads * dh
    got = vit_block.plan(batch, 320, d, heads, 4 * d, F32, H100_SMS)
    assert got.group == group and vit_block.group_refusal(
        "tf32x3", dh, got.group) is None
    assert tattn.tf32_panel_stages(panels, group, H100_OPTIN) == stages
    assert 5 * batch * heads * (panels // group) == grid
    assert vit_block.attention_smem_bytes("tf32x3", dh, 1, group) \
        == _tf32_panel_bytes(panels, stages) == nbytes


@pytest.mark.parametrize("panels,group,stages", [
    (3, 1, 5), (3, 3, 5), (4, 4, 5), (8, 2, 3), (9, 1, 7), (16, 4, 7)])
def test_tf32_panel_rings_fill_the_card(panels, group, stages):
    # As many 32 KB stages as the card holds beside q (resident up to 8
    # panels, through the ring above), up to two key blocks' loads.
    got = tattn.tf32_panel_stages(panels, group, H100_OPTIN)
    assert got == stages
    assert tattn.tf32_panel_smem_bytes(panels, got) <= H100_OPTIN \
        < tattn.tf32_panel_smem_bytes(panels, got + 1) \
        or got == 2 * tattn.tf32_panel_loads(panels, group)


def _source_constant(name, source="panel_ring.cuh"):
    import re
    from gstreamer_vit_tracker_tpu_torch.ops import cuda_build

    with open(f"{cuda_build.CSRC}/{source}") as f:
        return int(re.search(rf"{name} = (\d+);", f.read()).group(1))


@pytest.mark.parametrize("name,value", [
    ("kTwoCtaBytes", tattn._TWO_CTA_BYTES), ("kAlign", tattn._MMA_ALIGN),
    ("kKeys", tattn._TF32_KEYS), ("kCols", tattn._PANEL)])
def test_panel_plan_constants_are_the_sources(name, value):
    # What the plans mirror (the C entries attention_smem and
    # attention_ring_stages, checked against them on the card by
    # chip_smoke.py) rests on these constants of csrc/panel_ring.cuh.
    assert _source_constant(name) == value


@pytest.mark.parametrize("name,value", [
    ("kStageBytes", tattn._TF32_STAGE_BYTES),
    ("kQPanelBytes", tattn._TF32_QPANEL_BYTES),
    ("kMaxGroup", tattn._TF32_MAX_GROUP),
    ("kMaxResidentPanels", tattn._TF32_MAX_RESIDENT),
    ("kKeys", tattn._TF32_KEYS), ("kCols", tattn._PANEL),
    ("kRows", tattn._TF32_ROWS)])
def test_tf32_panel_plan_constants_are_the_sources(name, value):
    # The float32 panel plans (attention_smem, attention_tf32_ring_stages
    # on the card) rest on these constants of csrc/panel_tf32.cuh.
    assert _source_constant(name, "panel_tf32.cuh") == value


def test_tf32_panel_profile_cuts_find_their_statements():
    # profile_attention.py's cut builds rewrite statements of
    # csrc/panel_tf32.cuh in a copy; each must stand there once (the builds
    # raise on the card otherwise).
    from gstreamer_vit_tracker_tpu_torch import profile_attention as pa

    with open(f"{pa.cuda_build.CSRC}/panel_tf32.cuh") as f:
        src = f.read()
    for edits in pa._CUT.values():
        for old, _ in edits:
            assert src.count(old) == 1, old


@pytest.mark.parametrize("plan_,s,dh", [
    (tattn.Plan("flash", "mma", 64, 9, 1, 0, 3), 320, 256),    # 3 of 4 panels
    (tattn.Plan("flash", "mma", 64, 9, 1, 0, 5), 320, 320),    # G above 4
    (tattn.Plan("flash", "mma", 64, 4, 1, 0, 4), 320, 256),    # ring <= G
    (tattn.Plan("flash", "mma", 64, 5, 1, 0, 2), 320, 256),    # < P + G built
    (tattn.Plan("flash", "mma", 64, 0, 1, 0, 0), 320, 256),    # no group
    (tattn.Plan("single", "mma", 64, 0, 1, 0, 1), 1040, 256),  # too large
    (tattn.Plan("flash", "mma", 64, 16, 1, 0, 4), 320, 1024),  # too large
    (tattn.Plan("flash", "mma", 64, 2, 1, 0, 1), 320, 128),    # group <= 128
    (tattn.Plan("flash", "tf32x3", 64, 5, 1, 0, 3), 320, 256),  # 3 of 4 panels
    (tattn.Plan("flash", "tf32x3", 64, 5, 1, 0, 5), 320, 320),  # G above 4
    (tattn.Plan("flash", "tf32x3", 64, 1, 1, 0, 4), 320, 256),  # one stage
    (tattn.Plan("flash", "tf32x3", 64, 5, 1, 0, 0), 320, 256),  # no group
    (tattn.Plan("single", "tf32x3", 64, 0, 1, 0, 2), 320, 256),  # too large
    (tattn.Plan("flash", "tf32x3", 64, 6, 1, 0, 4), 320, 256),  # too large
    (tattn.Plan("flash", "tf32x3", 64, 2, 1, 0, 1), 320, 128),  # group <= 128
])
def test_panel_plans_the_design_does_not_take_raise(plan_, s, dh):
    assert tattn._refusal(plan_, s, dh, H100_OPTIN) is not None


@pytest.mark.parametrize("variant,dh,group", [
    ("mma", 256, 4), ("mma", 256, 3), ("mma", 192, 2), ("mma", 256, 0),
    ("mma", 128, 1), ("tf32x3", 256, 3), ("tf32x3", 320, 5),
    ("tf32x3", 256, 0), ("tf32x3", 128, 1)])
def test_encoder_panel_groups_the_design_does_not_take_raise(variant, dh,
                                                             group):
    assert vit_block.group_refusal(variant, dh, group) is not None


def test_head_dims_pad_to_whole_panels_in_bf16():
    # bf16 above 128: the next multiple of 64; float32: of 8; simt keeps
    # its limit of 128 (by name only).
    assert [tattn.padded_head_dim(d, BF16) for d in (129, 136, 192, 200, 256)] \
        == [192, 192, 0, 256, 0]
    assert [tattn.padded_head_dim(d, F32) for d in (129, 136, 192, 250)] \
        == [136, 0, 0, 256]
    assert [vit_block.head_pad("mma", d) for d in (129, 136, 192, 200, 256)] \
        == [192, 192, 0, 256, 0]
    assert [vit_block.head_pad("tf32x3", d) for d in (129, 136, 250)] \
        == [136, 0, 256]
    assert vit_block._refusal("simt", 272, 2, 1088) is not None
    assert vit_block._refusal("mma", 272, 2, 1088) is None
    assert vit_block._refusal("tf32x3", 2048, 2, 8192) is None


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("patch", [40, 48, 64, 128])
def test_kernel5_plans_at_wide_patches(patch, dtype):
    # Above patch 32 the kernel walks K in pieces of patch rows: at most
    # 1,536 bf16 / 768 float32 pixels a token, two A tiles of 48 KB at
    # most; every embed width fits the H100's opt-in.
    budget = 1536 if dtype == BF16 else 768
    for dim in (32, 192, 768, 1280):
        p = tfpe.plan(dim, dtype)
        rows = tfpe.piece_rows(patch, p.variant)
        assert rows == max(1, budget // (3 * patch)) < patch
        assert rows * patch * 3 <= budget
        assert tfpe.smem_bytes(p, patch) <= H100_OPTIN, (p, patch)
    # A patch up to 32 is one piece, as before; simt keeps its 48 KB.
    assert tfpe.piece_rows(32, tfpe.plan(192, dtype).variant) == 32
    assert tfpe.piece_rows(patch, "simt") == patch
    if patch >= 48:
        assert tfpe.smem_bytes(tfpe.plan(192, F32, "simt"), patch) > 48 * 1024
