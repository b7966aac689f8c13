"""PyTorch port: kernels 1 and 2 at the widths past the resident LayerNorm
products (ViT-L's D 1024 and ViT-H's D 1280, 16 heads) and kernel 5 above
D 1024, against the JAX package on the CPU.

On the card these widths run the prenormed form of the LN products in
both dtypes (the LN rows written once, then every product through a TMA
ring; float32's on split-TF32 ``wgmma``, ``csrc/ring_tf32.cuh``), the
float32 streamed form by name only (``ops/vit_block.py::plan``,
``Plan.ln``); on the CPU each wrapper is its
plain twin, which these tests hold to JAX at small sizes: template 32,
search 64, patch 16 (20 tokens), depth 1, seeded weights (numpy, carried
to the port by ``models/weights.py::params_from_flat``).

* The port's ``encoder`` (and at D 1024 ``block``) against JAX's
  ``vit_block.encoder`` (and ``block``; Pallas, interpret mode) and
  ``encoder_reference``: bf16
  within 0.05 (``tests/test_torch_small_bf16.py``'s tolerance for the same
  check), float32 within 1e-3 absolute (``tests/test_torch_encoder_tf32.py``'s
  ``F32_ATOL``).
* ``core.update`` step by step, each port step from JAX's state before it:
  float32 within 1e-2 px / 1e-4 (``tests/test_torch_tracker.py``), bf16
  within 1 px / 0.01 (``tests/test_torch_small_bf16.py``).
* ``plan`` at D 776 to 4096 in both dtypes, batch 1 and 16: no raise;
  bf16 ``mma`` prenormed at every width (all past 768), its ring's shared
  memory within the H100's 232,448 bytes at the tiles and warpgroups it
  picks; ``tf32x3``
  (never ``simt``) for every float32 width, prenormed at every one (all
  past 544), N tiles 128 where 128-row CTAs fill the card; the float32
  forms by width (resident up to 544, at any batch) and by name
  (``"streamed"``, and a named form that does not fit raises); kernel 5's
  plan at D 1280 and 2048.
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
from gstreamer_vit_tracker_tpu.ops import vit_block as jvb  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import vit_block  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.profile_encoder import nv12_clip  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core  # noqa: E402

CPU = torch.device("cpu")
BF16, F32 = torch.bfloat16, torch.float32
H100_SMS, H100_OPTIN = 132, 232448
BF16_TOL = 0.05                      # tests/test_torch_small_bf16.py
F32_ATOL = 1e-3                      # tests/test_torch_encoder_tf32.py
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


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("d", [1024, 1280])
def test_twin_matches_pallas_at_wide_widths(d, dtype):
    # ViT-L's and ViT-H's widths, 16 heads (head dims 64 and 80), 20
    # tokens: the port's encoder and block (the plain twins here) against
    # JAX's Pallas kernels in interpret mode and its encoder_reference.
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    blocks = _blocks(d, 1, seed=d)
    x = 2.0 * np.random.default_rng(d + 1).standard_normal(
        (2, 20, d)).astype(np.float32)
    jb = _tree(blocks, lambda a: jnp.asarray(a, jdt))
    tb = _tree(blocks, lambda a: torch.from_numpy(a).to(dtype))
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(dtype)
    refs = {"encoder": np.asarray(jvb.encoder(jx[:1], jb, 16), np.float32),
            "encoder_reference": np.asarray(
                jvb.encoder_reference(jx[:1], jb, 16), np.float32)}
    got = {"encoder": vit_block.encoder(tx[:1], tb, 16)}
    got["encoder_reference"] = got["encoder"]
    if d == 1024:             # kernel 2's width on the path (16 streams)
        refs["block"] = np.asarray(jvb.block(jx, jb[0], 16), np.float32)
        got["block"] = vit_block.block(tx, tb[0], 16)
    for name, ref in refs.items():
        out = got[name]
        assert out.dtype == dtype and tuple(out.shape) == ref.shape
        if dtype == BF16:
            np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=F32_ATOL,
                                       err_msg=name)


@pytest.fixture(scope="module")
def wide_model():
    """(JAX config, JAX params, port config, port params): ViT-L's width,
    heads and MLP at depth 1 on 32 / 64-pixel crops, seeded numpy weights
    (normal, 0.02, LN scales 1 and biases 0) on both sides, carried to the
    port by ``params_from_flat``."""
    spec = dict(SMALL, embed_dim=1024, depth=1, num_heads=16)
    cfg_j, cfg_t = JModelConfig(**spec), ModelConfig(**spec)
    rng = np.random.default_rng(20)

    def leaf(key, shape):
        if key.endswith("scale"):
            return np.ones(shape, np.float32)
        if key.endswith("bias"):
            return np.zeros(shape, np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_step_by_step_from_jax_state(wide_model, dtype):
    cfg_j, jparams, cfg_t, tparams = wide_model
    cfg_j = dataclasses.replace(cfg_j, dtype=dtype)
    cfg_t = dataclasses.replace(cfg_t, dtype=dtype)
    box_tol, score_tol = STEP_TOLS[dtype]
    frames, boxes = nv12_clip(3)
    bbox = list(boxes[0])
    jst = jcore.init(jparams, tuple(map(jnp.asarray, frames[0])),
                     jnp.asarray(bbox), cfg_j, frame_format="nv12")
    jupd = jax.jit(functools.partial(jcore.update, cfg=cfg_j,
                                     frame_format="nv12"))
    for i, f in enumerate(frames[1:]):
        tst = weights.state_from_numpy(jax.device_get(jst), cfg_t, device=CPU)
        jst, jb, jc = jupd(jparams, jst, tuple(map(jnp.asarray, f)))
        tst, tb, tc = core.update(tparams, tst, f, cfg_t, device=CPU,
                                  frame_format="nv12")
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                                   atol=box_tol, err_msg=f"bbox, step {i + 1}")
        assert abs(float(tc) - float(jc)) <= score_tol, (i + 1, tc, jc)
        assert int(tst.lost_frames) == int(jst.lost_frames)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("dim", [776, 832, 1024, 1152, 1280, 1536, 2048, 4096])
def test_plan_takes_every_wide_width(dim, dtype):
    # No raise at any of these widths.  bf16: mma prenormed at every one
    # (all past 768), the ring of every product within the H100's opt-in
    # shared memory at its N tile and the plan's warpgroups (two once
    # 128-row CTAs fill the card: batch 16).  float32: always tf32x3 (simt
    # by name only), the LN rows prenormed at every one (all past 544, where
    # the resident rows do not fit at every N tile), the ring of every
    # product within the opt-in shared memory, N tiles of 128 where 128-row
    # CTAs fill the card, else the streamed form's (16, 32 or 64).
    heads = 8 if dim == 776 else 13 if dim == 832 else 16
    for batch in (1, 16):
        got = vit_block.plan(batch, 320, dim, heads, 4 * dim, dtype, H100_SMS)
        width = got.width or dim
        if dtype == BF16:
            assert (got.variant, got.ln) == ("mma", "prenormed"), got
            assert all(vit_block.ln_smem_bytes("mma", "prenormed", width, t,
                                               got.warpgroups) <= H100_OPTIN
                       for t in got.tiles), got
            assert got.warpgroups == vit_block._ring_warpgroups(
                batch * 320, width, H100_SMS), got
            if dim == 1024:        # ViT-L: two at batch 16, one at batch 1
                assert got.warpgroups == (2 if batch == 16 else 1), got
            # N tiles of 128 with two warpgroups, 64 with one, each halved
            # until it divides its product's width.
            inner = heads * (got.pad or dim // heads)
            cols = (3 * inner, width, got.mlp or 4 * dim, width)
            assert got.tiles == tuple(
                vit_block._fit(128 if got.warpgroups == 2 else 64, n)
                for n in cols), got
            continue
        assert (got.variant, got.ln) == ("tf32x3", "prenormed"), got
        assert all(vit_block.ln_smem_bytes(got.variant, "prenormed", width, t,
                                           got.warpgroups) <= H100_OPTIN
                   for t in got.tiles), got
        wide = vit_block._ring_warpgroups(batch * 320, width, H100_SMS) == 2
        assert got.tiles == ((128,) * 4 if wide else vit_block._tiles(
            5 * batch, heads * (got.pad or dim // heads), width,
            got.mlp or 4 * dim, H100_SMS, True)), got
        if dim in (1024, 1280):    # ViT-L's and ViT-H's widths
            assert wide == (batch == 16), got
    # The rings do not grow with the width; the resident rows do.
    assert vit_block.ln_smem_bytes("tf32x3", "streamed", 1024, 64) == \
        vit_block.ln_smem_bytes("tf32x3", "streamed", 8192, 64)
    assert vit_block.ln_smem_bytes("mma", "prenormed", 1024, 128, 2) == \
        vit_block.ln_smem_bytes("mma", "prenormed", 8192, 128, 2) == 197728
    assert vit_block.ln_smem_bytes("mma", "resident", 1024, 64) == 263168
    assert vit_block.ln_smem_bytes("mma", "resident", 768, 64) == 197632


def test_float32_forms_by_width_and_by_name():
    # float32: the LN products' form from the residual width alone,
    # resident up to 544 (D 96, 192, 512 and 544 at batch 1 and 16) and
    # prenormed past it (576, ViT-L's 1024, ViT-H's 1280, Model A's 4 heads
    # of 256); the streamed form only by name, at the tiles the streamed
    # rule gives (never 128); a named form that does not fit raises.
    for batch in (1, 16):
        for dim, heads in ((96, 2), (192, 3), (512, 8), (544, 8), (576, 9),
                           (1024, 16), (1024, 4), (1280, 16)):
            got = vit_block.plan(batch, 320, dim, heads, 4 * dim, F32, H100_SMS)
            assert got.ln == ("resident" if dim <= 544 else "prenormed"), got
            named = vit_block.plan(batch, 320, dim, heads, 4 * dim, F32,
                                   H100_SMS, ln="streamed")
            assert named.ln == "streamed" and set(named.tiles) <= {16, 32, 64}
            assert named._replace(ln=got.ln, tiles=got.tiles) == got or \
                got.tiles == (128,) * 4, (got, named)
            ring = vit_block.plan(batch, 320, dim, heads, 4 * dim, F32,
                                  H100_SMS, ln="prenormed")
            assert ring.ln == "prenormed"
            if dim > 544:
                assert ring == got
    # ViT-L at batch 1: proj and mlp2 (N tile 32) deal K to two consumers,
    # as the streamed form's two warpgroups did; qkv and mlp1 do not.
    got = vit_block.plan(1, 320, 1024, 16, 4096, F32, H100_SMS)
    assert [vit_block._tf32_ring(t, got.warpgroups) for t in got.tiles] == [
        (1, 64, False), (2, 32, True), (1, 64, False), (2, 32, True)]
    assert vit_block._tf32_ring(128, 1) == (2, 128, False)
    with pytest.raises(ValueError, match="resident fits"):
        vit_block.plan(1, 320, 1024, 16, 4096, F32, H100_SMS, ln="resident")
    with pytest.raises(ValueError, match="prenormed fits"):
        vit_block.plan(16, 320, 1024, 16, 4096, F32, H100_SMS, 65536,
                       ln="prenormed")
    with pytest.raises(ValueError, match="takes the LN forms"):
        vit_block.plan(1, 320, 1024, 16, 4096, BF16, H100_SMS, ln="streamed")
    rule = vit_block.plan(16, 320, 1024, 16, 4096, F32, H100_SMS)
    assert vit_block._tile_refusal(rule) is None
    for bad in (rule._replace(tiles=(128, 64, 128, 128)),
                rule._replace(ln="streamed"),
                rule._replace(tiles=(96,) * 4)):
        assert vit_block._tile_refusal(bad) is not None, bad


@pytest.mark.parametrize("dim", [1280, 2048])
def test_kernel5_plans_above_1024(dim):
    # bf16: 64-column tiles in equal clusters of up to 8; float32: 32-column
    # tiles in clusters of at most 6; simt by name stops at 1024.
    for dtype, cols, most in ((BF16, 64, 8), (F32, 32, 6)):
        p = fpe.plan(dim, dtype)
        tiles = -(-dim // cols)
        clusters = -(-tiles // most)
        assert (p.variant, p.tokens, p.cols) == (
            "mma" if dtype == BF16 else "tf32x3", 16, cols)
        assert p.cluster == -(-tiles // clusters) <= most
        assert p.width == clusters * p.cluster * cols >= dim
    assert fpe.plan(1280, BF16) == fpe.Plan("mma", 16, 64, 7, 1344)
    assert fpe.plan(1280, F32) == fpe.Plan("tf32x3", 16, 32, 6, 1344)
    with pytest.raises(ValueError, match="simt takes"):
        fpe.plan(dim, F32, "simt")
