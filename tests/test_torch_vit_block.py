"""PyTorch port: the encoder kernel's plain twin, the ViT backbone and the
attention reference against the JAX package.

JAX's ``vit_block.encoder`` runs the Pallas whole-encoder kernel in
interpret mode on the CPU; the port's ``encoder_reference`` is the plain
twin its CUDA kernel is held to on the card.  Same seeded inputs and
weights on both sides (rounded to bf16 on both sides for the bf16 cases);
tolerances 1e-5 in float32 and 0.05 in bf16 (a bf16 ulp at |x| ~ 4).

At the flagship's full depth (the shipped ``vittrack-t`` weights, 12
blocks, 320 seeded tokens) the two ``encoder_reference`` s are held to 1e-4
of max|x| in float32: the math is the same.  In bf16 their distance before
and after the final LN is printed (the two place their roundings
differently); run with ``-s`` to read it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vit as jvit  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import attention as jattn  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import vit_block as jvb  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit as tvit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention as tattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import vit_block as tvb  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _blocks(rng, d, depth, hidden):
    def w(*shape, std=0.1):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return [{
        "ln1": {"scale": 1.0 + w(d), "bias": w(d)},
        "ln2": {"scale": 1.0 + w(d), "bias": w(d)},
        "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5), "bias": w(3 * d)},
        "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d)},
        "mlp1": {"kernel": w(d, hidden, std=d ** -0.5), "bias": w(hidden)},
        "mlp2": {"kernel": w(hidden, d, std=hidden ** -0.5), "bias": w(d)},
    } for _ in range(depth)]


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _both(tree, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return (_tree(tree, lambda a: jnp.asarray(a, jdt)),
            _tree(tree, lambda a: torch.from_numpy(a).to(tdt)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d,heads,s", [(32, 2, 20), (64, 2, 37), (64, 4, 37)])
def test_encoder_twin_matches_pallas_encoder(dtype, d, heads, s):
    rng = np.random.default_rng(d * 100 + s + heads)
    blocks = _blocks(rng, d, depth=2, hidden=4 * d)
    x = rng.standard_normal((1, s, d)).astype(np.float32)
    jblocks, tblocks = _both(blocks, dtype)
    jx, tx = _both(x, dtype)
    ref = jvb.encoder(jx, jblocks, heads)          # Pallas, interpret mode
    got = tvb.encoder_reference(tx, tblocks, heads)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (1, s, d)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    # On a CPU tensor the wrapper is the twin, nothing else.
    np.testing.assert_array_equal(tvb.encoder(tx, tblocks, heads).float().numpy(),
                                  got.float().numpy())


def test_encoder_twin_batched_matches_chained_blocks():
    rng = np.random.default_rng(3)
    blocks = _blocks(rng, 32, depth=3, hidden=128)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    jblocks, tblocks = _both(blocks, "float32")
    ref = jvb.encoder_reference(jnp.asarray(x), jblocks, 2)
    got = tvb.encoder_reference(torch.from_numpy(x), tblocks, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_encoder_twin_matches_jax_at_flagship_depth():
    cfg = ModelConfig()
    bb = tweights.load_npz(tweights.checkpoint_path("vittrack-t"), cfg,
                           device="cpu")["backbone"]
    host = _tree({"blocks": bb["blocks"], "norm": bb["norm"]},
                 lambda t: t.numpy())
    assert len(host["blocks"]) == 12
    x = np.random.default_rng(12).standard_normal(
        (1, 320, cfg.embed_dim)).astype(np.float32)
    heads = cfg.num_heads
    for dtype in ("float32", "bfloat16"):
        (jblocks, jnorm), (tblocks, tnorm) = [
            (b["blocks"], b["norm"]) for b in _both(host, dtype)]
        jx, tx = _both(x, dtype)
        ref = jvb.encoder_reference(jx, jblocks, heads)
        got = tvb.encoder_reference(tx, tblocks, heads)
        ref_ln = jvit.layer_norm(ref, jnorm)
        got_ln = tvit.layer_norm(got, tnorm)
        d = np.abs(got.float().numpy() - np.asarray(ref, np.float32))
        d_ln = np.abs(got_ln.float().numpy() - np.asarray(ref_ln, np.float32))
        top = float(np.abs(np.asarray(ref, np.float32)).max())
        print(f"flagship depth 12, {dtype}: port twin vs JAX encoder_reference "
              f"max|d| {d.max():.6g} (mean {d.mean():.3g}, max|x| {top:.4g}, "
              f"{100 * d.max() / top:.3g} %); after the final LN max|d| "
              f"{d_ln.max():.6g} (mean {d_ln.mean():.3g})")
        if dtype == "float32":
            assert d.max() <= 1e-4 * top, (d.max(), top)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_matches_jax(dtype):
    cfg_kw = dict(template_size=32, search_size=64, patch_size=16,
                  embed_dim=64, depth=2, num_heads=2, dtype=dtype)
    jcfg, tcfg = JaxModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jparams = jvit.init_vit_params(jax.random.PRNGKey(6), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    tparams = _tree(host, torch.tensor)
    rng = np.random.default_rng(8)
    z = rng.standard_normal((1, jcfg.num_template_tokens, 64)).astype(np.float32)
    x = rng.standard_normal((1, jcfg.num_search_tokens, 64)).astype(np.float32)
    ref = jvit.encode(jparams, jnp.asarray(z), jnp.asarray(x), jcfg)
    got = tvit.encode(tparams, torch.from_numpy(z), torch.from_numpy(x), tcfg)
    assert got.shape == (1, jcfg.num_search_tokens, 64)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_embed_matches_jax(dtype):
    cfg_kw = dict(template_size=32, search_size=64, patch_size=16,
                  embed_dim=64, depth=0, num_heads=2, dtype=dtype)
    jcfg, tcfg = JaxModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    host = jax.tree.map(np.asarray,
                        jvit.init_vit_params(jax.random.PRNGKey(2), jcfg))
    jparams = jax.tree.map(jnp.asarray, host)
    tparams = _tree(host, torch.tensor)
    rng = np.random.default_rng(5)
    zi = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    xi = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    tol = DTYPES[dtype][2]
    for jfn, tfn, img in ((jvit.embed_template, tvit.embed_template, zi),
                          (jvit.embed_search, tvit.embed_search, xi)):
        ref = jfn(jparams, jnp.asarray(img), jcfg)
        got = tfn(tparams, torch.from_numpy(img), tcfg)
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("seq_len", [None, 29])
def test_attention_reference_matches_jax(seq_len):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 3, 37, 16)).astype(np.float32)
               for _ in range(3))
    ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), seq_len=seq_len)
    got = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), seq_len=seq_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_multihead_attention_matches_jax():
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((2, 37, 48)).astype(np.float32)
               for _ in range(3))
    ref = jattn.multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 3, use_pallas=False)
    got = tattn.multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_layer_norm_eps_and_gelu_are_jax_defaults():
    rng = np.random.default_rng(13)
    x = (1e-3 * rng.standard_normal((4, 32))).astype(np.float32)
    p = {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}
    ref = jvit.layer_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    got = tvit.layer_norm(torch.from_numpy(x), _tree(p, torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    g = rng.standard_normal(64).astype(np.float32) * 3
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(g), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(g))), rtol=1e-6, atol=1e-6)
