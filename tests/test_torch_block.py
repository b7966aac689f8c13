"""PyTorch port: ``ops/vit_block.py::block`` (TPU kernel 2's counterpart)
against the JAX package on the CPU.

JAX's ``vit_block.block`` runs the Pallas block kernel in interpret mode on
the CPU; on a CPU tensor the port's ``block`` is its plain twin
``block_reference``, which the CUDA kernel is held to on the card.  Same
seeded inputs and weights on both sides (rounded to bf16 on both sides for
the bf16 case).  Tolerances: 1e-5 in float32, 0.05 in bf16 (a bf16 ulp at
|x| ~ 4); gradients of ``sum(block(x) ** 2)`` for ``x`` and every leaf
against ``jax.grad`` through the JAX ``custom_vjp``: rtol 1e-4, atol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import vit_block as jvb  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit as tvit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention as tattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import vit_block as tvb  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _block(rng, d, hidden):
    def w(*shape, std=0.1):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return {
        "ln1": {"scale": 1.0 + w(d), "bias": w(d)},
        "ln2": {"scale": 1.0 + w(d), "bias": w(d)},
        "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5), "bias": w(3 * d)},
        "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d)},
        "mlp1": {"kernel": w(d, hidden, std=d ** -0.5), "bias": w(hidden)},
        "mlp2": {"kernel": w(hidden, d, std=hidden ** -0.5), "bias": w(d)},
    }


def _leaves(p, fn):
    return {mod: {f: fn(a) for f, a in fields.items()}
            for mod, fields in p.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,d,heads", [(1, 20, 32, 2), (3, 37, 64, 4),
                                         (2, 80, 64, 2)])
def test_block_matches_pallas_block(dtype, b, s, d, heads):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1000 * b + s + d + heads)
    p = _block(rng, d, 4 * d)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    ref = jvb.block(jnp.asarray(x, jdt), _leaves(p, lambda a: jnp.asarray(a, jdt)),
                    heads)                           # Pallas, interpret mode
    tp = _leaves(p, lambda a: torch.from_numpy(a).to(tdt))
    tx = torch.from_numpy(x).to(tdt)
    got = tvb.block(tx, tp, heads)
    assert got.dtype == tdt and got.shape == (b, s, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    # On a CPU tensor the wrapper is the twin, and so is _block(fused=True).
    twin = tvb.block_reference(tx, tp, heads)
    assert torch.equal(got, twin)
    assert torch.equal(tvit._block(tx, tp, heads, fused=True), twin)


def test_block_casts_float32_masters_at_use():
    """As the JAX wrapper casts the weights to ``x.dtype`` at use."""
    rng = np.random.default_rng(5)
    p = _block(rng, 32, 128)
    x = rng.standard_normal((1, 12, 32)).astype(np.float32)
    masters = _leaves(p, torch.from_numpy)
    cast = _leaves(p, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(tvb.block(tx, masters, 2), tvb.block(tx, cast, 2))
    ref = jvb.block(jnp.asarray(x, jnp.bfloat16),
                    _leaves(p, jnp.asarray), 2)
    np.testing.assert_allclose(tvb.block(tx, masters, 2).float().numpy(),
                               np.asarray(ref, np.float32), rtol=0.05,
                               atol=0.05)


def test_block_gradients_match_jax_grad():
    rng = np.random.default_rng(6)
    d, heads = 32, 2
    p = _block(rng, d, 4 * d)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)

    def jloss(xx, pp):
        return (jvb.block(xx, pp, heads) ** 2).sum()

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), _leaves(p, jnp.asarray))

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = _leaves(p, lambda a: torch.from_numpy(a).requires_grad_(True))
    flat = [tp[mod][f] for mod in sorted(tp) for f in sorted(tp[mod])]
    grads = torch.autograd.grad((tvb.block(tx, tp, heads) ** 2).sum(),
                                [tx, *flat])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    names = [(mod, f) for mod in sorted(tp) for f in sorted(tp[mod])]
    assert len(names) == 12
    for (mod, f), g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[mod][f]),
                                   rtol=1e-4, atol=1e-4, err_msg=f"{mod}/{f}")


def test_block_reference_is_plain_and_counts_nothing(monkeypatch):
    """The twin never reaches a kernel wrapper, and a CPU call leaves the
    launch counts alone."""
    def boom(*a, **k):
        raise AssertionError("the twin called a kernel wrapper")

    monkeypatch.setattr(tattn, "flash_attention", boom)
    monkeypatch.setattr(tvb, "_launch", boom)
    rng = np.random.default_rng(7)
    p = _leaves(_block(rng, 32, 128), torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))
    before = (tvb.LAUNCHES, tvb.BLOCK_LAUNCHES)
    out = tvb.block(x, p, 2)
    assert torch.isfinite(out).all()
    assert (tvb.LAUNCHES, tvb.BLOCK_LAUNCHES) == before
