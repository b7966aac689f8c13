"""PyTorch port: ``ops/attention.py`` against the JAX package.

The plain version ``attention_reference`` (what the CUDA attention kernels
are held to on the card, what their backward differentiates, and what
every CPU run computes) against JAX's ``attention_reference`` and against
JAX's Pallas ``flash_attention`` in interpret mode, at the shapes of
``tests/test_attention.py``: the single-block range, the blocked range
(S > 1024), and lengths whose padding to the 128 grid needs the tail mask.
Same inputs on both sides, made with numpy from a seed.

Tolerances: float32 2e-5 (JAX's own kernel-vs-reference tolerance; the
sums run in another order); bf16 inputs 2^-8 of the largest value (one
output ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import attention as jattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention as tattn  # noqa: E402

SHAPES = [(2, 128, 64), (1, 320, 64), (3, 200, 32), (1, 1200, 32)]


def _qkv(b, s, d, seed=0, v_scale=1.0):
    rng = np.random.default_rng(seed + 31 * s + d)
    q, k, v = (rng.standard_normal((b, s, d)).astype(np.float32)
               for _ in range(3))
    return q, k, v_scale * v


@pytest.mark.parametrize("b,s,d", SHAPES)
def test_reference_matches_jax_reference(b, s, d):
    q, k, v = _qkv(b, s, d)
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)))
    got = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,s,d", SHAPES)
def test_reference_matches_jax_pallas_kernels(b, s, d):
    # (1, 1200, 32) takes JAX's blocked kernel, the others its single-block
    # kernel; 320, 200 and 1200 are padded and tail-masked inside it.
    q, k, v = _qkv(b, s, d, seed=1)
    ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # On CPU tensors the kernels' entry is the plain version, nothing else.
    np.testing.assert_array_equal(
        tattn.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        got.numpy())


def test_large_values_match_jax_kernel():
    # As tests/test_attention.py::test_flash_padding_does_not_leak: v scaled
    # by 100 shows a leaking tail at once.
    q, k, v = _qkv(1, 320, 64, seed=2, v_scale=100.0)
    ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-3)


@pytest.mark.parametrize("seq_len", [200, 64])
def test_reference_seq_len_masks_like_jax(seq_len):
    q, k, v = _qkv(2, 256, 32, seed=3)
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)),
                                    seq_len=seq_len)
    got = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                    seq_len=seq_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # Masked keys do not contribute: changing them changes nothing.
    k2, v2 = k.copy(), v.copy()
    k2[:, seq_len:] = 7.0
    v2[:, seq_len:] = -900.0
    again = tattn.attention_reference(*map(torch.from_numpy, (q, k2, v2)),
                                      seq_len=seq_len)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_reference_bf16_matches_jax():
    q, k, v = _qkv(3, 320, 64, seed=4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ref = np.asarray(jattn.attention_reference(jq, jk, jv), np.float32)
    got = tattn.attention_reference(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -8 * np.abs(ref).max()


@pytest.mark.parametrize("heads", [1, 3])
def test_multihead_plain_matches_jax(heads):
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((2, 37, 48)).astype(np.float32)
               for _ in range(3))
    ref = jattn.multihead_attention(*map(jnp.asarray, (q, k, v)), heads,
                                    use_pallas=False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn.multihead_attention(tq, tk, tv, heads, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # None on a CPU tensor is the plain version too.
    np.testing.assert_array_equal(
        tattn.multihead_attention(tq, tk, tv, heads).numpy(), got.numpy())


def test_multihead_matches_jax_pallas_route():
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((1, 64, 96)).astype(np.float32)
               for _ in range(3))
    ref = jattn.multihead_attention(*map(jnp.asarray, (q, k, v)), 3,
                                    use_pallas=True)
    got = tattn.multihead_attention(*map(torch.from_numpy, (q, k, v)), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_use_kernel_true_on_cpu_raises():
    q = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="use_kernel=True"):
        tattn.multihead_attention(q, q, q, 2, use_kernel=True)


def test_kernel_launcher_refuses_cpu_tensors():
    # The launcher never runs the plain version in the kernel's place.
    q = torch.zeros((2, 8, 16))
    before = (tattn.SINGLE_LAUNCHES, tattn.FLASH_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tattn._launch(q, q, q)
    assert (tattn.SINGLE_LAUNCHES, tattn.FLASH_LAUNCHES) == before


def test_flash_attention_backward_on_cpu_is_the_references():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(2, 21, 16, seed=5))
    g = torch.autograd.grad((tattn.flash_attention(q, k, v) ** 2).sum(),
                            (q, k, v))
    g_ref = torch.autograd.grad((tattn.attention_reference(q, k, v) ** 2).sum(),
                                (q, k, v))
    for a, b in zip(g, g_ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
