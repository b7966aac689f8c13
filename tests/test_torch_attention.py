"""PyTorch port: ``ops/attention.py`` against the JAX package.

The plain version ``attention_reference`` (what the CUDA attention kernels
are held to on the card, what their backward differentiates, and what
every CPU run computes) against JAX's ``attention_reference`` and against
JAX's Pallas ``flash_attention`` in interpret mode, at the shapes of
``tests/test_attention.py``: the single-block range, the blocked range
(S > 1024), and lengths whose padding to the 128 grid needs the tail mask.
Same inputs on both sides, made with numpy from a seed.

Also what a CPU run can say of the CUDA kernels: the rule that picks kernel
and variant (``plan``, a pure function) at the H100's shared-memory size,
the shared-memory formula it is decided on, an emulation of the ``tf32x3``
variant's arithmetic (float32 operands split into two TF32 parts, three
products a product, key blocks, the scale after the product) against JAX's
kernels and reference, an emulation of the ``mma`` variant's arithmetic
(key blocks, scale after the product, p rounded to bf16) against JAX's
kernels and, in the flagship's served tick, against
JAX's ``multi.update_streams`` (maps 0.05, the same peak cell, confidence
0.02, boxes 2 px), and ``multihead_attention`` on strided views.

Tolerances: float32 2e-5 (JAX's own kernel-vs-reference tolerance; the
sums run in another order); bf16 inputs 2^-8 of the largest value (one
output ulp); the emulated bf16-p arithmetic 2^-7 of the largest value (the
tolerance the kernels are held to on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import heads as jheads  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import attention as jattn  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import preprocess as jpp  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import multi as jmulti  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import heads as theads  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit as tvit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack as tvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention as tattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import multi as tmulti  # noqa: E402

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


# ---------------------------------------------------------------------------
# The rule that picks kernel and variant, at the H100's opt-in shared memory
# ---------------------------------------------------------------------------

H100_OPTIN = 232448
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("s,dh,dtype,route,variant", [
    (320, 64, BF16, "single", "mma"),      # the serving shape
    (1088, 64, BF16, "flash", "mma"),      # the long-sequence shape
    (320, 64, F32, "flash", "tf32x3"),     # the training step
    (33, 8, BF16, "single", "simt"),       # a head dim the tiles do not take
    (384, 64, BF16, "single", "mma"),      # the last length that fits twice
    (448, 64, BF16, "flash", "mma"),
    (33, 128, BF16, "single", "mma"),
    (200, 32, BF16, "single", "mma"),
    (1200, 32, BF16, "flash", "mma"),
    (777, 128, BF16, "flash", "mma"),
    (80, 48, BF16, "single", "simt"),
    (80, 48, F32, "single", "tf32x3"),     # the small preset's serving tick
    (128, 64, F32, "single", "tf32x3"),    # the last length that fits twice
    (4099, 8, F32, "flash", "tf32x3"),
    (4099, 8, BF16, "flash", "simt"),
])
def test_plan_route_and_variant(s, dh, dtype, route, variant):
    got = tattn.plan(s, dh, dtype, H100_OPTIN)
    assert (got.route, got.variant) == (route, variant)
    eb = 2 if dtype == BF16 else 4
    # What is launched fits the card.
    assert tattn.smem_bytes(route, variant, s, dh, eb, got.kb, got.stages,
                            got.warpgroups) <= H100_OPTIN
    if variant == "simt":
        assert (got.kb, got.stages, got.warpgroups) == (0, 0, 1)
    elif variant == "tf32x3":
        assert (got.kb, got.stages, got.warpgroups) == (
            64, 2 if route == "flash" else 0, 1)
    elif route == "single":
        assert (got.kb, got.stages, got.warpgroups) == (64, 0, 1)


@pytest.mark.parametrize("s,dh,bh,kb,warpgroups", [
    (1088, 64, 3, 128, 2),       # 51 tiles for 132 SMs: split the keys
    (1088, 64, 48, 64, 1),       # 816 tiles: more CTAs an SM instead
    (1088, 64, 7, 128, 2),       # 119 tiles
    (1088, 64, 8, 64, 1),        # 136 tiles
    (1001, 128, 2, 64, 2),       # two 128-key stages of dh 128 do not fit
])
def test_plan_shapes_the_ring_by_the_grid(s, dh, bh, kb, warpgroups):
    got = tattn.plan(s, dh, BF16, H100_OPTIN, bh=bh, sms=132)
    assert got == tattn.Plan("flash", "mma", kb, 2, warpgroups)
    assert tattn.smem_bytes("flash", "mma", s, dh, 2, kb, 2,
                            warpgroups) <= H100_OPTIN


@pytest.mark.parametrize("args,want", [
    # Q tile + K and V of 320 keys as 128-byte rows, + alignment slack.
    (("single", "mma", 320, 64, 2, 64), 1024 + (64 + 2 * 320) * 128),
    (("single", "mma", 321, 64, 2, 64), 1024 + (64 + 2 * 384) * 128),
    (("single", "mma", 320, 64, 2, 128), 1024 + (64 + 2 * 384) * 128),
    (("flash", "mma", 1088, 64, 2, 128, 2, 2), 1024 + (64 + 2 * 512) * 128),
    (("flash", "mma", 99999, 32, 2, 64, 3, 1), 1024 + (64 + 2 * 192) * 64),
    # K^T at an odd word stride (161 words), V, the f32 q tile, f32 scores.
    (("single", "simt", 320, 64, 2), 64 * 322 * 2 + 320 * 64 * 2
     + 64 * 64 * 4 + 64 * 320 * 4),
    (("flash", "simt", 5000, 64, 4), 64 * 131 * 4 + 128 * 64 * 4
     + 32 * 64 * 4 + 32 * 128 * 4),
    # The f32 Q tile and K and V of every 64-key block, rows of dh + 4 floats.
    (("single", "tf32x3", 80, 48, 4, 64), (64 + 2 * 128) * 52 * 4),
    (("single", "tf32x3", 128, 64, 4, 64), (64 + 2 * 128) * 68 * 4),
    (("single", "tf32x3", 1, 8, 4, 64), (64 + 2 * 64) * 12 * 4),
    # ... and a ring of two 64-key blocks, whatever the length.
    (("flash", "tf32x3", 320, 64, 4, 64, 2, 1), (64 + 2 * 128) * 68 * 4),
    (("flash", "tf32x3", 99999, 128, 4, 64, 2, 1), (64 + 2 * 128) * 132 * 4),
])
def test_smem_bytes(args, want):
    assert tattn.smem_bytes(*args) == want


def test_plan_gives_float32_tf32x3_at_every_head_dim():
    # Every float32 head dim from 1 to 128 and length takes tf32x3 (padded
    # to a multiple of 8 where it is not one), and what it launches fits.
    for dh in range(1, 129):
        pad = -(-dh // 8) * 8
        for s in (1, 20, 80, 320, 1088):
            got = tattn.plan(s, dh, F32, H100_OPTIN, bh=48)
            assert got.variant == "tf32x3"
            assert got.pad == (0 if pad == dh else pad)
            assert tattn.smem_bytes(got.route, got.variant, s, pad, 4, got.kb,
                                    got.stages, got.warpgroups) <= H100_OPTIN


def test_plan_takes_single_only_while_two_ctas_fit_an_sm():
    fits = [s for s in range(64, 1025, 64)
            if tattn.plan(s, 64, BF16, H100_OPTIN).route == "single"]
    assert fits == [64, 128, 192, 256, 320, 384]
    # The simt variant holds the f32 scores too: about 420 keys in bf16.
    simt = [s for s in range(64, 1025, 64)
            if tattn.plan(s, 48, BF16, H100_OPTIN).route == "single"]
    assert simt and max(simt) < 512
    # tf32x3 holds float32 rows: two CTAs an SM hold 128 keys at head dim 64.
    f32 = [s for s in range(64, 1025, 64)
           if tattn.plan(s, 64, F32, H100_OPTIN).route == "single"]
    assert f32 == [64, 128]


# ---------------------------------------------------------------------------
# The mma variant's arithmetic, emulated
# ---------------------------------------------------------------------------

def _emulate_mma(q, k, v, kb):
    """What the mma kernels compute for bf16 q, k, v of shape (B, S, dh):
    f32 scores of exact bf16 products, online softmax over blocks of ``kb``
    keys with dh^-1/2 . log2(e) applied to the scores, the row sum taken of
    the f32 p, p rounded to bf16 for P.V, one rounding of o / l."""
    b, s, dh = q.shape
    c = torch.tensor(dh ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, s, 1), float("-inf"))
    l = torch.zeros((b, s, 1))
    o = torch.zeros((b, s, dh))
    for k0 in range(0, s, kb):
        kj, vj = k[:, k0:k0 + kb].float(), v[:, k0:k0 + kb].float()
        sc = q.float() @ kj.transpose(1, 2)
        m_new = torch.maximum(m, sc.max(-1, keepdim=True).values)
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(sc * c - m_new * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vj
        m = m_new
    return (o / l).to(torch.bfloat16)


@pytest.mark.parametrize("kb", [64, 128])
@pytest.mark.parametrize("b,s,d", [(3, 320, 64), (1, 1200, 32), (2, 33, 128)])
def test_mma_arithmetic_matches_jax_kernels(b, s, d, kb):
    q, k, v = _qkv(b, s, d, seed=6)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jattn.flash_attention(jq, jk, jv, interpret=True),
                     np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _emulate_mma(tq, tk, tv, kb).float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    # And against the port's own plain version, which the card run uses.
    plain = tattn.attention_reference(tq, tk, tv).float().numpy()
    assert np.abs(got - plain).max() <= 2.0 ** -7 * np.abs(plain).max()


def test_mma_arithmetic_large_values():
    # v scaled by 100, as test_attention.py::test_flash_padding_does_not_leak:
    # the tolerance scales with the values, the ragged last block (320 = 2 x
    # 128 + 64) adds nothing.
    q, k, v = _qkv(1, 320, 64, seed=7, v_scale=100.0)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    plain = tattn.attention_reference(tq, tk, tv).float()
    got = _emulate_mma(tq, tk, tv, 128).float()
    assert (got - plain).abs().max() <= 2.0 ** -7 * plain.abs().max()


# ---------------------------------------------------------------------------
# The tf32x3 variant's arithmetic (float32), emulated
# ---------------------------------------------------------------------------

ATT_F32_ATOL = 1e-5      # what chip_smoke.py holds the float32 kernels to


@pytest.fixture
def one_thread():
    """The emulations are many small products: one intra-op thread, which
    runs them as fast alone and does not crawl beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the int32 view: what cvt.rna.tf32.f32 gives."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    """x as hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_products(a, b, acc, three=True):
    """acc + a @ b as the kernel takes it: 8 columns of a (rows of b) at a
    time, each as lo.hi, hi.lo, then hi.hi into the f32 accumulator; with
    ``three=False`` hi.hi alone (one TF32 product)."""
    for c in range(0, a.shape[-1], 8):
        ah, al = _split(a[..., c:c + 8])
        bh, bl = _split(b[..., c:c + 8, :])
        if three:
            acc = acc + al @ bh
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def _emulate_tf32x3(q, k, v, kb=64, three=True):
    """What the tf32x3 kernels compute for float32 q, k, v of shape (B, S,
    dh): split-TF32 scores, online softmax over blocks of ``kb`` keys with
    dh^-1/2 . log2(e) applied to the f32 scores, p split for P.V, one
    division of o by l."""
    b, s, dh = q.shape
    c = torch.tensor(dh ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, s, 1), float("-inf"))
    l = torch.zeros((b, s, 1))
    o = torch.zeros((b, s, dh))
    for k0 in range(0, s, kb):
        kj, vj = k[:, k0:k0 + kb], v[:, k0:k0 + kb]
        sc = _tf32_products(q, kj.transpose(1, 2),
                            torch.zeros((b, s, kj.shape[1])), three)
        m_new = torch.maximum(m, sc.max(-1, keepdim=True).values)
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(sc * c - m_new * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = _tf32_products(p, vj, o * alpha, three)
        m = m_new
    return o / l


@pytest.mark.parametrize("b,s,d,v_scale", [
    (3, 320, 64, 1.0),     # the training step's shape, three heads of it
    (2, 80, 48, 1.0),      # the small preset's serving tick
    (1, 777, 32, 1.0),     # a ragged last block
    (1, 33, 128, 1.0),     # one block, the head-dim class Q is reloaded in
    (1, 320, 64, 100.0)])  # v x 100: a leaking tail would show at once
def test_tf32x3_arithmetic_matches_jax(one_thread, b, s, d, v_scale):
    q, k, v = _qkv(b, s, d, seed=8, v_scale=v_scale)
    got = _emulate_tf32x3(*map(torch.from_numpy, (q, k, v))).numpy()
    assert np.isfinite(got).all()
    tol = 2e-5 * v_scale   # the file's float32 tolerance, at v's scale
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for ref in (jattn.flash_attention(jq, jk, jv, interpret=True),
                jattn.attention_reference(jq, jk, jv),
                tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=tol)


def test_tf32x3_needs_the_split(one_thread):
    # One TF32 product (hi alone) misses the 1e-5 the float32 kernels are
    # held to on the card; the three products keep it: the tolerance tells
    # the two designs apart.
    q, k, v = map(torch.from_numpy, _qkv(3, 320, 64, seed=9))
    plain = tattn.attention_reference(q, k, v)
    three = (_emulate_tf32x3(q, k, v) - plain).abs().max().item()
    one = (_emulate_tf32x3(q, k, v, three=False) - plain).abs().max().item()
    assert three <= ATT_F32_ATOL < one, (three, one)


def test_tf32_rounding_is_to_nearest_ties_away():
    # The int32-view rounding: 11 significant bits, half an ulp rounds away
    # from zero, and hi + lo holds x to 2^-22 of it.
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23, 3.0 + 2.0 ** -20])
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 3.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(10).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _split(r)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert ((hi.double() + lo.double() - r.double()).abs()
            <= 2.0 ** -22 * r.double().abs()).all()


def _emulated_multihead(q, k, v, num_heads, use_kernel=None):
    """``multihead_attention`` with the mma variant's arithmetic (64-key
    blocks, the serving shape's configuration) on (B, S, heads * dh)."""
    b, s, d = q.shape
    dh = d // num_heads

    def split(t):
        return (t.reshape(b, s, num_heads, dh).transpose(1, 2)
                .reshape(b * num_heads, s, dh))

    out = _emulate_mma(split(q), split(k), split(v), 64)
    return out.reshape(b, num_heads, s, dh).transpose(1, 2).reshape(b, s, d)


def _tick_frames(n, h=360, w=640):
    """Two streams of n NV12 frames, a bright textured target each (moving
    3 px right, 2 px down a frame), and the boxes of frame 0 (2, 1, 4)."""
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:h, 0:w]
    streams, boxes = [], []
    for k, (x0, y0) in enumerate(((200, 120), (330, 160))):
        bg = (70 + 25 * np.sin(xx / 37.0 + k) * np.cos(yy / 29.0)
              + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.uint8)
        tex = (185 + 60 * (((np.arange(72)[:, None] // 8)
                            + (np.arange(96)[None] // 8)) % 2)).astype(np.uint8)
        frames = []
        for t in range(n):
            x, y = x0 + 4 * t, y0 + 2 * t
            yp, uv = bg.copy(), np.full((h // 2, w // 2, 2), 128, np.uint8)
            yp[y:y + 72, x:x + 96] = tex
            uv[y // 2:(y + 72) // 2, x // 2:(x + 96) // 2] = (90, 200)
            frames.append((yp, uv))
        streams.append(frames)
        boxes.append([(float(x0), float(y0), 96.0, 72.0)])
    return streams, np.asarray(boxes, np.float32)


def test_flagship_tick_with_mma_attention_matches_jax(monkeypatch):
    # The served tick (tracker/multi.py: per-block encode, the attention
    # kernels) with the mma variant's arithmetic (p rounded to bf16 for P.V)
    # in place of the plain attention, against JAX's update_streams on the
    # same frames and shipped flagship weights, bf16.  Held as the flagship
    # bf16 step is: head maps within 0.05, the same peak cell, the
    # confidence within 0.02; the tick's boxes within 2 px.
    cfg_j, cfg_t = JAX_PRESETS["vittrack-t"], PRESETS["vittrack-t"]
    path = tweights.checkpoint_path("vittrack-t")
    like = jax.eval_shape(lambda: jvittrack.init_params(jax.random.PRNGKey(0),
                                                        cfg_j))
    jparams = jweights.load_npz(path, like)
    tparams = tweights.load_npz(path, cfg_t, device=torch.device("cpu"))
    streams, boxes = _tick_frames(2)

    def frames(t):
        return (np.stack([s[t][0] for s in streams]),
                np.stack([s[t][1] for s in streams]))

    active = np.ones((2, 1), bool)
    jst = jmulti.init_streams(jparams, tuple(map(jnp.asarray, frames(0))),
                              jnp.asarray(boxes), cfg_j, "nv12")
    tst = tmulti.init_streams(tparams, frames(0), boxes, cfg_t, "nv12",
                              device="cpu")
    calls = []
    monkeypatch.setattr(tvit, "multihead_attention",
                        lambda *a, **kw: calls.append(1) or _emulated_multihead(*a, **kw))
    _, jb, jsc = jax.jit(lambda p, st, f: jmulti.update_streams(
        p, st, f, jnp.asarray(active), cfg_j, "nv12"))(
        jparams, jst, tuple(map(jnp.asarray, frames(1))))
    _, tb, tsc = tmulti.update_streams(tparams, tst, frames(1), active, cfg_t,
                                       "nv12", device="cpu")
    assert len(calls) == cfg_t.depth              # every block of the tick
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 2.0
    assert np.abs(tsc.numpy() - np.asarray(jsc)).max() <= 0.02

    # The maps of each slot, as the tick computes them.
    jcfg, tcfg = jmulti._batched_cfg(cfg_j), tmulti._batched_cfg(cfg_t)
    fs = cfg_t.feat_size
    for s in range(2):
        frame = tuple(a[s] for a in frames(1))
        jwin = jpp.crop_window(jst.bbox[s, 0], cfg_j.search_factor)
        jmaps = jvittrack.forward(
            jparams, jst.z_tok[s, 0][None],
            jcore._prep_nv12(tuple(map(jnp.asarray, frame)), jwin,
                             cfg_j.search_size, jcfg)[None], jcfg, fused=False)
        twin = tpp.crop_window(tst.bbox[s, 0], cfg_t.search_factor)
        tmaps = tvittrack.forward(
            tparams, tst.z_tok[s, 0][None],
            tcore._prep_nv12(tcore._frame_on(frame, "nv12", "cpu"), twin,
                             cfg_t.search_size, tcfg)[None], tcfg, fused=False)
        for name in ("score", "offset", "size"):
            np.testing.assert_allclose(getattr(tmaps, name).float().numpy(),
                                       np.asarray(getattr(jmaps, name), np.float32),
                                       atol=0.05, rtol=0, err_msg=name)
        jpen = np.asarray(jmaps.score[0] * jheads.hanning_2d(fs)).ravel()
        tpen = (tmaps.score[0] * theads.hanning_2d(fs)).float().numpy().ravel()
        top2 = np.sort(jpen)[-2:]
        assert top2[1] - top2[0] > 0.05, top2          # a well-separated peak
        assert int(np.argmax(tpen)) == int(np.argmax(jpen))
        _, jconf = jheads.decode_maps(jmaps.score[0], jmaps.offset[0],
                                      jmaps.size[0], jheads.hanning_2d(fs),
                                      jst.bbox[s, 0, 2:4] / jwin.size)
        _, tconf = theads.decode_maps(tmaps.score[0], tmaps.offset[0],
                                      tmaps.size[0], theads.hanning_2d(fs),
                                      tst.bbox[s, 0, 2:4] / twin.size)
        assert abs(float(tconf) - float(jconf)) <= 0.02


# ---------------------------------------------------------------------------
# multihead_attention on views of one qkv array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [3, 4])
def test_multihead_on_chunk_views_matches_jax_and_contiguous(heads):
    rng = np.random.default_rng(14)
    qkv = rng.standard_normal((2, 37, 144)).astype(np.float32)
    q, k, v = np.split(qkv, 3, axis=-1)
    ref = jattn.multihead_attention(*map(jnp.asarray, (q, k, v)), heads,
                                    use_pallas=False)
    tq, tk, tv = torch.chunk(torch.from_numpy(qkv), 3, dim=-1)
    assert not tq.is_contiguous() and tq.stride() == (37 * 144, 144, 1)
    got = tattn.multihead_attention(tq, tk, tv, heads)
    assert got.shape == (2, 37, 48) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    again = tattn.multihead_attention(tq.contiguous(), tk.contiguous(),
                                      tv.contiguous(), heads)
    np.testing.assert_array_equal(got.numpy(), again.numpy())


def test_multihead_backward_on_chunk_views():
    rng = np.random.default_rng(15)
    qkv = torch.from_numpy(rng.standard_normal((2, 11, 96)).astype(np.float32)
                           ).requires_grad_(True)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    (g,) = torch.autograd.grad((tattn.multihead_attention(q, k, v, 2) ** 2
                                ).sum(), [qkv])
    qc, kc, vc = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    gs = torch.autograd.grad((tattn.multihead_attention(
        qc, kc, vc, 2, use_kernel=False) ** 2).sum(), [qc, kc, vc])
    np.testing.assert_allclose(g.numpy(), torch.cat(gs, -1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_prepared_refuses_cpu_tensors():
    q = torch.zeros((2, 8, 16))
    before = (tattn.SINGLE_LAUNCHES, tattn.FLASH_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.prepared(q, q, q)
    assert (tattn.SINGLE_LAUNCHES, tattn.FLASH_LAUNCHES) == before
