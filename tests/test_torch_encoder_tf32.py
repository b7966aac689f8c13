"""PyTorch port: the ``tf32x3`` variant of the encoder kernels (kernels 1
and 2 in float32, ``csrc/encoder_tf32.cuh``) on the CPU.

The kernels run only on the card; what a CPU run can hold of them is their
arithmetic, emulated here step for step where it rounds:

* the split: ``ops/vit_block.py::split_tf32`` (hi = tf32(w), lo = tf32(w -
  hi) by an integer add and mask, what the kernels' ``to_tf32`` does) is
  held bit for bit to a plain rounding (float64 arithmetic: 11 significant
  bits, to nearest, ties away from zero) on random floats over 20 binades
  and on ties; ``split_planes`` and the operand cache lay the weights out
  as the kernels read them (two planes, the padded heads zero in both);
* the products: every 8-deep step of A (split as its fragment is loaded)
  against the cached planes of W as three products, lo.hi, hi.lo, then
  hi.hi, into a float32 accumulator; the LN prologue (the mean, then the
  mean of squares, eps 1e-6); the epilogues (bias in float32, then the tanh
  GELU or the residual); the attention as ``attention_tf32.cuh`` computes it
  (64-key blocks, the online softmax with dh^-1/2 . log2(e) on the float32
  scores, p split for P.V, one division), every accumulator's sums rounded
  toward zero as the tensor cores round them: a 32-deep chunk of a product
  (its even and its odd 8-deep steps apart) and a key block's scores or P.V
  each in fresh accumulators, added in float32; at the plan's 2 warpgroups
  (batch 1) a product's chunks and the attention's key blocks dealt to two
  warpgroups in turn, their sums added and their softmax states merged.

The emulation is held to the port's twin (``encoder_reference``) and to
JAX's ``ops/vit_block.py::encoder`` in float32 (the Pallas kernel in
interpret mode, as the JAX package's own tests run it) on the same seeded
numpy tokens, with the shipped weights in float32 at the ``small`` preset's
depth 4 and the flagship's depth 12: within ``F32_ATOL`` = 1e-3 absolute,
``chip_smoke.py``'s bound for the card against the twin, and within 3e-6 of
max|reference|, the order of the truncated float32 sums (read: 7.6e-6 and
5.7e-6 at ``small``, 8.5e-7 and 6.4e-7 of max|reference|; 2.8e-4 and
2.7e-4 at the flagship, 1.7e-6 and 1.7e-6; the card read 3.6e-6 and
3.2e-4 against the twin).  Two planted faults are caught: a single TF32
product (hi.hi alone) in place of three misses both bounds at both depths
(0.0029 at ``small``, 3.3e-4 of max|reference|; 0.094 at the flagship,
5.8e-4); one accumulator over all of K and all keys, the first design's,
misses the relative bound at both (7.4e-6 to 7.7e-6 of max|reference| at
``small``, 9.0e-6 to 9.3e-6 at the flagship: 1.46e-3 to 1.50e-3, where the
card read 1.68e-3 for that design).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import vit_block as jvb  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import vit_block  # noqa: E402

F32 = torch.float32
F32_ATOL = 1e-3          # chip_smoke.py: the card against the twin, float32
H100_SMS = 132
EMU_REL_TOL = 3e-6       # max|emulation - reference| / max|reference|
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small products: one intra-op thread, which runs them as fast
    alone and does not crawl beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------

def _plain_tf32(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to 11 significant bits, to nearest with ties
    away from zero, in float64 arithmetic (normal floats)."""
    x = x.astype(np.float64)
    _, e = np.frexp(x)                       # |x| = m . 2^e, m in [0.5, 1)
    q = np.ldexp(1.0, e - 11)                # the 11th bit's weight
    return (np.sign(x) * np.floor(np.abs(x) / q + 0.5) * q).astype(np.float32)


def test_split_is_a_plain_rounding_bit_for_bit():
    rng = np.random.default_rng(17)
    x = (rng.standard_normal(1 << 16) * 10.0 ** rng.uniform(-3, 3, 1 << 16)
         ).astype(np.float32)
    # Ties: the 13 dropped bits exactly half of the kept last bit, of both
    # signs, and one below and above a tie.
    bits = rng.integers(0x3f000000, 0x40800000, 256).astype(np.uint32)
    ties = np.concatenate([(bits & ~np.uint32(0x1fff)) | np.uint32(d)
                           for d in (0x1000, 0x0fff, 0x1001)]).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    hi, lo = vit_block.split_tf32(torch.from_numpy(x))
    want_hi = _plain_tf32(x)
    want_lo = _plain_tf32((x - want_hi).astype(np.float32))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  want_lo.view(np.uint32))
    # What is dropped is about 2^-22 of x.
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x)).all()


def test_split_planes_and_the_operand_cache():
    # The four kernels as (..., 2, in, out), hi then lo, every other leaf as
    # it was; the cache pads the heads first (dh 12 -> 16) and the padded
    # columns and rows are zero in both planes.
    gen = torch.Generator().manual_seed(3)
    d, heads, hidden, depth = 96, 8, 192, 2
    shapes = [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, hidden), (hidden,), (hidden, d), (d,)]
    flat = [torch.randn(s, generator=gen) for _ in range(depth) for s in shapes]
    ops = vit_block._operands(flat, depth, F32, heads)
    assert vit_block._operands(flat, depth, F32, heads) is ops
    e = heads * 16
    assert [tuple(t.shape) for t in ops] == [
        (depth, d), (depth, d), (depth, 2, d, 3 * e), (depth, 3 * e),
        (depth, 2, e, d), (depth, d), (depth, d), (depth, d),
        (depth, 2, d, hidden), (depth, hidden), (depth, 2, hidden, d),
        (depth, d)]
    padded = vit_block._pad_heads(vit_block._stack(flat, depth), heads, 16)
    for i in vit_block._KERNELS:
        hi, lo = vit_block.split_tf32(padded[i])
        assert torch.equal(ops[i][:, 0], hi) and torch.equal(ops[i][:, 1], lo)
    cols = torch.arange(3 * e) % 16 < 12
    assert not ops[2][..., ~cols].any() and not ops[4][..., ~cols[:e], :].any()
    for i in (0, 1, 3, 5, 6, 7, 9, 11):
        assert torch.equal(ops[i], padded[i])


# ---------------------------------------------------------------------------
# The arithmetic, emulated
# ---------------------------------------------------------------------------

def _toward_zero(x):
    """float64 sums rounded to float32 toward zero, as the tensor cores
    round the sum they accumulate."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mma3(acc, ah, al, bh, bl, three=True):
    """One 8-deep step into the float32 accumulator ``acc`` as mma.sync
    takes it: lo.hi, hi.lo, then hi.hi, each an exact sum of 8 products
    added to the accumulator and rounded toward zero; ``three=False``
    hi.hi alone (one TF32 product, a planted fault)."""
    pairs = ((al, bh), (ah, bl), (ah, bh)) if three else ((ah, bh),)
    for a, b in pairs:
        acc = _toward_zero(acc.double() + a.double() @ b.double())
    return acc


def _chain(acc, a, w_hi, w_lo, three=True):
    """acc + a @ w as one accumulator takes it: 8 columns of a (rows of w)
    at a time as ``_mma3``, a split as its fragment is loaded, w from its
    planes."""
    for c in range(0, a.shape[-1], 8):
        ah, al = vit_block.split_tf32(a[..., c:c + 8])
        acc = _mma3(acc, ah, al, w_hi[..., c:c + 8, :],
                    w_lo[..., c:c + 8, :], three)
    return acc


def _products(a, w_hi, w_lo, three=True, chunk=32, wgs=1):
    """a @ w as the product kernel takes it: ``chunk`` columns of a (rows
    of w) at a time, the chunk's even 8-deep steps in one fresh accumulator
    and its odd ones in another (``_mma3``), the two added and then added
    to the sum in float32; with ``wgs`` warpgroups, warpgroup w sums chunks
    w, w + wgs, ... and the sums are added at the end; ``chunk=None`` one
    accumulator over all of K (a planted fault: a chain of truncated sums
    as long as K)."""
    out = torch.zeros(a.shape[:-1] + (w_hi.shape[-1],))
    if chunk is None:
        return _chain(out, a, w_hi, w_lo, three)
    sums = [torch.zeros_like(out) for _ in range(wgs)]
    for n, c0 in enumerate(range(0, a.shape[-1], chunk)):
        parts = [torch.zeros_like(out), torch.zeros_like(out)]
        for step, c in enumerate(range(c0, min(c0 + chunk, a.shape[-1]), 8)):
            parts[step % 2] = _chain(parts[step % 2], a[..., c:c + 8],
                                     w_hi[..., c:c + 8, :],
                                     w_lo[..., c:c + 8, :], three)
        sums[n % wgs] = sums[n % wgs] + (parts[0] + parts[1])
    total = sums[0]
    for more in sums[1:]:
        total = total + more
    return total


def _linear(a, p, three, chunk=32, wgs=1):
    """A product and its bias, as the epilogue adds it (float32)."""
    hi, lo = vit_block.split_tf32(p["kernel"])
    return _products(a, hi, lo, three, chunk, wgs) + p["bias"]


def _layer_norm(x, p):
    """The LN prologue: the mean as the float32 sum divided by K, then the
    mean of (x - mu)^2 the same way, 1 / sqrt, each operation rounded on its
    own."""
    k = torch.tensor(float(x.shape[-1]), dtype=F32)
    mu = x.sum(-1, keepdim=True) / k
    t = x - mu
    var = (t * t).sum(-1, keepdim=True) / k
    y = t * (1.0 / torch.sqrt(var + torch.tensor(1e-6, dtype=F32)))
    return y * p["scale"] + p["bias"]


def _attention(q, k, v, three, scale_dh, wgs=1, kb=64):
    """One head as the encoder's attention computes it: the key blocks of
    ``kb`` keys dealt in turn to ``wgs`` warpgroups, each with its own
    state: split-TF32 scores of a block in a fresh accumulator, the online
    softmax with scale_dh^-1/2 . log2(e) applied to the float32 scores, the
    block's P.V with p split in a fresh accumulator too, o = o . alpha + pv
    with one rounding (an fma); the states merged (each scaled by
    exp2((m_side - m) . c), added with one rounding); one division by
    l."""
    b, s, dh = q.shape
    c = torch.tensor(scale_dh ** -0.5 * LOG2E, dtype=F32)

    def fma(a, x, y):
        return (a.double() * x.double() + y.double()).float()

    states = []
    for w in range(wgs):
        m = torch.full((b, s, 1), float("-inf"))
        l = torch.zeros((b, s, 1))
        o = torch.zeros((b, s, dh))
        for k0 in range(w * kb, s, wgs * kb):
            kj, vj = k[:, k0:k0 + kb], v[:, k0:k0 + kb]
            kh, kl = vit_block.split_tf32(kj.transpose(1, 2))
            sc = _chain(torch.zeros((b, s, kj.shape[1])), q, kh, kl, three)
            m_new = torch.maximum(m, sc.max(-1, keepdim=True).values)
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2(sc * c - m_new * c)
            l = l * alpha + p.sum(-1, keepdim=True)
            vh, vl = vit_block.split_tf32(vj)
            o = fma(o, alpha, _chain(torch.zeros_like(o), p, vh, vl, three))
            m = m_new
        states.append((m, l, o))
    m, l, o = states[0]
    for m1, l1, o1 in states[1:]:
        mm = torch.maximum(m, m1)
        a0 = torch.where(m == float("-inf"), 0.0, torch.exp2((m - mm) * c))
        a1 = torch.where(m1 == float("-inf"), 0.0, torch.exp2((m1 - mm) * c))
        l, o, m = fma(l, a0, l1 * a1), fma(o, a0, o1 * a1), mm
    return o / l


def emulate_encoder(x, blocks, heads, three=True, scale_dh=None, chunk=32):
    """The encoder kernel's tf32x3 variant on the CPU, block by block: LN1
    + qkv, the attention on the qkv buffer's head slices, proj + residual,
    LN2 + mlp1 + GELU, mlp2 + residual, at the tiles and split the plan
    gives an H100's 132 SMs.  The head dim is the qkv kernel's width
    over 3 heads (padded weights: the padded one), the scores are scaled by
    ``scale_dh`` (default: that head dim)."""
    b, s, d = x.shape
    dh = blocks[0]["qkv"]["kernel"].shape[1] // (3 * heads)
    scale_dh = scale_dh or dh
    plan = vit_block.plan(b, s, d, heads, blocks[0]["mlp1"]["kernel"].shape[1],
                          F32, H100_SMS)
    # Warpgroups of each product (qkv, proj, mlp1, mlp2): the plan's at N
    # tiles 16 and 32.
    wgs = [1 if n == 64 else plan.warpgroups for n in plan.tiles]

    def heads_of(t):
        return t.reshape(b, s, heads, dh).transpose(1, 2).reshape(
            b * heads, s, dh)

    for p in blocks:
        q, k, v = torch.chunk(_linear(_layer_norm(x, p["ln1"]), p["qkv"],
                                      three, chunk, wgs[0]), 3, -1)
        a = _attention(heads_of(q), heads_of(k), heads_of(v), three, scale_dh,
                       plan.warpgroups)
        a = a.reshape(b, heads, s, dh).transpose(1, 2).reshape(b, s, heads * dh)
        x = x + _linear(a, p["proj"], three, chunk, wgs[1])
        g = F.gelu(_linear(_layer_norm(x, p["ln2"]), p["mlp1"], three, chunk,
                           wgs[2]), approximate="tanh")
        x = x + _linear(g, p["mlp2"], three, chunk, wgs[3])
    return x


@pytest.fixture(scope="module")
def shipped():
    """Per preset: the shipped backbone blocks in float32 and seeded
    tokens, as torch tensors and as JAX arrays of the same numbers."""
    out = {}
    for name, seed in (("small", 4), ("vittrack-t", 12)):
        cfg = PRESETS[name]
        bb = weights.load_npz(weights.checkpoint_path(name), cfg,
                              device="cpu")["backbone"]
        blocks = [vit.cast_params(p, F32) for p in bb["blocks"]]
        x = np.random.default_rng(seed).standard_normal(
            (1, cfg.num_tokens, cfg.embed_dim)).astype(np.float32)
        jblocks = [{m: {f: jnp.asarray(t.numpy()) for f, t in leaves.items()}
                    for m, leaves in p.items()} for p in blocks]
        out[name] = (cfg, blocks, torch.from_numpy(x), jblocks, jnp.asarray(x))
    return out


def _distances(shipped, name, three=True, chunk=32):
    """max|emulation - reference| and the same over max|reference|, for
    the port's twin and for JAX's float32 encoder."""
    cfg, blocks, x, jblocks, jx = shipped[name]
    assert len(blocks) == cfg.depth
    emu = emulate_encoder(x, blocks, cfg.num_heads, three, chunk=chunk).numpy()
    assert emu.shape == tuple(x.shape) and np.isfinite(emu).all()
    refs = {"twin": vit_block.encoder_reference(x, blocks, cfg.num_heads).numpy(),
            "jax": np.asarray(jvb.encoder(jx, jblocks, cfg.num_heads),
                              np.float32)}
    return {k: (float(np.abs(emu - r).max()),
                float(np.abs(emu - r).max() / np.abs(r).max()))
            for k, r in refs.items()}


@pytest.mark.parametrize("name", ["small", "vittrack-t"])
def test_emulation_matches_twin_and_jax(shipped, name):
    # The small preset at its depth 4, the flagship at its depth 12: the
    # emulated kernel against the port's twin and JAX's float32 encoder.
    for ref, (d, rel) in _distances(shipped, name).items():
        assert d <= F32_ATOL and rel <= EMU_REL_TOL, (name, ref, d, rel)


@pytest.mark.parametrize("name", ["small", "vittrack-t"])
def test_single_tf32_product_is_caught(shipped, name):
    # hi.hi alone: 11 bits of each operand.  Both bounds catch it at both
    # depths.
    for ref, (d, rel) in _distances(shipped, name, three=False).items():
        assert d > F32_ATOL and rel > EMU_REL_TOL, (name, ref, d, rel)


@pytest.mark.parametrize("name", ["small", "vittrack-t"])
def test_one_accumulator_over_k_is_caught(shipped, name, monkeypatch):
    # The first design: every product's 12-a-chunk sums chained in one
    # accumulator over all of K, and every key block's P.V into o itself.
    def chained_attention(q, k, v, three, scale_dh, wgs=1, kb=64):
        b, s, dh = q.shape
        c = torch.tensor(scale_dh ** -0.5 * LOG2E, dtype=F32)
        m = torch.full((b, s, 1), float("-inf"))
        l = torch.zeros((b, s, 1))
        o = torch.zeros((b, s, dh))
        for k0 in range(0, s, kb):
            kj, vj = k[:, k0:k0 + kb], v[:, k0:k0 + kb]
            kh, kl = vit_block.split_tf32(kj.transpose(1, 2))
            sc = _chain(torch.zeros((b, s, kj.shape[1])), q, kh, kl, three)
            m_new = torch.maximum(m, sc.max(-1, keepdim=True).values)
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2(sc * c - m_new * c)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = _chain(o * alpha, p, *vit_block.split_tf32(vj), three)
            m = m_new
        return o / l

    monkeypatch.setitem(globals(), "_attention", chained_attention)
    for ref, (d, rel) in _distances(shipped, name, chunk=None).items():
        assert rel > EMU_REL_TOL, (name, ref, d, rel)


def test_padded_heads_emulated_equal_the_unpadded():
    # Zero-padded heads (dh 12 -> 16, the tf32x3 rule) through the emulated
    # kernel with the true head dim's scale: the padded columns of q, k, v
    # and rows of proj add zeros, so the output is the unpadded one's up to
    # the order of the proj sums (2e-6, float32: 1.1e-6 read).
    rng = np.random.default_rng(5)
    d, heads, depth, pad = 96, 8, 2, 16
    assert vit_block.head_pad("tf32x3", d // heads) == pad

    def w(*shape, std=0.1, base=0.0):
        return torch.from_numpy((base + std * rng.standard_normal(shape))
                                .astype(np.float32))

    blocks = [{"ln1": {"scale": w(d, base=1.0), "bias": w(d)},
               "ln2": {"scale": w(d, base=1.0), "bias": w(d)},
               "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5), "bias": w(3 * d)},
               "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d)},
               "mlp1": {"kernel": w(d, 2 * d, std=d ** -0.5), "bias": w(2 * d)},
               "mlp2": {"kernel": w(2 * d, d, std=(2 * d) ** -0.5),
                        "bias": w(d)}} for _ in range(depth)]
    x = w(2, 21, d, std=1.0)
    flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
    padded = vit_block._pad_heads(vit_block._stack(flat, depth), heads, pad)
    got = emulate_encoder(x, vit_block._blocks_from_flat(
        [t[i] for i in range(depth) for t in padded], depth), heads,
        scale_dh=d // heads)
    want = emulate_encoder(x, blocks, heads)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=2e-6)
