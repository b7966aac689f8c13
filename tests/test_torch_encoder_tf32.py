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


def _products(a, w_hi, w_lo, three=True, chunk=32, wgs=1, parity=True):
    """a @ w as the product kernel takes it: ``chunk`` columns of a (rows
    of w) at a time, the chunk's even 8-deep steps in one fresh accumulator
    and its odd ones in another (``_mma3``), the two added and then added
    to the sum in float32; with ``wgs`` warpgroups, warpgroup w sums chunks
    w, w + wgs, ... and the sums are added at the end; ``chunk=None`` one
    accumulator over all of K (a planted fault: a chain of truncated sums
    as long as K); ``parity=False`` the even and odd steps in one fresh
    accumulator a chunk (a planted fault)."""
    out = torch.zeros(a.shape[:-1] + (w_hi.shape[-1],))
    if chunk is None:
        return _chain(out, a, w_hi, w_lo, three)
    sums = [torch.zeros_like(out) for _ in range(wgs)]
    for n, c0 in enumerate(range(0, a.shape[-1], chunk)):
        parts = [torch.zeros_like(out), torch.zeros_like(out)]
        for step, c in enumerate(range(c0, min(c0 + chunk, a.shape[-1]), 8)):
            e = step % 2 if parity else 0
            parts[e] = _chain(parts[e], a[..., c:c + 8], w_hi[..., c:c + 8, :],
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


# ---------------------------------------------------------------------------
# The widths past the resident form: the prenormed ring (csrc/ring_tf32.cuh)
# against the streamed form it replaced (encoder_tf32.cuh's product_kernel
# with kLnStreamed), emulated
# ---------------------------------------------------------------------------

def _ln_streamed(x, scale, bias, dim):
    """The streamed form's LN output: row_stats_kernel<float>'s (mean, rstd)
    (eight lanes a row; lane c adds, one at a time, the floats before
    ``dim`` of its 16-byte chunks c, c + 8, ... of the row; the lanes' sums
    added as group8_sum's three xor-shuffles add them; the sum over dim,
    1 / sqrt(var + eps)), then load_a_ln's (x - mean) . rstd . scale + bias
    on each element, every operation rounded on its own."""
    k = torch.tensor(float(dim), dtype=F32)

    def lanes(t):
        acc = [torch.zeros(t.shape[:-1], dtype=F32) for _ in range(8)]
        for col in range(dim):
            acc[col // 4 % 8] = acc[col // 4 % 8] + t[..., col]
        s = torch.stack(acc, -1)
        for o in (1, 2, 4):
            s = s + s[..., torch.arange(8) ^ o]
        return s[..., :1]

    mu = lanes(x) / k
    t = x - mu
    rstd = 1.0 / torch.sqrt(lanes(t * t) / k + torch.tensor(1e-6, dtype=F32))
    return (t * rstd) * scale + bias


def emulate_wide(x, flat, depth, heads, dim, form, chosen, three=True,
                 parity=True):
    """The float32 encoder kernel in LN form ``form`` at a width past the
    resident form, block by block: x (B, S, W) zero-padded past ``dim``,
    ``flat`` the blocks' leaves.  ``"prenormed"``: the LN rows written
    once (``vit_block.ln_rows_reference``, the plain version of
    ln_rows_kernel<float>), the weights' planes as the operand cache makes
    them (transposed, K-major), each product's K split where
    ``vit_block._tf32_ring`` deals it to two consumers; ``"streamed"``:
    the LN of ``_ln_streamed`` on every element as it lands, the planes
    (K, N) of ``split_planes`` after the cache's pad, K split where
    product_tf32 gives a product two warpgroups (N tile 16 or 32 at the
    plan's two).  ``chosen``: the plan whose tiles and warpgroups the
    products run at (the tracker's 320 tokens); the attention at its
    warpgroups."""
    b, s, w = x.shape
    d = flat[0].shape[0]
    ops = vit_block._operands(flat, depth, F32, heads)
    if form == "streamed":
        stacked = vit_block._pad_width(vit_block._stack(flat, depth), w,
                                       ops[9].shape[-1])
        planes = vit_block.split_planes(stacked)
    else:
        planes = [t.transpose(-1, -2) if i in vit_block._KERNELS else t
                  for i, t in enumerate(ops)]
    dh = ops[3].shape[-1] // (3 * heads)

    def split_k(tile):
        if form == "prenormed":
            return 2 if vit_block._tf32_ring(tile, chosen.warpgroups)[2] else 1
        return 1 if tile == 64 else chosen.warpgroups

    wgs = [split_k(t) for t in chosen.tiles]

    def linear(a, i, n):
        return _products(a, planes[i][n, 0], planes[i][n, 1], three, 32,
                         wgs[vit_block._KERNELS.index(i)], parity) \
            + planes[i + 1][n]

    def ln(t, n, j):
        if form == "prenormed":
            return vit_block.ln_rows_reference(t, planes[j][n],
                                               planes[j + 1][n], dim)
        return _ln_streamed(t, planes[j][n], planes[j + 1][n], dim)

    def heads_of(t):
        return t.reshape(b, s, heads, dh).transpose(1, 2).reshape(
            b * heads, s, dh)

    for n in range(depth):
        q, k, v = torch.chunk(linear(ln(x, n, 0), 2, n), 3, -1)
        a = _attention(heads_of(q), heads_of(k), heads_of(v), three,
                       d // heads, chosen.warpgroups)
        a = a.reshape(b, heads, s, dh).transpose(1, 2).reshape(b, s, heads * dh)
        x = x + linear(a, 4, n)
        g = F.gelu(linear(ln(x, n, 6), 8, n), approximate="tanh")
        x = x + linear(g, 10, n)
    return x


def _wide_case(dim, heads, depth=1, tokens=8):
    """Seeded float32 blocks of width ``dim`` (MLP 4 dim) and tokens from
    numpy, the torch leaves and JAX's arrays of the same numbers."""
    rng = np.random.default_rng(dim)

    def w(*shape, std=0.1, base=0.0):
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    h = 4 * dim
    blocks = [{"ln1": {"scale": w(dim, base=1.0), "bias": w(dim)},
               "ln2": {"scale": w(dim, base=1.0), "bias": w(dim)},
               "qkv": {"kernel": w(dim, 3 * dim, std=dim ** -0.5),
                       "bias": w(3 * dim)},
               "proj": {"kernel": w(dim, dim, std=dim ** -0.5), "bias": w(dim)},
               "mlp1": {"kernel": w(dim, h, std=dim ** -0.5), "bias": w(h)},
               "mlp2": {"kernel": w(h, dim, std=h ** -0.5), "bias": w(dim)}}
              for _ in range(depth)]
    x = w(1, tokens, dim, std=1.0)
    tblocks = [{m: {f: torch.from_numpy(a) for f, a in leaves.items()}
                for m, leaves in p.items()} for p in blocks]
    jblocks = [{m: {f: jnp.asarray(a) for f, a in leaves.items()}
                for m, leaves in p.items()} for p in blocks]
    return tblocks, torch.from_numpy(x), jblocks, jnp.asarray(x)


# The prenormed emulation against the port's twin and JAX's
# encoder_reference at D 1024 (16 heads of 64) and at D 992 (31 heads of
# 32, run at a residual width of 1024), one block, 8 tokens, at the plan of
# the tracker's 320 tokens at batch 1 (N tiles (64, 32, 64, 32), two
# warpgroups: proj's and mlp2's K dealt to two consumers).
WIDE_DIMS = [(1024, 16), (992, 31)]


@pytest.fixture(scope="module")
def wide_emulations():
    """Per width: (blocks, x, the twin, JAX's reference, the plan, the
    streamed and prenormed emulations)."""
    out = {}
    for dim, heads in WIDE_DIMS:
        blocks, x, jblocks, jx = _wide_case(dim, heads)
        chosen = vit_block.plan(1, 320, dim, heads, 4 * dim, F32, H100_SMS)
        flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
        xp = F.pad(x, (0, (chosen.width or dim) - dim))
        emu = {form: emulate_wide(xp, flat, 1, heads, dim, form, chosen)
               for form in ("streamed", "prenormed")}
        out[dim] = (flat, xp, heads, chosen,
                    vit_block.encoder_reference(x, blocks, heads),
                    np.asarray(jvb.encoder_reference(jx, jblocks, heads)), emu)
    return out


@pytest.mark.parametrize("dim,heads", WIDE_DIMS)
def test_prenormed_emulation_equals_the_streamed_one(wide_emulations, dim,
                                                     heads):
    # The LN rows written once and the ring's K split give the streamed
    # form's outputs bit for bit (what the card's digests of ViT-L, ViT-H
    # and Model A hold), and both are the twin's and JAX's to the float32
    # bounds.
    flat, xp, heads, chosen, twin, jref, emu = wide_emulations[dim]
    # Two warpgroups at D 1024 (80 attention CTAs on 132 SMs); 155 at D 992.
    assert (chosen.ln, chosen.tiles, chosen.warpgroups) == (
        "prenormed", (64, 32, 64, 32), {1024: 2, 992: 1}[dim])
    assert torch.equal(emu["prenormed"], emu["streamed"])
    assert not emu["prenormed"][..., dim:].any()
    got = emu["prenormed"][..., :dim]
    for ref in (twin.numpy(), jref):
        d = float(np.abs(got.numpy() - ref).max())
        assert d <= F32_ATOL and d / np.abs(ref).max() <= EMU_REL_TOL, d


@pytest.mark.parametrize("fault", ["single", "merged"])
def test_prenormed_planted_faults_are_caught(wide_emulations, fault):
    # A single TF32 product (hi.hi alone) or the chunk's even and odd steps
    # in one fresh accumulator: no longer the streamed form's bits (the
    # card's digests), and the single product is also past the bound.
    flat, xp, heads, chosen, twin, jref, emu = wide_emulations[1024]
    got = emulate_wide(xp, flat, 1, heads, 1024, "prenormed", chosen,
                       three=fault != "single", parity=fault != "merged")
    assert not torch.equal(got, emu["streamed"])
    d = float((got - twin).abs().max())
    if fault == "single":
        assert d > F32_ATOL, d


def test_ln_rows_plain_version_equals_the_streamed_ln_in_float32():
    # ln_rows_kernel<float>'s plain version is the streamed form's LN (its
    # statistics, then layer_norm1 on each element) bit for bit, at D 1024
    # and at D 992 in a residual width of 1024 (zero past D).
    for dim, width in ((1024, 1024), (992, 1024), (1280, 1280)):
        gen = torch.Generator().manual_seed(dim)
        x = 3.0 * torch.randn((2, 5, width), generator=gen) + 0.5
        x[..., dim:] = 0.0
        s = F.pad(1.0 + 0.1 * torch.randn(dim, generator=gen), (0, width - dim))
        b = F.pad(0.1 * torch.randn(dim, generator=gen), (0, width - dim))
        got = vit_block.ln_rows_reference(x, s, b, dim)
        assert got.dtype == F32
        assert torch.equal(got, _ln_streamed(x, s, b, dim))
        assert not got[..., dim:].any()


def test_transposed_planes_of_the_operand_cache():
    # Past a residual width of 544 the cache lays each kernel's planes out
    # transposed ((depth, 2, out, in)), bit for bit split_tf32 of the
    # padded kernel; up to it as before.
    gen = torch.Generator().manual_seed(7)
    d, heads, hidden, depth = 576, 9, 96, 2
    shapes = [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, hidden), (hidden,), (hidden, d), (d,)]
    flat = [torch.randn(s, generator=gen) for _ in range(depth) for s in shapes]
    ops = vit_block._operands(flat, depth, F32, heads)
    stacked = vit_block._stack(flat, depth)
    for i in vit_block._KERNELS:
        hi, lo = vit_block.split_tf32(stacked[i])
        assert ops[i].shape == (depth, 2) + stacked[i].shape[:0:-1]
        assert torch.equal(ops[i][:, 0], hi.transpose(-1, -2))
        assert torch.equal(ops[i][:, 1], lo.transpose(-1, -2))
        assert ops[i].is_contiguous()
    # The split layout follows the form a named plan reads.
    assert vit_block._split_layout(ops, False, d)[2].shape == (depth, 2, d, 3 * d)
    assert vit_block._split_layout(ops, True, d)[2] is ops[2]


def test_block_wrapper_builds_its_operands_once():
    # Kernel 2's wrapper on the card takes one block's weights from the
    # operand cache: a second call with the same leaves builds nothing; an
    # in-place update builds them anew; a gradient bypasses the cache.
    gen = torch.Generator().manual_seed(8)
    d, hidden, heads = 576, 128, 9
    shapes = [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, hidden), (hidden,), (hidden, d), (d,)]
    flat = [torch.randn(s, generator=gen) for s in shapes]
    x = torch.zeros((2, 5, d))
    built = []
    real = vit_block.split_planes

    def counted(*args, **kwargs):
        built.append(1)
        return real(*args, **kwargs)

    vit_block.split_planes = counted
    try:
        a = vit_block._block_operands(x, flat, heads)
        assert vit_block._block_operands(x, flat, heads) is a
        assert len(built) == 1
        assert [tuple(t.shape) for t in a][2] == (2, 3 * d, d)
        with torch.no_grad():
            flat[4].add_(1.0)
        assert vit_block._block_operands(x, flat, heads) is not a
        assert len(built) == 2
        grad = [t.clone().requires_grad_(True) for t in flat]
        assert vit_block._block_operands(x, grad, heads) is None
    finally:
        vit_block.split_planes = real


def test_profile_float32_cut_rewrites_find_their_statements():
    # profile_encoder.py's float32 cut builds rewrite statements of
    # csrc/ring_tf32.cuh in a copy; each must stand there once (the builds
    # raise on the card otherwise).
    from gstreamer_vit_tracker_tpu_torch import profile_encoder as pe

    with open(f"{pe.cuda_build.CSRC}/ring_tf32.cuh") as f:
        src = f.read()
    for old, new in pe._CUT_TF32.values():
        assert src.count(old) == 1 and old != new, old


@pytest.mark.parametrize("name,value", [
    ("kTwoCtaBytes", vit_block.attention._TWO_CTA_BYTES),
    ("kOneCtaBytes", vit_block.H100_OPTIN),
    ("kMaxStages", vit_block._TF32_RING_MAX_STAGES),
    ("kChunk", vit_block._TF32_CHUNK), ("kRows", vit_block._ROWS)])
def test_ring_geometry_constants_are_the_sources(name, value):
    # ln_smem_bytes's mirror of the float32 ring's shared memory (the plan's
    # fit and the forms a caller may name) rests on these constants of
    # csrc/ring_tf32.cuh.
    import re

    with open(f"{vit_block.cuda_build.CSRC}/ring_tf32.cuh") as f:
        assert int(re.search(rf"{name} = (\d+);", f.read()).group(1)) == value
