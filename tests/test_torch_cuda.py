"""PyTorch port on an NVIDIA GPU: the CUDA encoder kernel against its
plain twin, its input checks, its launch count, its backward, and the
tracking step on the card against the same step on the CPU; the two
attention kernels against ``attention_reference`` (both variants, every
built configuration), their dispatch by length, dtype and head dim, the
strided entry, input checks, launch counts and backward; the per-block encode
route and a batched engine tick on the card against the CPU; the one-block
kernel (``vit_block.block``) and the NV12-to-tokens kernel
(``fused_prep_embed.nv12_search_tokens``) against their plain versions, with
their input checks, launch counts and (for the block) gradients; head dims
that no variant takes as they are, zero-padded, in attention and both
encoder entries against the plain twin; the NV12-to-tokens kernel's
float32 variants (``tf32x3`` by plan, ``simt`` by name) at the three
presets' shapes and its padded embed widths in both dtypes; one
``nv12_search_tokens`` call as one device activity; the tracking step
through ``fused_prep``, RGB and YUY2 steps, and a training step on the card
against the CPU.

Every test here needs a card and skips without one (marker ``cuda``).
Run them on the GPU with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
conftest imports JAX, which the GPU machine need not have).
Float32 products and convolutions run without TF32 (set by the fixture).
Tolerances: float32 1e-4; bf16 2% of the largest twin value (one bf16 ulp
at the top of a binade is 0.8% of it, and the kernel sums in another order
than the twin).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu_torch import profile_prep  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.train import step as train_step_mod  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _blocks(gen, d, depth, hidden, dtype, dev):
    def w(*shape, std=0.1, base=0.0):
        return (base + std * torch.randn(shape, generator=gen)).to(dev, dtype)

    return [{
        "ln1": {"scale": w(d, base=1.0), "bias": w(d)},
        "ln2": {"scale": w(d, base=1.0), "bias": w(d)},
        "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5), "bias": w(3 * d)},
        "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d)},
        "mlp1": {"kernel": w(d, hidden, std=d ** -0.5), "bias": w(hidden)},
        "mlp2": {"kernel": w(hidden, d, std=hidden ** -0.5), "bias": w(d)},
    } for _ in range(depth)]


def _check_close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert err <= 0.02 * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,heads", [(1, 320, 192, 3), (2, 37, 64, 4),
                                         (1, 80, 96, 2), (1, 65, 256, 2),
                                         (3, 16, 32, 2)])
def test_encoder_kernel_matches_twin(dev, dtype, b, s, d, heads):
    gen = torch.Generator().manual_seed(s * d + heads)
    blocks = _blocks(gen, d, 3, 4 * d, dtype, dev)
    x = torch.randn((b, s, d), generator=gen).to(dev, dtype)
    before = vit_block.LAUNCHES
    if dtype == torch.bfloat16 and vit_block._refusal("mma", d, heads, 4 * d):
        # bf16 is the mma variant's alone: a width it does not take raises
        # (a head dim it does not take as it is runs padded).
        with pytest.raises(ValueError, match="cannot take"):
            vit_block.encoder(x, blocks, heads)
        assert vit_block.LAUNCHES == before
        return
    got = vit_block.encoder(x, blocks, heads)
    assert vit_block.LAUNCHES == before + 1
    ref = vit_block.encoder_reference(x, blocks, heads)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == dtype
    _check_close(got, ref, dtype)


def test_encoder_kernel_rejects_what_it_cannot_take(dev):
    # A head dim above 128 runs in panels (136 in float32 as it is, through
    # the wrapper and an explicit launch alike); simt by name stops at 128
    # and raises; nothing on the card goes to the plain twin.  A head dim
    # the variant does not take as it is (4 in float32: tf32x3) runs
    # padded (to 8).  A
    # strided x is copied and launched.  A dtype, or weights that do not fit
    # x, raise; masters in another dtype are cast.
    gen = torch.Generator().manual_seed(0)
    blocks = _blocks(gen, 64, 1, 256, torch.float32, dev)
    x = torch.randn((1, 20, 64), generator=gen).to(dev)
    wide_blocks = _blocks(gen, 136, 1, 256, torch.float32, dev)
    x136 = torch.randn((1, 20, 136), generator=gen).to(dev)
    stacked = vit_block._stack([wide_blocks[0][m][f] for m, f in vit_block._FIELDS], 1)
    with pytest.raises(TypeError):
        vit_block.encoder(x.half(), blocks, 2)
    before = vit_block.LAUNCHES
    _check_close(vit_block.encoder(x136, wide_blocks, 1),         # dh = 136
                 vit_block.encoder_reference(x136, wide_blocks, 1), torch.float32)
    _check_close(vit_block._launch(x136, stacked, 1, stacked=True),
                 vit_block.encoder_reference(x136, wide_blocks, 1), torch.float32)
    assert vit_block.LAUNCHES == before + 2
    with pytest.raises(ValueError, match="simt takes head dims up to 128"):
        vit_block.prepared(x136, stacked, 1, True, chosen=vit_block.Plan("simt"))
    assert vit_block.LAUNCHES == before + 2
    before = vit_block.LAUNCHES
    _check_close(vit_block.encoder(x, blocks, 16),                # dh = 4 -> 8
                 vit_block.encoder_reference(x, blocks, 16), torch.float32)
    assert vit_block.LAUNCHES == before + 1
    before = vit_block.LAUNCHES
    wide = torch.randn((1, 40, 64), generator=gen).to(dev)
    got = vit_block.encoder(wide[:, ::2], blocks, 2)
    assert vit_block.LAUNCHES == before + 1
    assert torch.equal(got, vit_block.encoder(wide[:, ::2].contiguous(), blocks, 2))
    _check_close(got, vit_block.encoder_reference(wide[:, ::2], blocks, 2),
                 torch.float32)
    cast = [{m: {f: t.bfloat16() for f, t in l.items()} for m, l in blocks[0].items()}]
    assert torch.equal(vit_block.encoder(x.bfloat16(), blocks, 2),  # f32 masters
                       vit_block.encoder(x.bfloat16(), cast, 2))
    bad = [dict(blocks[0], proj={"kernel": blocks[0]["proj"]["kernel"][:, :32],
                                 "bias": blocks[0]["proj"]["bias"]})]
    with pytest.raises(ValueError, match="kernel expects"):
        vit_block.encoder(x, bad, 2)


@pytest.mark.parametrize("s,d,heads,dtype", [(4096, 128, 1, torch.float32),
                                             (1088, 192, 3, torch.bfloat16)])
def test_encoder_kernel_takes_any_sequence_length(dev, s, d, heads, dtype):
    # Every variant walks the keys through a ring of fixed size: no length
    # needs more shared memory (these raised before).
    gen = torch.Generator().manual_seed(s)
    blocks = _blocks(gen, d, 2, 4 * d, dtype, dev)
    x = torch.randn((1, s, d), generator=gen).to(dev, dtype)
    before = dict(vit_block.VARIANT_LAUNCHES)
    got = vit_block.encoder(x, blocks, heads)
    variant = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert vit_block.VARIANT_LAUNCHES[variant] == before[variant] + 1
    ref = vit_block.encoder_reference(x, blocks, heads)
    torch.cuda.synchronize()
    _check_close(got, ref, dtype)


def test_encoder_kernel_backward_is_the_twins(dev):
    gen = torch.Generator().manual_seed(5)
    blocks = _blocks(gen, 64, 2, 256, torch.float32, dev)
    for p in blocks:
        for mod in p.values():
            for t in mod.values():
                t.requires_grad_(True)
    x = torch.randn((1, 37, 64), generator=gen).to(dev).requires_grad_(True)
    leaves = [x] + [t for p in blocks for mod in p.values() for t in mod.values()]
    g_k = torch.autograd.grad((vit_block.encoder(x, blocks, 2) ** 2).sum(), leaves)
    g_r = torch.autograd.grad(
        (vit_block.encoder_reference(x, blocks, 2) ** 2).sum(), leaves)
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def _clip(n):
    rng = np.random.default_rng(1)
    frames = []
    for t in range(n):
        y = rng.integers(40, 90, (1080, 1920), dtype=np.uint8)
        y[400 + 2 * t:480 + 2 * t, 800 + 3 * t:896 + 3 * t] = 230
        uv = np.full((540, 960, 2), 128, np.uint8)
        frames.append((y, uv))
    return frames, (800.0, 400.0, 96.0, 80.0)


def _seeded_params(cfg, seed, d):
    """Seeded random weights at ``cfg``'s width on device ``d``: scales 1,
    biases 0, kernels N(0, min(0.02, fan_in^-1/2))."""
    rng = np.random.default_rng(seed)
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        elif prefix.endswith("/scale/"):
            flat[prefix[:-1]] = np.ones(tree, np.float32)
        elif prefix.endswith("/bias/"):
            flat[prefix[:-1]] = np.zeros(tree, np.float32)
        else:
            fan_in = int(np.prod(tree[:-1])) or 1
            flat[prefix[:-1]] = (rng.standard_normal(tree)
                                 * min(0.02, fan_in ** -0.5)).astype(np.float32)

    walk(weights.param_shapes(cfg), "")
    return vittrack.with_grouped_head(weights.params_from_flat(flat, cfg, device=d))


@pytest.mark.parametrize("preset,search", [("vittrack-t", 512), ("small", 384)])
def test_long_unbatched_update_on_card_matches_cpu(dev, preset, search):
    # An unbatched step past the old shared-memory limit (S = 1088 at the
    # flagship's width, 592 at small's f32 width) through the encoder
    # kernel, against the same steps on the CPU, seeded weights.
    cfg = dataclasses.replace(PRESETS[preset], search_size=search)
    frames, bbox = _clip(3)
    out = {}
    for d in (dev, torch.device("cpu")):
        params = _seeded_params(cfg, 7, d)
        st = core.init(params, frames[0], bbox, cfg, device=d,
                       frame_format="nv12")
        before = vit_block.LAUNCHES
        rows = []
        for f in frames[1:]:
            st, packed = core.update_packed(params, st, f, cfg, device=d,
                                            frame_format="nv12")
            rows.append(packed.cpu())
        assert vit_block.LAUNCHES - before == (2 if d.type == "cuda" else 0)
        out[d.type] = torch.stack(rows)
    assert torch.isfinite(out["cuda"]).all()
    if cfg.dtype == "float32":
        torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-2)
    else:
        assert (out["cuda"][:, 4] - out["cpu"][:, 4]).abs().max() <= 0.02
        assert (out["cuda"][:, :4] - out["cpu"][:, :4]).abs().max() <= 2.0


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
def test_update_on_card_matches_cpu(dev, preset):
    cfg = PRESETS[preset]
    frames, bbox = _clip(4)
    out = {}
    for d in (dev, torch.device("cpu")):
        params = vittrack.with_grouped_head(weights.load_npz(
            weights.checkpoint_path(preset), cfg, device=d))
        st = core.init(params, frames[0], bbox, cfg, device=d,
                       frame_format="nv12")
        rows = []
        for f in frames[1:]:
            st, packed = core.update_packed(params, st, f, cfg, device=d,
                                            frame_format="nv12")
            rows.append(packed.cpu())
        out[d.type] = torch.stack(rows)
    if cfg.dtype == "float32":
        torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-2)
    else:
        assert (out["cuda"][:, 4] - out["cpu"][:, 4]).abs().max() <= 0.02
        assert (out["cuda"][:, :4] - out["cpu"][:, :4]).abs().max() <= 2.0


# ---------------------------------------------------------------------------
# Attention kernels (csrc/attention.cu)
# ---------------------------------------------------------------------------

def _qkv(bh, s, dh, dtype, dev, seed=0, v_scale=1.0):
    gen = torch.Generator().manual_seed(seed + 7 * s + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=gen) for _ in range(3))
    return tuple(t.to(dev, dtype) for t in (q, k, v_scale * v))


def _check_attention(got, ref, dtype):
    """float32: 1e-5 absolute.  bf16: one output ulp at the largest
    reference value (2^-7 of it: both sides round an f32 result once)."""
    assert got.shape == ref.shape and got.dtype == dtype
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * ref.abs().max().item()
    assert err <= tol, (err, tol)


# (batch*heads, S, dh, the kernel flash_attention takes in float32, in bf16):
# float32 (the tf32x3 variant) holds K and V of all keys as float32 rows
# twice an SM, bf16 at head dim 32, 64 or 128 (the mma variant) as bf16, so
# the serving shape is whole-sequence in bf16 and blocked in float32.
ATTENTION_SHAPES = [
    (48, 320, 64, "flash", "single"), (2, 128, 64, "single", "single"),
    (3, 200, 32, "single", "single"), (4, 80, 48, "single", "single"),
    (2, 1, 8, "single", "single"), (5, 33, 128, "single", "single"),
    (3, 1088, 64, "flash", "flash"), (1, 1200, 32, "flash", "flash"),
    (2, 777, 128, "flash", "flash"), (1, 4099, 8, "flash", "flash")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,dh,route32,route16", ATTENTION_SHAPES)
def test_attention_kernels_match_reference(dev, dtype, bh, s, dh, route32,
                                           route16):
    route = route32 if dtype == torch.float32 else route16
    q, k, v = _qkv(bh, s, dh, dtype, dev)
    assert attention.kernel_route(q) == route
    assert attention.kernel_variant(q) == (
        "tf32x3" if dtype == torch.float32 else "mma")
    before = (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES)
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES)
    assert after == ((before[0] + 1, before[1]) if route == "single"
                     else (before[0], before[1] + 1))
    _check_attention(got, attention.attention_reference(q, k, v), dtype)


def _configurations(s, dh, optin):
    """Every built configuration of both variants that takes bf16 at this
    shape on a card with ``optin`` bytes of opt-in shared memory (``mma``
    at a head dim its tiles do not take: zero-padded, as named plans are)."""
    plans = [attention.Plan("single", "simt"), attention.Plan("flash", "simt")]
    plans += [attention.Plan("single", "mma", kb) for kb in (64, 128)]
    plans += [attention.Plan("flash", "mma", kb, st, wg)
              for kb in (64, 128) for st, wg in ((2, 1), (2, 2), (3, 1))]
    return [p for p in plans if attention.smem_bytes(
        p.route, p.variant, s, attention.variant_pad(p.variant, dh) or dh, 2,
        p.kb, p.stages, p.warpgroups) <= optin]


@pytest.mark.parametrize("bh,s,dh", [c[:3] for c in ATTENTION_SHAPES])
def test_attention_both_variants_match_reference(dev, bh, s, dh):
    # The rule takes one configuration a shape; every one that is built and
    # fits must compute the same function (profile_attention.py times them).
    q, k, v = _qkv(bh, s, dh, torch.bfloat16, dev)
    ref = attention.attention_reference(q, k, v)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    plans = _configurations(s, dh, optin)
    assert any(p.variant == "simt" for p in plans)
    assert any(p.variant == "mma" for p in plans)
    for p in plans:
        got = attention._launch(q, k, v, 1, p)
        torch.cuda.synchronize()
        _check_attention(got, ref, torch.bfloat16)


@pytest.mark.parametrize("bh,s,dh", [c[:3] for c in ATTENTION_SHAPES])
def test_attention_f32_variants_match_reference(dev, bh, s, dh):
    # float32 takes tf32x3; the simt design it replaced stays reachable by
    # name.  Every configuration of both that fits computes the function to
    # 1e-5.
    q, k, v = _qkv(bh, s, dh, torch.float32, dev)
    ref = attention.attention_reference(q, k, v)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    plans = [attention.Plan("single", "tf32x3", 64),
             attention.Plan("flash", "tf32x3", 64, 2),
             attention.Plan("single", "simt"), attention.Plan("flash", "simt")]
    plans = [p for p in plans if attention.smem_bytes(
        p.route, p.variant, s, dh, 4, p.kb, p.stages, p.warpgroups) <= optin]
    assert attention.Plan("flash", "tf32x3", 64, 2) in plans
    for p in plans:
        got = attention._launch(q, k, v, 1, p)
        torch.cuda.synchronize()
        _check_attention(got, ref, torch.float32)


def test_kernel_variant_follows_dtype_and_head_dim(dev):
    for dh, dtype, want in ((64, torch.bfloat16, "mma"), (32, torch.bfloat16, "mma"),
                            (128, torch.bfloat16, "mma"), (48, torch.bfloat16, "mma"),
                            (8, torch.bfloat16, "mma"), (64, torch.float32, "tf32x3"),
                            (48, torch.float32, "tf32x3")):
        q = torch.zeros((2, 40, 3 * dh), device=dev, dtype=dtype)
        assert attention.kernel_variant(q, num_heads=3) == want
        assert attention.kernel_variant(q[..., :dh]) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,heads", [(16, 320, 192, 3), (2, 37, 128, 4),
                                         (1, 1088, 192, 3), (3, 777, 64, 2)])
def test_strided_entry_equals_the_contiguous_one(dev, dtype, b, s, d, heads):
    # q, k, v as the three column blocks of one qkv buffer, read in place,
    # against contiguous per-head copies through flash_attention: bit for bit.
    gen = torch.Generator().manual_seed(s + d)
    qkv = torch.randn((b, s, 3 * d), generator=gen).to(dev, dtype)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
    got = attention.multihead_attention(q, k, v, heads)
    assert attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES == before + 1
    assert got.shape == (b, s, d) and got.is_contiguous()
    dh = d // heads
    qh, kh, vh = (x.reshape(b, s, heads, dh).transpose(1, 2)
                  .reshape(b * heads, s, dh).contiguous() for x in (q, k, v))
    # Same plan on both sides: the copies have the same batch x heads.
    want = attention.flash_attention(qh, kh, vh)
    want = want.reshape(b, heads, s, dh).transpose(1, 2).reshape(b, s, d)
    assert torch.equal(got, want)
    _check_attention(got, attention.multihead_attention(
        q, k, v, heads, use_kernel=False), dtype)


def test_misaligned_operands_raise(dev):
    # Operands the kernels cannot read in place do not raise and do not go
    # to the plain version: they are copied into contiguous ones and the
    # kernel launches, by default and with use_kernel=True alike, bit for bit
    # what it gives on the contiguous copies.
    gen = torch.Generator().manual_seed(4)
    base = torch.randn((2, 40, 72), generator=gen).to(dev, torch.bfloat16)
    good = base[..., :64].contiguous()
    for bad in (base[..., 4:68],                       # base off by 8 bytes
                torch.randn((2, 40, 68), generator=gen).to(  # row stride 136 bytes
                    dev, torch.bfloat16)[..., :64],
                good.transpose(1, 2).contiguous().transpose(1, 2)):
        assert not attention._aligned(bad)
        want = attention.flash_attention(bad.contiguous(), good, good)
        want2 = attention.multihead_attention(good, good, bad.contiguous(), 1)
        before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
        got = attention.flash_attention(bad, good, good)
        got2 = attention.multihead_attention(good, good, bad, 1)
        got3 = attention.multihead_attention(good, good, bad, 1, use_kernel=True)
        assert attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES == before + 3
        assert torch.equal(got, want)
        assert torch.equal(got2, want2) and torch.equal(got3, want2)
        _check_attention(got, attention.attention_reference(bad, good, good),
                         torch.bfloat16)


def test_attention_large_values_bf16_zero_filled_tail(dev):
    # v scaled by 100: keys past S are zeros in shared memory and -inf in the
    # scores, so nothing of a ragged last block (320 = 5 x 64, 777 and 1088
    # are no multiples of 128) leaks into the sums.
    for s in (320, 777, 1088):
        q, k, v = _qkv(3, s, 64, torch.bfloat16, dev, v_scale=100.0)
        assert attention.kernel_variant(q) == "mma"
        _check_attention(attention.flash_attention(q, k, v),
                         attention.attention_reference(q, k, v),
                         torch.bfloat16)


def test_attention_large_values_do_not_leak_across_blocks(dev):
    # v scaled by 100 as tests/test_attention.py::test_flash_padding_does_not_leak
    # does: a wrong tail or a wrong rescaling shows at once.
    for s in (320, 1088):
        q, k, v = _qkv(2, s, 64, torch.float32, dev, v_scale=100.0)
        got = attention.flash_attention(q, k, v)
        ref = attention.attention_reference(q, k, v)
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-3)


def test_multihead_attention_on_card(dev):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 37, 96), generator=gen).to(dev) for _ in range(3))
    before = attention.SINGLE_LAUNCHES
    got = attention.multihead_attention(q, k, v, 2)          # None -> kernel
    assert attention.SINGLE_LAUNCHES == before + 1
    plain = attention.multihead_attention(q, k, v, 2, use_kernel=False)
    assert attention.SINGLE_LAUNCHES == before + 1           # plain: no launch
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)


def test_attention_kernels_reject_what_they_cannot_take(dev):
    q, k, v = _qkv(2, 16, 64, torch.float32, dev)
    with pytest.raises(TypeError):
        attention.flash_attention(q.half(), k.half(), v.half())
    # Head dim 136 runs in panels (float32 as it is); simt by name stops at
    # 128 and raises before any launch.
    q136, k136, v136 = _qkv(2, 16, 136, torch.float32, dev)
    before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
    _check_attention(attention.multihead_attention(q136, k136, v136, 1,
                                                   use_kernel=True),
                     attention.attention_reference(q136, k136, v136), torch.float32)
    _check_attention(attention.flash_attention(q136, k136, v136),
                     attention.attention_reference(q136, k136, v136), torch.float32)
    with pytest.raises(ValueError, match="simt takes head dims"):
        attention.prepared(q136, k136, v136, 1,
                           chosen=attention.Plan("flash", "simt"))
    assert attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES == before + 2
    before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
    # Head dim 12 runs padded to 16.
    q12, k12, v12 = (t[..., :12] for t in (q, k, v))
    _check_attention(attention.multihead_attention(q12, k12, v12, 1),
                     attention.attention_reference(q12, k12, v12), torch.float32)
    assert attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES == before + 1
    with pytest.raises(ValueError, match="expected"):
        attention.flash_attention(q, k[:, :8], v)
    with pytest.raises(ValueError, match="use_kernel=True"):
        attention.multihead_attention(q.cpu(), k.cpu(), v.cpu(), 2,
                                      use_kernel=True)


def test_attention_backward_is_the_references(dev):
    q, k, v = (t.requires_grad_(True)
               for t in _qkv(2, 45, 32, torch.float32, dev))
    g_k = torch.autograd.grad((attention.flash_attention(q, k, v) ** 2).sum(),
                              (q, k, v))
    g_r = torch.autograd.grad(
        (attention.attention_reference(q, k, v) ** 2).sum(), (q, k, v))
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_encoder_twin_stays_plain_on_card(dev):
    gen = torch.Generator().manual_seed(2)
    blocks = _blocks(gen, 64, 2, 256, torch.float32, dev)
    x = torch.randn((2, 20, 64), generator=gen).to(dev)
    before = (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES,
              vit_block.LAUNCHES)
    vit_block.encoder_reference(x, blocks, 2)
    assert before == (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES,
                      vit_block.LAUNCHES)


# ---------------------------------------------------------------------------
# The batched path on the card against the CPU
# ---------------------------------------------------------------------------

def test_encode_per_block_route_on_card(dev):
    from gstreamer_vit_tracker_tpu_torch.models import vit

    cfg = PRESETS["small"]
    gen = torch.Generator().manual_seed(9)
    z = torch.randn((4, cfg.num_template_tokens, cfg.embed_dim), generator=gen)
    x = torch.randn((4, cfg.num_search_tokens, cfg.embed_dim), generator=gen)
    out = {}
    for d in (dev, torch.device("cpu")):
        bb = weights.load_npz(weights.checkpoint_path("small"), cfg,
                              device=d)["backbone"]
        before = attention.SINGLE_LAUNCHES
        out[d.type] = vit.encode(bb, z.to(d), x.to(d), cfg, fused=False).cpu()
        launched = attention.SINGLE_LAUNCHES - before
        assert launched == (cfg.depth if d.type == "cuda" else 0)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


def test_engine_ticks_on_card_match_cpu(dev):
    from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine

    cfg = PRESETS["small"]
    frames, bbox = _clip(4)
    rows = {}
    for d in (dev, torch.device("cpu")):
        params = weights.load_npz(weights.checkpoint_path("small"), cfg,
                                  device=d)
        eng = SlotEngine(params, cfg, slots=3, snapshot_every=0, device=d)
        for _ in range(2):
            eng.init_slot(eng.alloc(), frames[0], bbox)
        ticks = [eng.step_async(
            (np.stack([f[0]] * 3), np.stack([f[1]] * 3)),
            np.array([True, i % 2 == 0, True])) for i, f in enumerate(frames[1:])]
        rows[d.type] = np.stack([np.asarray(t) for t in ticks])
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=0, atol=1e-2)
    assert not rows["cuda"][:, 2].any()              # the unoccupied slot


# ---------------------------------------------------------------------------
# The one-block kernel (vit_block.block)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,heads", [(1, 320, 192, 3), (16, 320, 192, 3),
                                         (2, 80, 96, 2), (3, 37, 64, 4)])
def test_block_kernel_matches_twin(dev, dtype, b, s, d, heads):
    gen = torch.Generator().manual_seed(b * s + d)
    blk = _blocks(gen, d, 1, 4 * d, dtype, dev)[0]
    x = torch.randn((b, s, d), generator=gen).to(dev, dtype)
    before = (vit_block.BLOCK_LAUNCHES, vit_block.LAUNCHES,
              attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES)
    if dtype == torch.bfloat16 and vit_block._refusal("mma", d, heads, 4 * d):
        # bf16 is the mma variant's alone: a width it does not take raises
        # (a head dim it does not take as it is runs padded).
        with pytest.raises(ValueError, match="cannot take"):
            vit_block.block(x, blk, heads)
        assert vit_block.BLOCK_LAUNCHES == before[0]
        return
    got = vit_block.block(x, blk, heads)
    assert vit_block.BLOCK_LAUNCHES == before[0] + 1
    ref = vit_block.block_reference(x, blk, heads)
    torch.cuda.synchronize()
    # Neither the wrapper nor the twin went through another kernel.
    assert (vit_block.BLOCK_LAUNCHES, vit_block.LAUNCHES,
            attention.SINGLE_LAUNCHES,
            attention.FLASH_LAUNCHES) == (before[0] + 1, *before[1:])
    assert got.shape == x.shape and got.dtype == dtype
    _check_close(got, ref, dtype)
    # One block of the encoder kernel is the same device code.
    assert torch.equal(got, vit_block.encoder(x, [blk], heads))
    want = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert vit_block._plan_for(x, heads, 4 * d).variant == want


def test_flagship_shapes_take_mma_and_no_plain_route(dev):
    for b in (1, 16):
        x = torch.zeros((b, 320, 192), device=dev, dtype=torch.bfloat16)
        got = vit_block._plan_for(x, 3, 768)
        assert got.variant == "mma"
        assert got.tiles == ((32,) * 4 if b == 1 else (64,) * 4)


@pytest.mark.parametrize("b,s,d,heads,depth", [
    (1, 80, 96, 2, 4),      # the small preset's unbatched encode
    (1, 320, 192, 3, 12),   # the flagship in float32 (DRYRUN_CFG's width)
    (4, 20, 32, 2, 2),      # the dry run's serving model: dh 16
    (16, 80, 96, 2, 1),     # kernel 2 at the small preset's batch
    (2, 100, 64, 1, 2)])    # head dim 64 with a ragged last key block
def test_tf32x3_matches_twin_and_counts(dev, b, s, d, heads, depth):
    # Every float32 shape tf32x3 takes launches it, once a call through
    # either entry, and holds the twin to 1e-4, at the plan's tiles and
    # warpgroups and at the other count; simt, by name on the same operands,
    # holds it too; a chain of block calls equals the encoder call bit for
    # bit (the plan depends on the shape alone).
    gen = torch.Generator().manual_seed(b * s + d)
    blocks = _blocks(gen, d, depth, 4 * d, torch.float32, dev)
    x = torch.randn((b, s, d), generator=gen).to(dev)
    chosen = vit_block._plan_for(x, heads, 4 * d)
    assert chosen.variant == "tf32x3" and set(chosen.tiles) <= {16, 32, 64}
    before = dict(vit_block.VARIANT_LAUNCHES)
    n_enc, n_blk = vit_block.LAUNCHES, vit_block.BLOCK_LAUNCHES
    got = vit_block.encoder(x, blocks, heads)
    chain = x
    for p in blocks:
        chain = vit_block.block(chain, p, heads)
    torch.cuda.synchronize()
    assert (vit_block.LAUNCHES, vit_block.BLOCK_LAUNCHES) == (n_enc + 1,
                                                              n_blk + depth)
    assert vit_block.VARIANT_LAUNCHES == dict(
        before, tf32x3=before["tf32x3"] + 1 + depth)
    _check_close(got, vit_block.encoder_reference(x, blocks, heads),
                 torch.float32)
    assert torch.equal(got, chain)
    flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
    other, launch = vit_block.prepared(
        x, vit_block._stack(flat, depth), heads, True,
        chosen=chosen._replace(warpgroups=3 - chosen.warpgroups))
    launch()
    _check_close(other, vit_block.encoder_reference(x, blocks, heads),
                 torch.float32)
    out, launch = vit_block.prepared(x, vit_block._stack(flat, depth), heads,
                                     True, chosen=vit_block.Plan("simt"))
    launch()
    torch.cuda.synchronize()
    assert vit_block.VARIANT_LAUNCHES["simt"] == before["simt"] + 1
    _check_close(out, vit_block.encoder_reference(x, blocks, heads),
                 torch.float32)


def test_tf32x3_operands_are_split_once(dev):
    # The operand cache holds the weights split (hi, lo planes), reused
    # across calls; split weights handed to another variant raise.
    gen = torch.Generator().manual_seed(9)
    blocks = _blocks(gen, 96, 2, 384, torch.float32, dev)
    flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
    ops = vit_block._operands(flat, 2, torch.float32, 2)
    assert ops[2].shape == (2, 2, 96, 288)
    assert vit_block._operands(flat, 2, torch.float32, 2) is ops
    x = torch.randn((1, 80, 96), generator=gen).to(dev)
    assert torch.equal(vit_block._launch(x, ops, 2, stacked=True),
                       vit_block.encoder(x, blocks, 2))
    with pytest.raises(ValueError, match="split weights"):
        vit_block.prepared(x, ops, 2, True, chosen=vit_block.Plan("simt"))


def test_block_kernel_casts_masters_and_rejects_what_it_cannot_take(dev):
    gen = torch.Generator().manual_seed(2)
    blk = _blocks(gen, 64, 1, 256, torch.float32, dev)[0]
    x = torch.randn((2, 20, 64), generator=gen).to(dev)
    cast = {m: {f: t.bfloat16() for f, t in l.items()} for m, l in blk.items()}
    assert torch.equal(vit_block.block(x.bfloat16(), blk, 2),
                       vit_block.block(x.bfloat16(), cast, 2))
    with pytest.raises(TypeError):
        vit_block.block(x.half(), blk, 2)
    wide = _blocks(gen, 136, 1, 256, torch.float32, dev)[0]
    x136 = torch.randn((2, 20, 136), generator=gen).to(dev)
    before = vit_block.BLOCK_LAUNCHES
    _check_close(vit_block.block(x136, wide, 1),            # dh = 136: panels
                 vit_block.block_reference(x136, wide, 1), torch.float32)
    assert vit_block.BLOCK_LAUNCHES == before + 1
    with pytest.raises(ValueError, match="simt takes head dims"):
        vit_block.prepared(x136, [wide[m][f] for m, f in vit_block._FIELDS], 1,
                           False, chosen=vit_block.Plan("simt"))
    bad = dict(blk, proj={"kernel": blk["proj"]["kernel"][:, :32],
                          "bias": blk["proj"]["bias"]})
    with pytest.raises(ValueError, match="kernel expects"):
        vit_block.block(x, bad, 2)


def test_block_kernel_backward_is_the_twins(dev):
    gen = torch.Generator().manual_seed(6)
    blk = _blocks(gen, 64, 1, 256, torch.float32, dev)[0]
    leaves = [t.requires_grad_(True) for m in blk.values() for t in m.values()]
    x = torch.randn((3, 37, 64), generator=gen).to(dev).requires_grad_(True)
    g_k = torch.autograd.grad((vit_block.block(x, blk, 2) ** 2).sum(),
                              [x, *leaves])
    g_r = torch.autograd.grad((vit_block.block_reference(x, blk, 2) ** 2).sum(),
                              [x, *leaves])
    assert len(g_k) == 13
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The NV12-to-tokens kernel (fused_prep_embed.nv12_search_tokens)
# ---------------------------------------------------------------------------

def _nv12(shape, seed, dev):
    rng = np.random.default_rng(seed)
    h, w = shape
    return (torch.as_tensor(rng.integers(0, 256, (h, w), dtype=np.uint8),
                            device=dev),
            torch.as_tensor(rng.integers(0, 256, (h // 2, w // 2, 2),
                                         dtype=np.uint8), device=dev))


@pytest.mark.parametrize("preset,dtype", [("vittrack-t", "bfloat16"),
                                          ("vittrack-t", "float32"),
                                          ("small", "float32")])
@pytest.mark.parametrize("shape,box", [
    ((512, 640), (300.0, 200.0, 64.0, 64.0)),       # inside the frame
    ((512, 640), (-20.0, 470.0, 80.0, 80.0)),       # over the frame edge
    ((1080, 1920), (1500.0, 700.0, 64.0, 64.0)),    # banded
    ((1080, 1920), (1770.0, 980.0, 90.0, 70.0)),    # band in the corner
    ((1080, 1920), (3.0, 5.0, 400.0, 300.0)),       # window beyond the band
    # The geometry the kernel works out itself (window_geometry):
    ((1080, 1920), (990.0, 500.0, 21.0, 30.0)),     # cx - 576 = 424.5: a tie
    ((1080, 1080), (900.0, 100.0, 120.0, 90.0)),    # frame smaller than the band
    ((1080, 1920), (100.0, 600.0, 500.0, 380.0)),   # window larger than the band
    ((1080, 1920), (4.0, 6.0, 50.0, 40.0)),         # the band's top-left corner
])
def test_fused_prep_kernel_matches_plain(dev, preset, dtype, shape, box):
    cfg = dataclasses.replace(PRESETS[preset], dtype=dtype)
    params = weights.load_npz(weights.checkpoint_path(preset), cfg, device=dev)
    y, uv = _nv12(shape, 3, dev)
    win = pp.crop_window(torch.tensor(box, device=dev), cfg.search_factor)
    before = fpe.LAUNCHES
    got = fpe.nv12_search_tokens(params, y, uv, win, cfg)
    assert fpe.LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert got.shape == (cfg.num_search_tokens, cfg.embed_dim)
    for mode in fpe.MODES:
        ref = fpe.nv12_search_tokens_reference(params, y, uv, win, cfg, mode)
        assert fpe.LAUNCHES == before + 1            # the plain version is plain
        err = (got.float() - ref.float()).abs().max().item()
        if dtype == "float32":
            assert err <= 1e-4, (mode, err)
        else:                # one bf16 ulp at the largest plain value
            assert err <= 2.0 ** -7 * ref.float().abs().max().item(), (mode, err)
    # Either mode string launches the one kernel.
    assert torch.equal(got, fpe.nv12_search_tokens(params, y, uv, win, cfg,
                                                   mode="transpose"))


def test_fused_prep_kernel_rejects_what_it_cannot_take(dev):
    cfg = PRESETS["small"]
    params = weights.load_npz(weights.checkpoint_path("small"), cfg, device=dev)
    y, uv = _nv12((128, 160), 4, dev)
    win = pp.crop_window(torch.tensor([60.0, 50.0, 20.0, 20.0], device=dev),
                         cfg.search_factor)
    with pytest.raises(ValueError, match="mode"):
        fpe.nv12_search_tokens(params, y, uv, win, cfg, mode="fast")
    with pytest.raises(ValueError, match="uv_plane"):
        fpe.nv12_search_tokens(params, y, uv[:, :-1], win, cfg)
    with pytest.raises(ValueError, match="different devices"):
        fpe.nv12_search_tokens(params, y, uv.cpu(), win, cfg)
    ops = list(fpe.kernel_operands(params, y, uv, win, cfg))
    ops[5] = ops[5][:, :-1].contiguous()             # embed weight too narrow
    with pytest.raises(ValueError, match="do not fit"):
        fpe.launch(*ops, cfg)
    ops = list(fpe.kernel_operands(params, y, uv, win, cfg))
    with pytest.raises(TypeError, match="variant mma"):   # bf16's on float32
        fpe.launch(*ops, cfg, fpe.plan(cfg.embed_dim, torch.bfloat16))
    # Patch 64 runs (in pieces of patch rows), but not on patch 16's weight.
    big = dataclasses.replace(cfg, patch_size=64, search_size=128)
    with pytest.raises(ValueError, match="do not fit"):
        fpe.launch(*ops, big)


@pytest.mark.parametrize("preset", ["vittrack-t", "small", "corr-tiny"])
@pytest.mark.parametrize("variant", ["tf32x3", "simt"])
@pytest.mark.parametrize("shape,box", [
    ((512, 640), (-20.0, 470.0, 80.0, 80.0)),       # over the frame edge
    ((1080, 1920), (1500.0, 700.0, 64.0, 64.0)),    # banded
    ((1080, 1920), (100.0, 600.0, 500.0, 380.0)),   # window larger than the band
])
def test_fused_prep_f32_variants_match_plain(dev, preset, variant, shape, box):
    # float32 at the three presets' shapes: tf32x3 (the plan) and simt (by
    # name) against the plain version, 1e-4; the launch counted by variant.
    cfg = dataclasses.replace(PRESETS[preset], dtype="float32")
    params = (vittrack.init_params(torch.Generator().manual_seed(0), cfg, dev)
              if preset == "corr-tiny" else weights.load_npz(
                  weights.checkpoint_path(preset), cfg, device=dev))
    y, uv = _nv12(shape, 6, dev)
    win = pp.crop_window(torch.tensor(box, device=dev), cfg.search_factor)
    assert fpe.plan(cfg.embed_dim, torch.float32).variant == "tf32x3"
    chosen = fpe.plan(cfg.embed_dim, torch.float32, variant)
    before = dict(fpe.VARIANT_LAUNCHES)
    got = fpe.launch(*fpe.kernel_operands(params, y, uv, win, cfg, chosen),
                     cfg, chosen)
    torch.cuda.synchronize()
    assert fpe.VARIANT_LAUNCHES == dict(before, **{variant: before[variant] + 1})
    for mode in fpe.MODES:
        ref = fpe.nv12_search_tokens_reference(params, y, uv, win, cfg, mode)
        err = (got - ref).abs().max().item()
        assert err <= 1e-4, (mode, err)


@pytest.mark.parametrize("dim", [48, 96, 160, 200, 384, 768, 1000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_prep_embed_widths_match_plain(dev, dim, dtype):
    # Every width runs: padded to the plan's (D not a multiple of 32; above
    # 256 several clusters of a token tile), the true D columns written;
    # bf16 in both wide tilings (32 and 64 columns a CTA).
    cfg = ModelConfig(
        template_size=64, search_size=128, patch_size=16, embed_dim=dim,
        depth=1, num_heads=1, dtype=dtype)
    params = profile_prep.seeded_params(cfg, dev, dim)
    y, uv = _nv12((1080, 1920), 7, dev)
    win = pp.crop_window(torch.tensor([1500.0, 700.0, 64.0, 64.0], device=dev),
                         cfg.search_factor)
    ref = fpe.nv12_search_tokens_reference(params, y, uv, win, cfg)
    tol = (1e-4 if dtype == "float32"
           else 2.0 ** -7 * ref.float().abs().max().item())
    dt = getattr(torch, dtype)
    plans = ([fpe.plan(dim, dt)] if dtype == "float32"
             else [fpe.plan(dim, dt, cols=c) for c in (32, 64)])
    for chosen in plans:
        got = fpe.launch(*fpe.kernel_operands(params, y, uv, win, cfg, chosen),
                         cfg, chosen)
        torch.cuda.synchronize()
        assert got.shape == (cfg.num_search_tokens, dim)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol, (chosen, err, tol)
    assert torch.equal(fpe.nv12_search_tokens(params, y, uv, win, cfg),
                       fpe.launch(*fpe.kernel_operands(params, y, uv, win,
                                                       cfg), cfg))


def test_fused_prep_call_is_one_device_activity(dev):
    # On ready parameters one call is the kernel and nothing else: no cast,
    # no copy, nothing read back to the host.
    from torch.profiler import ProfilerActivity, profile

    for preset, dtype in (("vittrack-t", "bfloat16"), ("vittrack-t", "float32")):
        cfg = dataclasses.replace(PRESETS[preset], dtype=dtype)
        params = weights.load_npz(weights.checkpoint_path(preset), cfg,
                                  device=dev)
        y, uv = _nv12((1080, 1920), 5, dev)
        win = pp.crop_window(torch.tensor([1500.0, 700.0, 64.0, 64.0],
                                          device=dev), cfg.search_factor)
        fpe.nv12_search_tokens(params, y, uv, win, cfg)      # the operands
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fpe.nv12_search_tokens(params, y, uv, win, cfg)
            torch.cuda.synchronize()
        acts = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(acts) == 1 and "embed" in acts[0], acts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [4, 12, 48, 96, 1, 100])
def test_attention_padded_head_dims_match_reference(dev, dtype, dh):
    # A head dim no variant takes as it is runs zero-padded (bf16 to 32 /
    # 64 / 128, the mma variant; float32 to the next multiple of 8) with the
    # true head dim's scale; the heads of a qkv buffer as multihead does.
    q, k, v = _qkv(6, 77, dh, dtype, dev, v_scale=3.0)
    chosen = attention.kernel_variant(q)
    if dh % 8:
        assert chosen == ("mma" if dtype == torch.bfloat16 else "tf32x3")
    before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
    got = attention.flash_attention(q, k, v)
    assert attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES == before + 1
    _check_attention(got, attention.attention_reference(q, k, v), dtype)
    qkv = torch.cat([t.reshape(2, 3, 77, dh).transpose(1, 2).reshape(2, 77, 3 * dh)
                     for t in (q, k, v)], dim=-1)
    qm, km, vm = torch.chunk(qkv, 3, dim=-1)
    _check_attention(attention.multihead_attention(qm, km, vm, 3),
                     attention.multihead_attention(qm, km, vm, 3, use_kernel=False),
                     dtype)


@pytest.mark.parametrize("dtype,d,heads,variant", [
    (torch.bfloat16, 192, 4, "mma"), (torch.bfloat16, 192, 2, "mma"),
    (torch.bfloat16, 64, 4, "mma"), (torch.bfloat16, 96, 2, "mma"),
    (torch.float32, 40, 4, "tf32x3"),
    (torch.float32, 96, 8, "tf32x3"), (torch.float32, 64, 16, "tf32x3")])
def test_encoder_padded_head_dims_match_twin(dev, dtype, d, heads, variant):
    # Head dims 48, 96 and 16 in bf16 (padded to 64, 128 and 32); in float32
    # 10 at D 40 (to 16, and D to 64), 12 and 4 (tf32x3, to 16 and 8): the
    # encoder kernel on the padded operand cache, and the block kernel
    # padding at the launch, against the twin.
    gen = torch.Generator().manual_seed(d * heads)
    blocks = _blocks(gen, d, 2, 4 * d, dtype, dev)
    x = torch.randn((2, 70, d), generator=gen).to(dev, dtype)
    assert vit_block._plan_for(x, heads, 4 * d).variant == variant
    assert vit_block._plan_for(x, heads, 4 * d).pad == vit_block.head_pad(
        variant, d // heads) > d // heads
    before = dict(vit_block.VARIANT_LAUNCHES)
    got = vit_block.encoder(x, blocks, heads)
    assert vit_block.VARIANT_LAUNCHES[variant] == before[variant] + 1
    _check_close(got, vit_block.encoder_reference(x, blocks, heads), dtype)
    one = vit_block.block(x, blocks[0], heads)
    _check_close(one, vit_block.block_reference(x, blocks[0], heads), dtype)
    assert torch.equal(one, vit_block.encoder(x, blocks[:1], heads))


@pytest.mark.parametrize("dtype,d,heads", [
    (torch.bfloat16, 1024, 16), (torch.bfloat16, 776, 8),
    (torch.float32, 1024, 16), (torch.float32, 776, 8),
    (torch.float32, 1000, 8)])
def test_wide_widths_stream_and_match_twin(dev, dtype, d, heads):
    # Widths past the resident LN products (D 1024), and padded ones (D 776:
    # bf16 to 832, float32 to 800, head dim 97 to 128 / 104; D 1000 float32
    # to 1024, head dim 125 to 128): the encoder and block kernels as the
    # plan takes them (bf16 prenormed, float32 streamed where the rows do
    # not fit), and with the variant's wide form named, against the twin;
    # the resident form, where it fits, equals the wide one bit for bit,
    # and where it does not, naming it raises.  Float32 never launches
    # simt.
    gen = torch.Generator().manual_seed(d + heads)
    blocks = _blocks(gen, d, 2, 4 * d, dtype, dev)
    flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
    x = torch.randn((2, 100, d), generator=gen).to(dev, dtype)
    rule = vit_block._plan_for(x, heads, 4 * d)
    assert rule.variant == ("mma" if dtype == torch.bfloat16 else "tf32x3")
    before = dict(vit_block.VARIANT_LAUNCHES)
    got = vit_block.encoder(x, blocks, heads)
    one = vit_block.block(x, blocks[0], heads)
    ref = vit_block.encoder_reference(x, blocks, heads)
    _check_close(got, ref, dtype)
    _check_close(one, vit_block.block_reference(x, blocks[0], heads), dtype)
    assert vit_block.VARIANT_LAUNCHES == dict(
        before, **{rule.variant: before[rule.variant] + 2})
    stacked = vit_block._stack(flat, 2)
    wide, launch = vit_block.prepared(
        x, stacked, heads, True,
        chosen=rule._replace(ln=vit_block._WIDE_LN[rule.variant]))
    launch()
    torch.cuda.synchronize()
    _check_close(wide, ref, dtype)
    assert torch.equal(wide, got)
    if vit_block._fits(rule.variant, "resident", rule.width or d, rule.tiles,
                       rule.warpgroups, vit_block.attention.card(dev)[0]):
        resident, launch = vit_block.prepared(
            x, stacked, heads, True, chosen=rule._replace(ln="resident"))
        launch()
        torch.cuda.synchronize()
        assert torch.equal(resident, got)
    else:
        with pytest.raises(ValueError, match="resident LN form"):
            vit_block.prepared(x, stacked, heads, True,
                               chosen=rule._replace(ln="resident"))


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
def test_update_fused_prep_on_card_matches_the_plain_route(dev, preset):
    cfg = PRESETS[preset]
    params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path(preset), cfg, device=dev))
    frames, bbox = _clip(4)
    state = core.init(params, frames[0], bbox, cfg, "nv12", dev)
    before = fpe.LAUNCHES
    for f in frames[1:]:
        _, want = core.update_packed(params, state, f, cfg, "nv12", dev)
        state, got = core.update_packed(params, state, f, cfg, "nv12", dev,
                                        fused_prep=True)
        d = (got - want).abs().cpu().numpy()
        tol = (1e-2, 1e-4) if cfg.dtype == "float32" else (2.0, 0.02)
        assert d[:4].max() <= tol[0] and d[4] <= tol[1], d
    assert fpe.LAUNCHES == before + len(frames) - 1


@pytest.mark.parametrize("fmt", ["rgb", "yuy2"])
def test_other_formats_on_card_match_cpu(dev, fmt):
    cfg = PRESETS["small"]
    rng = np.random.default_rng(5)
    shape = (240, 320, 3) if fmt == "rgb" else (240, 640)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    rows = {}
    for d in (dev, torch.device("cpu")):
        params = vittrack.with_grouped_head(weights.load_npz(
            weights.checkpoint_path("small"), cfg, device=d))
        st = core.init(params, frames[0], (100.0, 80.0, 40.0, 32.0), cfg, fmt, d)
        out = []
        for f in frames[1:]:
            st, packed = core.update_packed(params, st, f, cfg, fmt, d,
                                            fused_embed=True)
            out.append(packed.cpu().numpy())
        rows[d.type] = np.stack(out)
    np.testing.assert_allclose(rows["cuda"][:, :4], rows["cpu"][:, :4], atol=1e-2)
    np.testing.assert_allclose(rows["cuda"][:, 4], rows["cpu"][:, 4], atol=1e-4)


def test_train_step_on_card_matches_cpu(dev):
    cfg = PRESETS["small"]
    rng = np.random.default_rng(6)
    b = 4
    z = rng.normal(0, 1, (b, cfg.template_size, cfg.template_size, 3)
                   ).astype(np.float32)
    x = rng.normal(0, 1, (b, cfg.search_size, cfg.search_size, 3)
                   ).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.3, 0.7, (b, 2)),
                         rng.uniform(0.1, 0.4, (b, 2))], 1).astype(np.float32)
    opt = train_step_mod.make_optimizer(1e-3)
    losses = {}
    for d in (dev, torch.device("cpu")):
        params = weights.load_npz(weights.checkpoint_path("small"), cfg, device=d)
        st = train_step_mod.create_train_state(params, opt=opt)
        before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
        out = []
        for _ in range(3):
            st, loss, _ = train_step_mod.train_step(st, z, x, gt, cfg, opt=opt,
                                                    device=d)
            out.append(float(loss))
        losses[d.type] = out
        launched = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES - before
        assert launched == (3 * cfg.depth if d.type == "cuda" else 0)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    assert losses["cuda"][-1] < losses["cuda"][0]


# ---------------------------------------------------------------------------
# Head dims above 128 (the panel kernels) and patches above 32 (kernel 5's K
# in pieces of patch rows)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [136, 192, 256])
@pytest.mark.parametrize("s", [100, 320])
def test_wide_head_dims_match_reference_on_both_routes(dev, dtype, dh, s):
    # Two heads of dh: the plan's kernel through multihead_attention, then
    # both routes by name on ready operands where their CTAs fit the card.
    gen = torch.Generator().manual_seed(dh + s)
    q, k, v = (torch.randn((2, s, 2 * dh), generator=gen).to(dev, dtype)
               for _ in range(3))
    ref = attention.multihead_attention(q, k, v, 2, use_kernel=False)
    _check_attention(attention.multihead_attention(q, k, v, 2), ref, dtype)
    chosen = attention._plan_for(dev, s, dh, dtype, 4)
    optin = attention.card(dev)[0]
    pad = chosen.pad or dh
    for route in ("single", "flash"):
        # bf16's flash ring holds panels (panel_stages), float32's two stages.
        stages = 0 if route == "single" else (
            attention.panel_stages(pad // 64, chosen.group, optin)
            if chosen.variant == "mma" else 2)
        named = chosen._replace(route=route, stages=stages)
        if attention.smem_bytes(route, named.variant, s, pad, 0, 64,
                                named.stages, 1, named.group) > optin:
            continue
        out, launch = attention.prepared(q, k, v, 2, chosen=named)
        launch()
        torch.cuda.synchronize()
        out = out.view(2, s, 2, pad)[..., :dh].reshape(2, s, 2 * dh)
        _check_attention(out, ref, dtype)


@pytest.mark.parametrize("dh", [136, 192, 256, 512, 576])
@pytest.mark.parametrize("s", [64, 100, 320])
def test_f32_panels_match_reference_at_every_group(dev, dh, s):
    # The float32 panel kernel (csrc/panel_tf32.cuh) at every G that divides
    # its panels, both routes by name where the CTA fits the card (single:
    # a ring of every load; flash: tf32_panel_stages'), q resident up to dh
    # 512 and through the ring above it (576: nine panels), against
    # attention_reference taken in float64, at 1e-5 up to dh 512 and 1e-5 x
    # (dh / 256)^1/2 above (split TF32 drops about 2^-22 of each product,
    # and a score sums dh of them: 1.35e-5 at dh 576 and 1.62e-5 at 1024 on
    # an H100, the bits of the design before it); every G gives the same
    # bits (each thread's sums in one order).
    gen = torch.Generator().manual_seed(7 * dh + s)
    q, k, v = (torch.randn((3, s, dh), generator=gen).to(dev)
               for _ in range(3))
    ref = attention.attention_reference(q.double(), k.double(),
                                        v.double()).float()
    optin, panels = attention.card(dev)[0], -(-dh // 64)
    outs = []
    for g in range(1, 5):
        if panels % g:
            continue
        for route in ("single", "flash"):
            stages = 0 if route == "single" else attention.tf32_panel_stages(
                panels, g, optin)
            named = attention.Plan(route, "tf32x3", 64, stages, 1, 0, g)
            if attention._refusal(named, s, dh, optin) is not None:
                continue
            out, launch = attention.prepared(q, k, v, chosen=named)
            launch()
            torch.cuda.synchronize()
            assert torch.isfinite(out).all()
            err = (out - ref).abs().max().item()
            assert err <= 1e-5 * (1.0 if dh <= 512 else (dh / 256) ** 0.5), (
                err, named)
            outs.append(out)
    assert outs and all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("batch", [1, 4])
def test_f32_panel_encoder_matches_twin_at_every_group(dev, batch):
    # The encoder's float32 panel stage (4 heads of 256) at G 1, 2 and 4
    # through kernel 1 (2 blocks, batch 1) or kernel 2 (batch 4) against the
    # twin; every G gives the same bits.
    gen = torch.Generator().manual_seed(256 + batch)
    blocks = _blocks(gen, 1024, 2, 4096, torch.float32, dev)
    x = torch.randn((batch, 80, 1024), generator=gen).to(dev)
    if batch == 1:
        ref = vit_block.encoder_reference(x, blocks, 4)
        flat = [b[m][f] for b in blocks for m, f in vit_block._FIELDS]
        weights_, stacked = vit_block._stack(flat, 2), True
    else:
        ref = vit_block.block_reference(x, blocks[0], 4)
        weights_ = [blocks[0][m][f] for m, f in vit_block._FIELDS]
        stacked = False
    rule = vit_block._plan_for(x, 4, 4096)
    assert rule.variant == "tf32x3" and rule.group >= 1
    outs = []
    for g in (1, 2, 4):
        out, launch = vit_block.prepared(x, weights_, 4, stacked,
                                         chosen=rule._replace(group=g))
        launch()
        torch.cuda.synchronize()
        _check_close(out, ref, torch.float32)
        outs.append(out)
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads", [(768, 4), (512, 2), (272, 2)])
def test_wide_head_encoder_and_block_match_twin(dev, dtype, d, heads):
    # Head dims 192, 256 and 136 (bf16: padded to 192): the encoder (2
    # blocks) and the block kernel against the twin, one launch each.
    gen = torch.Generator().manual_seed(d + heads)
    blocks = _blocks(gen, d, 2, 4 * d, dtype, dev)
    x = torch.randn((1, 80, d), generator=gen).to(dev, dtype)
    x4 = torch.randn((4, 80, d), generator=gen).to(dev, dtype)
    before = vit_block.LAUNCHES, vit_block.BLOCK_LAUNCHES
    got = vit_block.encoder(x, blocks, heads)
    one = vit_block.block(x4, blocks[0], heads)
    assert (vit_block.LAUNCHES, vit_block.BLOCK_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    _check_close(got, vit_block.encoder_reference(x, blocks, heads), dtype)
    _check_close(one, vit_block.block_reference(x4, blocks[0], heads), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("patch,search", [(48, 192), (64, 256)])
def test_wide_patches_match_plain(dev, dtype, patch, search):
    # Kernel 5 above patch 32 (K in pieces of patch rows, two A tiles)
    # against both modes of its plain version, one launch a call.
    cfg = dataclasses.replace(PRESETS["vittrack-t"], dtype=dtype,
                              patch_size=patch, search_size=search,
                              template_size=search // 2)
    rng = np.random.default_rng(patch)
    k = patch * patch * 3
    params = {"backbone": {
        "patch_embed": {"kernel": torch.as_tensor(
            (0.02 * rng.standard_normal((k, cfg.embed_dim))).astype(np.float32),
            device=dev), "bias": torch.zeros(cfg.embed_dim, device=dev)},
        "pos_embed_x": torch.as_tensor((0.1 * rng.standard_normal(
            (cfg.num_search_tokens, cfg.embed_dim))).astype(np.float32),
            device=dev)}}
    y, uv = _nv12((1080, 1920), patch, dev)
    win = pp.crop_window(torch.tensor([1500.0, 700.0, 64.0, 64.0], device=dev),
                         cfg.search_factor)
    before = fpe.LAUNCHES
    got = fpe.nv12_search_tokens(params, y, uv, win, cfg)
    assert fpe.LAUNCHES == before + 1
    for mode in fpe.MODES:
        ref = fpe.nv12_search_tokens_reference(params, y, uv, win, cfg, mode)
        err = (got.float() - ref.float()).abs().max().item()
        if dtype == "float32":
            assert err <= 1e-4, (mode, err)
        else:
            assert err <= 2.0 ** -7 * ref.float().abs().max().item(), (mode, err)
