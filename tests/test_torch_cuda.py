"""PyTorch port on an NVIDIA GPU: the CUDA encoder kernel against its
plain twin, its input checks, its launch count, its backward, and the
tracking step on the card against the same step on the CPU; the two
attention kernels against ``attention_reference``, their dispatch by
length, input checks, launch counts and backward; the per-block encode
route and a batched engine tick on the card against the CPU.

Every test here needs a card and skips without one (marker ``cuda``).
Run them on the GPU with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
conftest imports JAX, which the GPU machine need not have).
Float32 products and convolutions run without TF32 (set by the fixture).
Tolerances: float32 1e-4; bf16 2% of the largest twin value (one bf16 ulp
at the top of a binade is 0.8% of it, and the kernel sums in another order
than the twin).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block  # noqa: E402
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
    got = vit_block.encoder(x, blocks, heads)
    assert vit_block.LAUNCHES == before + 1
    ref = vit_block.encoder_reference(x, blocks, heads)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == dtype
    _check_close(got, ref, dtype)


def test_encoder_kernel_rejects_what_it_cannot_take(dev):
    gen = torch.Generator().manual_seed(0)
    blocks = _blocks(gen, 64, 1, 256, torch.float32, dev)
    x = torch.randn((1, 20, 64), generator=gen).to(dev)
    with pytest.raises(TypeError):
        vit_block.encoder(x.half(), blocks, 2)
    with pytest.raises(ValueError, match="head dim"):
        vit_block.encoder(x, blocks, 8)                      # dh = 8
    with pytest.raises(ValueError, match="contiguous"):
        vit_block.encoder(x[:, ::2], blocks, 2)
    with pytest.raises(ValueError, match="kernel expects"):
        vit_block.encoder(x.bfloat16(), blocks, 2)           # f32 weights
    with pytest.raises(ValueError, match="shared memory"):
        big = _blocks(gen, 128, 1, 512, torch.float32, dev)
        vit_block.encoder(torch.zeros((1, 4096, 128), device=dev), big, 1)


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


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
def test_update_on_card_matches_cpu(dev, preset):
    cfg = PRESETS[preset]
    frames, bbox = _clip(4)
    out = {}
    for d in (dev, torch.device("cpu")):
        params = vittrack.with_grouped_head(weights.load_npz(
            weights.checkpoint_path(preset), cfg, device=d))
        st = core.init(params, frames[0], bbox, cfg, device=d)
        rows = []
        for f in frames[1:]:
            st, packed = core.update_packed(params, st, f, cfg, device=d)
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
# K and V of float32 need twice the shared memory, so the serving shape is
# whole-sequence in bf16 and blocked in float32.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,dh,route32,route16", [
    (48, 320, 64, "flash", "single"), (2, 128, 64, "single", "single"),
    (3, 200, 32, "single", "single"), (4, 80, 48, "single", "single"),
    (2, 1, 8, "single", "single"), (5, 33, 128, "single", "single"),
    (3, 1088, 64, "flash", "flash"), (1, 1200, 32, "flash", "flash"),
    (2, 777, 128, "flash", "flash"), (1, 4099, 8, "flash", "flash")])
def test_attention_kernels_match_reference(dev, dtype, bh, s, dh, route32,
                                           route16):
    route = route32 if dtype == torch.float32 else route16
    q, k, v = _qkv(bh, s, dh, dtype, dev)
    assert attention.kernel_route(q) == route
    before = (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES)
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES)
    assert after == ((before[0] + 1, before[1]) if route == "single"
                     else (before[0], before[1] + 1))
    _check_attention(got, attention.attention_reference(q, k, v), dtype)


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
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q[..., :12], k[..., :12], v[..., :12])
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
