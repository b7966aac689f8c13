"""PyTorch port: the encoder kernels (``ops/vit_block.py``, kernels 1 and 2)
on the CPU: the rule that decides what a call takes, an emulation of the
``mma`` variant's arithmetic held to the port's twin, the operand cache,
and the attention rule on odd shapes against the JAX package.

What a CPU run can say of kernels that run only on the card:

* ``plan`` (a pure function): the variant by dtype, the head dims and
  (``mma``) the widths it pads and to what, the shapes it refuses (it
  raises), the N tile of each product by batch; operands laid out where
  the kernels cannot read them are copied.  Zero-padded heads (the qkv /
  proj weights of the operand cache, the q / k / v copies of the attention
  wrapper) run through the plain twin with the true head dim's scale equal
  the unpadded twin (1e-6, float32); so do zero-padded widths with x
  carried at the padded width and the LayerNorm over the true D, every
  padded column staying 0, and the ``mma`` emulation on width-padded
  operands equals it on the unpadded ones bit for bit.
* The ``mma`` arithmetic, emulated in float64 where the tensor cores are
  exact (bf16 products) and rounded to float32 where they round (toward
  zero, each 16-deep step in a fresh accumulator; the steps and chunks
  added in f32), the LayerNorm's two f32 passes, ``exp`` of the twin's own
  argument, p carried exactly (hi + mid + lo) into P.V and one division
  o / l.  It differs from the twin in the order of its sums alone, and is
  held to the twin directly at the flagship's depth on 8 real crops.  The
  bounds are set from readings: the encoder output's mean |d| was
  0.023-0.031 per crop (bound 0.033), its max|d| 0.48-0.93 % of max|twin|
  (bound 1 %, ``chip_smoke.py``'s ``ENC_REL_TOL``); after the final LN, no
  farther from the float64 chain than the twin is plus 0.03125 per crop
  and 1.10 x the twin's mean over the crops (0.98 read), the card's
  yardstick.  A planted fault, p rounded to bf16 before P.V, reads
  0.036-0.039 and 1.32 x: caught.  Free-running 3-step flagship
  trajectories, emulation against twin, hold 2 px / 0.02 on 6 of 8 clips:
  a free-running trajectory crosses near-ties, so one clip decides nothing
  (PERF.md, Findings).
* The LayerNorm products past the resident form (``Plan.ln``: bf16
  ``"prenormed"`` above a width of 768, the LN rows written once by
  ln_rows_kernel; float32 ``"streamed"`` where the rows do not fit the
  card's shared memory): their statistics, emulated in the kernels' own
  order of f32 sums as ln_rows_kernel and row_stats_kernel read x chunk by
  chunk, equal the resident form's (the same order over the resident
  tile) bit for bit at every width the resident form takes, in both
  dtypes' lane groupings; the port's plain version of the LN rows
  (``vit_block.ln_rows_reference``) equals that LayerNorm bit for bit at D
  992, 1024 and 1280; the mma emulation with them is held to the twin at
  D 1024 and at a padded D 992, and a planted fault (the statistics over
  the padded width) is caught.
* The operand cache: reused across calls, rebuilt after an in-place
  update, bypassed under a gradient.
* ``ops/attention.py::plan`` pads a head dim that is not a multiple of 8
  (bf16 to 32 / 64 / 128, float32 to the next multiple of 8) and takes
  one above 128 in panels (float32 136 as it is); q, k, v whose last
  dimension is not contiguous or whose base is not 16-byte aligned are
  copied, unchanged, into operands the kernels read in place.  On the CPU
  all three shapes take the plain version, which equals JAX's
  ``multihead_attention(use_pallas=None)`` (1e-5, float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import attention as jattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.entry import entry  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention as tattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import vit_block  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.profile_encoder import nv12_clip  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
CPU = torch.device("cpu")
H100_OPTIN, H100_SMS = 232448, 132

ENC_REL_TOL = 0.01          # max|d| / max|twin|, as on the card
EMU_MEAN_TOL = 0.033        # mean|d| of the encoder output a crop
LN_MARGIN = 0.03125         # one bf16 ulp in [4, 8)
LN_MEAN_RATIO = 1.10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The emulation is many small float64 ops: one intra-op thread, which
    runs them as fast alone and does not crawl beside other test workers
    that hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The encoder's rule
# ---------------------------------------------------------------------------

def test_plan_n_tile_by_batch():
    # Flagship shape: 5 row tiles at batch 1 fill no SM count with 64-wide
    # tiles (45 CTAs for qkv), 80 at batch 16 do (720).
    assert vit_block.plan(1, 320, 192, 3, 768, BF16, H100_SMS) == vit_block.Plan(
        "mma", (32, 32, 32, 32))
    assert vit_block.plan(16, 320, 192, 3, 768, BF16, H100_SMS) == vit_block.Plan(
        "mma", (64, 64, 64, 64))
    # Each product on its own: at batch 2 only the wide ones reach 132.
    assert vit_block.plan(2, 320, 192, 3, 768, BF16, H100_SMS).tiles == (32, 32, 32, 32)
    assert vit_block.plan(4, 320, 192, 3, 768, BF16, H100_SMS).tiles == (64, 32, 64, 32)


@pytest.mark.parametrize("dtype,dim,heads,hidden,variant", [
    (BF16, 192, 3, 768, "mma"),      # the flagship
    (BF16, 256, 2, 1024, "mma"),     # head dim 128
    (BF16, 128, 4, 512, "mma"),      # head dim 32
    (BF16, 768, 12, 3072, "mma"),    # the widest D of the resident LN form
    (F32, 96, 2, 384, "tf32x3"),     # the small preset
    (F32, 192, 3, 768, "tf32x3"),    # the flagship in float32
    (F32, 32, 2, 128, "tf32x3"),     # the dry run's serving model: dh 16
    (F32, 192, 8, 768, "tf32x3"),    # head dim 24: tf32x3 takes it as it is
    (F32, 192, 16, 768, "tf32x3"),   # head dim 12: padded to 16
    (F32, 640, 5, 2560, "tf32x3"),   # D beyond 544: the LN rows prenormed
    (F32, 96, 2, 400, "tf32x3"),     # MLP width no multiple of 32: padded
    (BF16, 96, 2, 384, "mma"),       # small in bf16: dh 48 -> 64, D -> 128
    (BF16, 64, 4, 256, "mma"),       # head dim 16: padded to 32
    (BF16, 96, 3, 384, "mma"),       # head dim 32, D 96 -> 128
    (BF16, 832, 13, 3328, "mma"),    # D beyond 768: the LN rows prenormed
    (BF16, 96, 12, 384, "mma"),      # head dim 8 -> 32, D 96 -> 128
    (F32, 24, 2, 96, "tf32x3"),      # head dim 12 -> 16, D 24 -> 32
    (BF16, 288, 2, 1152, "mma"),     # head dim 144 -> 192 (panels), D -> 320
    (F32, 64, 2, 200, "tf32x3"),     # MLP width 200 -> 224
    (torch.float16, 192, 3, 768, None),
])
def test_plan_variant_by_dtype_and_head_dim(dtype, dim, heads, hidden, variant):
    # The variant: bf16's mma, float32's tf32x3, at every width (simt runs
    # by name only).  A head dim it does not take as it is runs zero-padded
    # (the padded dim in the plan, the true one's scale at the launch), and
    # so does a D or MLP width no multiple of the variant's K chunk (mma 64,
    # tf32x3 32); above a head dim of 128 bf16 pads to a whole 64-column
    # panel.  Another dtype raises before any launch (no call on the card
    # goes to the plain twin).
    if variant is None:
        with pytest.raises(TypeError if dtype == torch.float16 else ValueError):
            vit_block.plan(1, 320, dim, heads, hidden, dtype, H100_SMS)
        return
    got = vit_block.plan(1, 320, dim, heads, hidden, dtype, H100_SMS)
    assert got.variant == variant
    pad = {(64, 4): 32, (24, 2): 16, (192, 16): 16,
           (288, 2): 192}.get((dim, heads), 0)
    if dtype == BF16 and dim == 96:
        pad = {2: 64, 3: 0, 12: 32}[heads]
    assert got.pad == pad == vit_block.head_pad(variant, dim // heads)
    widths = {(BF16, 96): (128, 0), (F32, 96): (0, 416 if hidden == 400 else 0),
              (F32, 24): (32, 0), (F32, 64): (0, 224), (BF16, 288): (320, 0)}
    width = widths.get((dtype, dim), (0, 0))
    assert (got.width, got.mlp) == width == vit_block.width_pads(
        variant, dim, hidden)
    if variant == "mma":
        assert set(got.tiles) <= {32, 64} and got.warpgroups == 1
    else:
        assert set(got.tiles) <= {16, 32, 64} and got.warpgroups in (1, 2)
    # Every width here keeps the LN products' rows resident but bf16 D 832,
    # past 768, and float32 D 640, past 544, whose LN rows are written once
    # (prenormed; tests/test_torch_wide_encoder.py holds the wide widths).
    assert got.ln == ("prenormed" if (dtype, dim) in ((BF16, 832), (F32, 640))
                      else "resident")


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("dim,heads,hidden,pad,width,mlp", [
    (96, 2, 384, 64, 128, 0),        # the small architecture in bf16
    (160, 5, 640, 0, 192, 0),        # head dim 32 as it is
    (96, 2, 400, 64, 128, 448),      # an MLP width no multiple of 64 too
    (768, 12, 3072, 0, 0, 0),        # the widest D: nothing padded
    (192, 3, 768, 0, 0, 0)])         # the flagship: nothing padded
def test_plan_pads_bf16_widths_to_whole_chunks(batch, dim, heads, hidden,
                                               pad, width, mlp):
    # mma takes K in 64-deep chunks: a D or an MLP width that is no multiple
    # of 64 runs zero-padded to the next one, with the head pad beside it;
    # the N tiles are those of the padded widths, and a width that needs no
    # pad gets the plan it had.
    got = vit_block.plan(batch, 320, dim, heads, hidden, BF16, H100_SMS)
    assert (got.variant, got.pad, got.width, got.mlp) == ("mma", pad, width, mlp)
    rows = -(-batch * 320 // 64)
    inner = heads * (pad or dim // heads)
    # Each the rule's tile, halved until it divides the product's width
    # (a 64-wide qkv tile cannot take D 160's 480 columns).
    assert got.tiles == tuple(vit_block._fit(t, n) for t, n in zip(
        vit_block._tiles(rows, inner, width or dim, mlp or hidden, H100_SMS,
                         False),
        (3 * inner, width or dim, mlp or hidden, width or dim)))
    assert all(n % t == 0 for t, n in zip(
        got.tiles, (3 * inner, width or dim, mlp or hidden, width or dim)))
    if dim == 192:
        assert got == vit_block.Plan("mma", (32,) * 4 if batch == 1 else (64,) * 4)


@pytest.mark.parametrize("seq", [1, 320, 740, 1088, 4096])
def test_plan_has_no_sequence_limit(seq):
    # No sequence length is refused or changes the variant.
    for dtype, dim, heads in ((BF16, 192, 3), (F32, 96, 2), (F32, 128, 1)):
        got = vit_block.plan(1, seq, dim, heads, 4 * dim, dtype, H100_SMS)
        assert got.variant == vit_block._VARIANTS[dtype]


def test_unaligned_input_is_copied():
    # What the kernels cannot read in place is copied, values unchanged.
    x = torch.randn((1, 40, 192)).to(BF16)
    assert vit_block._aligned(x) and vit_block._laid_out(x) is x
    odd = [x[:, ::2], torch.cat([torch.zeros(1, dtype=BF16), x.ravel()])[1:]
           .view(1, 40, 192)]
    for t in odd:
        assert not vit_block._aligned(t)
        got = vit_block._laid_out(t)
        assert vit_block._aligned(got) and torch.equal(got, t)


def test_plan_config_is_the_tiles():
    # The variant's code (the C entries' Variant), the N tiles, the
    # warpgroups, the LN products' form (0 resident, 1 streamed, 2
    # prenormed).
    assert vit_block.Plan("mma", (32, 64, 32, 64)).config() == (1, 32, 64, 32, 64, 1, 0)
    assert vit_block.Plan("tf32x3", (64,) * 4, 0, 2).config() == (2, 64, 64, 64, 64, 2, 0)
    assert vit_block.Plan("tf32x3", (64,) * 4, ln="streamed").config() == (
        2, 64, 64, 64, 64, 1, 1)
    assert vit_block.Plan("mma", (128,) * 4, 0, 2, ln="prenormed").config() == (
        1, 128, 128, 128, 128, 2, 2)
    assert vit_block.Plan("simt").config() == (0, 0, 0, 0, 0, 1, 0)


@pytest.mark.parametrize("b,s,d,heads,tiles,wgs", [
    (1, 80, 96, 2, (16, 16, 16, 16), 2),       # small: the app's update
    (1, 320, 192, 3, (32, 16, 32, 16), 2),     # the flagship in float32
    (16, 80, 96, 2, (32, 16, 32, 16), 2),      # small's 16-slot block
    (16, 320, 192, 3, (64, 64, 64, 64), 1),    # the flagship's 16 slots
    (1, 320, 256, 2, (32, 16, 32, 16), 1),     # head dim 128: one warpgroup
    (1, 20, 32, 2, (16, 16, 16, 16), 2)])      # the dry run's serving model
def test_plan_tf32x3_tiles_and_warpgroups(b, s, d, heads, tiles, wgs):
    # tf32x3's N tile: 64 once 64-wide tiles fill the card, 16 where 32-wide
    # ones would leave more than half of it idle, else 32; two warpgroups a
    # CTA (a query tile's key blocks, a product's K) while the attention's
    # grid is smaller than the card (head dims up to 64).
    got = vit_block.plan(b, s, d, heads, 4 * d, F32, H100_SMS)
    assert got == vit_block.Plan("tf32x3", tiles, 0, wgs)


# ---------------------------------------------------------------------------
# The mma arithmetic, emulated
# ---------------------------------------------------------------------------

def _toward_zero(x):
    """float64 sums rounded to f32 toward zero, as the tensor cores round the
    sum they accumulate."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _steps(a, w, chained=False):
    """a @ w as the mma kernels take it: each 16-deep step's exact products
    summed in a fresh accumulator (rounded toward zero), the steps added in
    f32 in order.  ``chained``: the steps accumulate in one accumulator,
    each addition rounded toward zero."""
    out = acc = None
    for k0 in range(0, a.shape[-1], 16):
        part = a[..., k0:k0 + 16].double() @ w[..., k0:k0 + 16, :].double()
        if chained:
            acc = _toward_zero(part if acc is None else acc.double() + part)
        else:
            step = _toward_zero(part)
            out = step if out is None else out + step
    return acc if chained else out


def _product(a, p, chained=False):
    """x @ kernel + bias as the mma product computes it: 64-deep chunks of
    ``_steps`` added in f32, the bias added in f32, one rounding to bf16."""
    w, b = p["kernel"], p["bias"]
    acc = torch.zeros(a.shape[:-1] + (w.shape[1],))
    for c in range(0, w.shape[0], 64):
        acc = acc + _steps(a[..., c:c + 64], w[c:c + 64], chained)
    return (acc + b.float()).to(BF16)


def _layer_norm(x, p, dim=None, stats=None):
    """The LN prologue: the mean, then the mean of (x - mu)^2, each a sum
    divided by K in f32; 1 / sqrt; each operation rounded on its own; one
    rounding to bf16.  ``dim``: the true columns of a zero-padded x, which
    the two sums run over (K = dim).  ``stats(xf, dim)``: (mean, rstd) in
    the kernels' order of the f32 sums (``_stats_resident``,
    ``_stats_streamed``) in place of float64 sums rounded once."""
    xf = x.float()
    dim = dim or xf.shape[-1]
    if stats is not None:
        mu, rstd = stats(xf, dim)
        y = (xf - mu) * rstd
        return (y * p["scale"].float() + p["bias"].float()).to(BF16)
    k = torch.tensor(float(dim), dtype=F32)
    mu = xf[..., :dim].double().sum(-1, keepdim=True).float() / k
    t = xf - mu
    var = (t * t)[..., :dim].double().sum(-1, keepdim=True).float() / k
    y = t * (1.0 / torch.sqrt(var + torch.tensor(1e-6, dtype=F32)))
    return (y * p["scale"].float() + p["bias"].float()).to(BF16)


def _group8(s):
    """The eight lanes' f32 sums (last dim) added as group8_sum's three
    xor-shuffles add them; every lane ends with the same value."""
    for o in (1, 2, 4):
        s = s + s[..., torch.arange(8) ^ o]
    return s[..., :1]


def _finish(sums, xf, dim, mask_of):
    """mean = the lanes' sum / dim, then rstd from the lanes' sums of
    (x - mean)^2 (``sums(t)``), as row_stats ends: 1 / sqrt(var + eps)."""
    k = torch.tensor(float(dim), dtype=F32)
    mu = _group8(sums(xf)) / k
    var = _group8(sums((xf - mu) ** 2)) / k
    return mu, 1.0 / torch.sqrt(var + torch.tensor(1e-6, dtype=F32))


def _stats_resident(xf, dim, elems=8):
    """(mean, rstd) of layer_norm_tile over the resident tile (elems = 8,
    bf16; encoder_tf32.cuh's layer_norm_rows: elems = 4, float32): lane c
    of eight holds the 16-byte chunk c of each 8 x elems-column segment (a
    panel of the tile) and adds its elements into an f32 sum one at a
    time, segment after segment; a column at or past ``dim`` adds nothing."""
    w = xf.shape[-1]
    seg = 8 * elems
    tile = xf.reshape(*xf.shape[:-1], w // seg, 8, elems)
    live = (torch.arange(w) < dim).reshape(w // seg, 8, elems)

    def sums(t):
        t = t.reshape(tile.shape)
        acc = torch.zeros(t.shape[:-3] + (8,), dtype=F32)
        for panel in range(t.shape[-3]):
            for i in range(elems):
                acc = torch.where(live[panel, :, i], acc + t[..., panel, :, i],
                                  acc)
        return acc

    return _finish(sums, xf, dim, live)


def _stats_streamed(xf, dim, elems=8, fault=None):
    """(mean, rstd) of ln_rows_kernel (bf16, prenormed) and row_stats_kernel
    (float32, streamed): each lane reads its 16-byte chunks of the row of x
    in the order the chunks come, and sums them as the resident tile's
    lanes do.
    ``fault="width"``: the statistics over the padded width (zero columns
    in the sums, divided by it), as a launch handed ln_dim = W would take
    them."""
    w = xf.shape[-1]
    if fault == "width":
        dim = w

    def sums(t):
        acc = [torch.zeros(t.shape[:-1], dtype=F32) for _ in range(8)]
        for col0 in range(0, w, elems):
            lane = (col0 // elems) % 8
            for col in range(col0, min(col0 + elems, dim)):
                acc[lane] = acc[lane] + t[..., col]
        return torch.stack(acc, -1)

    return _finish(sums, xf, dim, None)


def _attention(q, k, v, heads, fault=None):
    """The mma attention on (B, S, heads * dh): f32 scores (``_steps``)
    times dh^-1/2, the row maximum over all keys, p = exp(s - m), l =
    sum(p), P.V with p exact (the kernel's hi + mid + lo: 12 chained 16-key
    steps a 64-key block, each block in a fresh accumulator), the blocks
    added in f32, one division and one rounding.  ``fault="p_bf16"`` rounds
    p to bf16 before P.V; ``fault="chained"`` chains the score steps."""
    b, s, d = q.shape
    dh = d // heads

    def split(t):
        return t.reshape(b, s, heads, dh).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    sc = _steps(q, k.transpose(-1, -2), fault == "chained")
    sc = sc * torch.tensor(dh ** -0.5, dtype=F32)
    p = torch.exp(sc - sc.max(-1, keepdim=True).values)
    l = p.double().sum(-1, keepdim=True).float()
    if fault == "p_bf16":
        terms = [p.to(BF16)]
    else:
        hi = p.to(BF16)
        mid = (p - hi.float()).to(BF16)
        terms = [hi, mid, (p - hi.float() - mid.float()).to(BF16)]
    o = torch.zeros(q.shape)
    for k0 in range(0, s, 64):
        acc = None
        for j in range(k0, min(k0 + 64, s), 16):
            for t in terms:
                part = t[..., j:j + 16].double() @ v[..., j:j + 16, :].double()
                acc = _toward_zero(part if acc is None else acc.double() + part)
        o = o + acc
    return (o / l).to(BF16).transpose(1, 2).reshape(b, s, d)


def emulate_encoder(x, blocks, heads, fault=None, dim=None, stats=None):
    """The encoder kernel's mma variant on the CPU, block by block at the
    twin's rounding points.  ``dim``: x and the blocks zero-padded in width
    (``vit_block._pad_width``), the LayerNorm over the first ``dim``
    columns; ``stats``: the LN statistics in the kernels' order
    (``_layer_norm``)."""
    chained = fault == "chained"
    for p in blocks:
        q, k, v = torch.chunk(_product(_layer_norm(x, p["ln1"], dim, stats),
                                       p["qkv"], chained), 3, -1)
        a = _attention(q, k, v, heads, fault)
        x = (x.float() + _product(a, p["proj"], chained).float()).to(BF16)
        g = F.gelu(_product(_layer_norm(x, p["ln2"], dim, stats), p["mlp1"],
                            chained).float(), approximate="tanh").to(BF16)
        x = (x.float() + _product(g, p["mlp2"], chained).float()).to(BF16)
    return x


@pytest.fixture(scope="module")
def flagship():
    """The flagship's shipped weights in bf16, the final LN and the encoder
    input of 8 real search crops of the entry frame (the tracker's own and
    7 shifted by up to 60 px)."""
    cfg = PRESETS["vittrack-t"]
    _, (params, state, frame) = entry(device=CPU)
    blocks = [vit.cast_params(bp, BF16) for bp in params["backbone"]["blocks"]]
    crops = []
    for i in range(8):
        shift = ([0.0] * 4 if i == 0
                 else [40.0 * (i % 4) - 60, 30.0 * (i // 4) - 45, 0.0, 0.0])
        win = tpp.crop_window(state.bbox + torch.tensor(shift), cfg.search_factor)
        x_tok = vit.embed_search(params["backbone"], core._prep_nv12(
            frame, win, cfg.search_size, cfg)[None], cfg)
        crops.append(torch.cat([state.z_tok[None], x_tok], 1).contiguous())
    return cfg, blocks, params["backbone"]["norm"], crops


def _readings(flagship, fault=None):
    """Per crop: (mean|d|, max|d| / max|twin|) of the encoder output against
    the twin, and after the final LN the largest and mean distance from the
    float64 chain of the emulation and of the twin."""
    cfg, blocks, norm, crops = flagship
    rows = []
    for x in crops:
        twin = vit_block.encoder_reference(x, blocks, cfg.num_heads)
        emu = emulate_encoder(x, blocks, cfg.num_heads, fault)
        exact = vit.layer_norm(vit_block.float64_chain(x, blocks, cfg.num_heads),
                               norm).float()
        d = (emu.float() - twin.float()).abs()
        de = (vit.layer_norm(emu, norm).float() - exact).abs()
        dt = (vit.layer_norm(twin, norm).float() - exact).abs()
        rows.append((d.mean().item(), d.max().item() / twin.float().abs().max().item(),
                     de.max().item(), dt.max().item(), de.mean().item(),
                     dt.mean().item()))
    return np.asarray(rows)


def test_emulation_matches_twin_at_flagship_depth(flagship):
    r = _readings(flagship)
    assert (r[:, 0] <= EMU_MEAN_TOL).all(), r[:, 0]
    assert (r[:, 1] <= ENC_REL_TOL).all(), r[:, 1]
    assert (r[:, 2] <= r[:, 3] + LN_MARGIN).all(), r[:, 2:4]
    assert r[:, 4].mean() <= LN_MEAN_RATIO * r[:, 5].mean(), r[:, 4:6]


def test_planted_fault_is_caught(flagship):
    # p rounded to bf16 before P.V (the attention kernels' arithmetic, not
    # the twin's): the flagship-depth yardsticks above must fail it.
    r = _readings(flagship, fault="p_bf16")
    assert r[:, 0].mean() > EMU_MEAN_TOL, r[:, 0]
    assert r[:, 4].mean() > LN_MEAN_RATIO * r[:, 5].mean(), r[:, 4:6]


@pytest.mark.parametrize("elems", [8, 4])        # bf16 (mma), float32 (tf32x3)
@pytest.mark.parametrize("dim,width", [(96, 128), (192, 192), (384, 384),
                                       (600, 640), (768, 768)])
def test_streamed_ln_statistics_equal_the_resident_ones(dim, width, elems):
    # The streamed form's statistics (row_stats_kernel, reading x chunk by
    # chunk) in the resident form's order bit for bit at every width the
    # resident form takes (the padded ones too), and so the LN output of
    # the streamed products equals the resident one's; both are the LN the
    # float64-sum emulation computes, to a few f32 ulps of the mean.
    gen = torch.Generator().manual_seed(dim)
    x = 3.0 * torch.randn((2, 9, width), generator=gen) + 0.5
    x[..., dim:] = 0.0                         # the residual stream's pad
    x = x.to(BF16).float()
    p = {"scale": F.pad(1.0 + 0.1 * torch.randn(dim, generator=gen),
                        (0, width - dim)),
         "bias": F.pad(0.1 * torch.randn(dim, generator=gen), (0, width - dim))}
    res = _stats_resident(x, dim, elems)
    streamed = _stats_streamed(x, dim, elems)
    assert all(torch.equal(a, b) for a, b in zip(res, streamed))
    assert torch.equal(_layer_norm(x, p, dim, lambda t, n: res),
                       _layer_norm(x, p, dim, lambda t, n: streamed))
    mu64 = x[..., :dim].double().mean(-1, keepdim=True)
    assert (res[0].double() - mu64).abs().max() <= 1e-6 * mu64.abs().max()
    assert (_layer_norm(x, p, dim, lambda t, n: res).float()
            - _layer_norm(x, p, dim).float()).abs().max() <= 2.0 ** -6


@pytest.mark.parametrize("dim,width", [(992, 1024), (1024, 1024),
                                       (1280, 1280)])
def test_ln_rows_plain_version_equals_the_streamed_statistics_ln(dim, width):
    # The prenormed form's LN rows (ln_rows_kernel's plain version in the
    # port) are the LayerNorm with the statistics in the kernels' order,
    # bit for bit: what the resident form writes into its A tile.
    gen = torch.Generator().manual_seed(dim)
    x = 3.0 * torch.randn((2, 9, width), generator=gen) + 0.5
    x[..., dim:] = 0.0                         # the residual stream's pad
    x = x.to(BF16)
    p = {"scale": F.pad(1.0 + 0.1 * torch.randn(dim, generator=gen),
                        (0, width - dim)).to(BF16),
         "bias": F.pad(0.1 * torch.randn(dim, generator=gen),
                       (0, width - dim)).to(BF16)}
    got = vit_block.ln_rows_reference(x, p["scale"], p["bias"], dim)
    want = _layer_norm(x, p, dim, lambda t, n: _stats_streamed(t, n))
    assert got.dtype == BF16 and torch.equal(got, want)
    assert torch.equal(got[..., dim:], torch.zeros_like(got[..., dim:]))


def _wide_blocks(d, depth, seed):
    gen = torch.Generator().manual_seed(seed)

    def w(*shape, std=0.1, base=0.0):
        return (base + std * torch.randn(shape, generator=gen)).to(BF16)

    h = 4 * d
    return [{"ln1": {"scale": w(d, base=1.0), "bias": w(d)},
             "ln2": {"scale": w(d, base=1.0), "bias": w(d)},
             "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5), "bias": w(3 * d)},
             "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d)},
             "mlp1": {"kernel": w(d, h, std=d ** -0.5), "bias": w(h)},
             "mlp2": {"kernel": w(h, d, std=h ** -0.5), "bias": w(d)}}
            for _ in range(depth)]


# The prenormed emulation against the twin at ViT-L's width (D 1024, 16
# heads) and at D 992 (31 heads of 32, run as D 1024), 20 tokens, depth 2,
# seeded weights: read max|d| / max|twin| 0.0063 and 0.0070, mean|d|
# 0.0025 and 0.0027 (bounds: ENC_REL_TOL and WIDE_MEAN_TOL); the planted
# fault, the statistics over the padded width (ln_dim = W), reads 0.014 and
# 0.024 at D 992: caught by both.  The LN rows take _stats_streamed's
# statistics, which ln_rows_kernel's plain version equals bit for bit
# (test_ln_rows_plain_version_equals_the_streamed_statistics_ln).
WIDE_MEAN_TOL = 0.005


@pytest.mark.parametrize("dim,heads,fault", [(1024, 16, None), (992, 31, None),
                                             (992, 31, "width")])
def test_streamed_ln_emulation_against_twin(dim, heads, fault):
    blocks = _wide_blocks(dim, 2, seed=dim)
    gen = torch.Generator().manual_seed(dim + 1)
    x = (2.0 * torch.randn((1, 20, dim), generator=gen)).to(BF16)
    twin = vit_block.encoder_reference(x, blocks, heads)
    flat = [b[m][f] for b in blocks for m, f in vit_block._FIELDS]
    # At the tracker's 320 tokens the card writes these widths' LN rows
    # once (prenormed).
    chosen = vit_block.plan(1, 320, dim, heads, 4 * dim, BF16, H100_SMS)
    assert chosen.ln == "prenormed" and (chosen.width or dim) == 1024
    ops = vit_block._operands(flat, 2, BF16, heads)
    padded = vit_block._blocks_from_flat(
        [ops[f][i] for i in range(2) for f in range(len(vit_block._FIELDS))], 2)
    xp = F.pad(x, (0, 1024 - dim))
    emu = emulate_encoder(
        xp, padded, heads, dim=dim,
        stats=lambda t, n: _stats_streamed(t, n, fault=fault))[..., :dim]
    d = (emu.float() - twin.float()).abs()
    rel, mean = d.max().item() / twin.float().abs().max().item(), d.mean().item()
    if fault is None:
        assert rel <= ENC_REL_TOL and mean <= WIDE_MEAN_TOL, (rel, mean)
    else:
        assert rel > ENC_REL_TOL and mean > WIDE_MEAN_TOL, (rel, mean)


def test_profile_rewrites_find_their_statements():
    # profile_encoder.py's cut and arith builds rewrite statements of
    # csrc/encoder_mma.cuh in a copy; each must stand there once (the
    # builds raise on the card otherwise).
    from gstreamer_vit_tracker_tpu_torch import profile_encoder as pe

    with open(f"{pe.cuda_build.CSRC}/encoder_mma.cuh") as f:
        src = f.read()
    for old in [old for old, _ in pe._CUT.values()] + [pe._MEAN, pe._VAR,
                                                        pe._RSQRT]:
        assert src.count(old) == 1, old


@pytest.mark.parametrize("b,s,d", [(2, 320, 64), (1, 70, 32), (3, 129, 128)])
def test_emulated_attention_matches_jax_kernel(b, s, d):
    # One head of the mma attention against JAX's Pallas kernel in
    # interpret mode: one output ulp, as the twin (2^-8 of the largest).
    rng = np.random.default_rng(40 + s)
    q, k, v = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True),
        np.float32)
    got = _attention(*(torch.from_numpy(a).to(BF16) for a in (q, k, v)), 1)
    assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -8 * np.abs(ref).max()


def test_free_running_trajectories_emulation_vs_twin(flagship, monkeypatch):
    # chip_smoke.py's unbatched check on the CPU, 3 steps run free from the
    # same first frame, 2 px / 0.02, the emulation in the encoder's place
    # against the twin, on 8 clips (the first is chip_smoke.py's).  A
    # free-running bf16 trajectory crosses near-ties (one bf16 step of the
    # size map at the peak moves the box 0.47 px and the next crop with it),
    # so any other summation order misses the bound on some clips: here the
    # emulation held 6 of 8 (the card's own count is profile_encoder.py's
    # ``lottery``).  Held: at least 6 of the 8.
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights

    cfg = flagship[0]
    params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("vittrack-t"), cfg, device=CPU))

    def trajectory(frames, box):
        st = core.init(params, frames[0], box, cfg, device=CPU,
                       frame_format="nv12")
        rows = []
        for f in frames[1:]:
            st, out = core.update_packed(params, st, f, cfg, device=CPU,
                                         frame_format="nv12")
            rows.append(out.numpy())
        return np.stack(rows)

    # (frames, the first box as drawn): chip_smoke.py's clip, then 7 more.
    specs = [((880, 480, 96, 72), (3, 2))] + [
        ((300 + 70 * c, 200 + 45 * c, 96 - 4 * (c % 3), 72 + 6 * (c % 4)),
         ((3, 2), (-2, 2), (2, -1), (-3, -2))[c % 4]) for c in range(1, 8)]
    clips = [(nv12_clip(4, box=box, step=step)[0], tuple(map(float, box)))
             for box, step in specs]
    twins = [trajectory(*c) for c in clips]
    monkeypatch.setattr(vit_block, "encoder_reference", emulate_encoder)
    held = []
    for c, twin in zip(clips, twins):
        emu = trajectory(*c)
        assert np.isfinite(emu).all()
        held.append(np.abs(emu[:, :4] - twin[:, :4]).max() <= 2.0
                    and np.abs(emu[:, 4] - twin[:, 4]).max() <= 0.02)
    assert sum(held) >= 6, held


# ---------------------------------------------------------------------------
# Operands made once per parameter set
# ---------------------------------------------------------------------------

def _flat(depth, d=32, hidden=64, grad=False):
    gen = torch.Generator().manual_seed(depth)
    shapes = [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, hidden), (hidden,), (hidden, d), (d,)]
    return [torch.randn(s, generator=gen).requires_grad_(grad)
            for _ in range(depth) for s in shapes]


def test_operand_cache_reused_across_calls():
    flat = _flat(2)
    a = vit_block._operands(flat, 2, BF16)
    assert vit_block._operands(flat, 2, BF16) is a
    # D 32 runs padded to 64 in bf16: the qkv kernel's rows past 32 are 0.
    assert torch.equal(a[2][:, :32], torch.stack([flat[2], flat[14]]).to(BF16))
    assert a[2].shape == (2, 64, 96) and not a[2][:, 32:].any()
    # Another dtype is another entry.
    assert vit_block._operands(flat, 2, F32) is not a


def test_operand_cache_rebuilt_after_in_place_update():
    flat = _flat(2)
    a = vit_block._operands(flat, 2, BF16)
    with torch.no_grad():
        flat[4].add_(1.0)            # an optimiser step: same tensor, new version
    b = vit_block._operands(flat, 2, BF16)
    assert b is not a
    assert torch.equal(b[4][0][:, :32], flat[4].to(BF16))
    # A new leaf in the same place is a new parameter set too.
    flat[0] = flat[0].clone()
    assert vit_block._operands(flat, 2, BF16) is not b


def test_operand_cache_bypassed_under_a_gradient():
    x = torch.zeros((1, 5, 32), dtype=BF16)
    flat = _flat(1, grad=True)
    assert vit_block._launch_operands(x, flat, 1) is None
    with torch.no_grad():
        got = vit_block._launch_operands(x, flat, 1)
    assert got is not None and not any(t.requires_grad for t in got)
    assert vit_block._launch_operands(x, [t.detach() for t in flat],
                                      1) is not None


def _padded_twin(x, stacked, heads, pad):
    """The twin's block math (``models/vit.py::_block``) on weights stacked
    over depth whose heads are zero-padded to ``pad``: the attention at the
    padded head dim with the true one's scale, the output's padded columns
    multiplied by the proj weight's zero rows."""
    b, s, d = x.shape
    for layer in range(stacked[0].shape[0]):
        p = {}
        for (mod, field), t in zip(vit_block._FIELDS, stacked):
            p.setdefault(mod, {})[field] = t[layer]
        q, k, v = torch.chunk(vit._linear(vit.layer_norm(x, p["ln1"]), p["qkv"]),
                              3, dim=-1)
        a = tattn.attention_reference(*(tattn._split(t, heads) for t in (q, k, v)),
                                      head_dim=d // heads)
        x = x + vit._linear(a.transpose(1, 2).reshape(b, s, heads * pad), p["proj"])
        g = F.gelu(vit._linear(vit.layer_norm(x, p["ln2"]), p["mlp1"]).float(),
                   approximate="tanh").to(x.dtype)
        x = x + vit._linear(g, p["mlp2"])
    return x


@pytest.mark.parametrize("variant,d,heads", [
    ("simt", 48, 4), ("simt", 96, 4), ("mma", 192, 4), ("mma", 64, 8),
    ("tf32x3", 96, 8), ("tf32x3", 64, 16)])
def test_padded_heads_through_the_twin_equal_the_unpadded(variant, d, heads):
    # The operand cache pads float32 heads for "simt" (12 -> 16, 24 -> 32,
    # asked for by name: tf32x3 takes D 96 with dh 24 as it is); the same
    # function pads them as "mma" (48 -> 64, 8 -> 32) and "tf32x3" (12 -> 16,
    # 4 -> 8) would, here in float32 arithmetic (tf32x3's cache also splits
    # them: tests/test_torch_encoder_tf32.py).  Zero columns of qkv, zero
    # rows of proj, the true head dim's scale: the twin on the padded
    # weights equals the unpadded twin to 1e-6.
    depth, dh = 2, d // heads
    pad = vit_block.head_pad(variant, dh)
    assert pad > dh
    flat = _flat(depth, d=d, hidden=2 * d)
    flat = [t * (d ** -0.5 if t.dim() == 2 else 0.1) for t in flat]
    if variant == "simt":
        stacked = vit_block._operands(flat, depth, F32, heads, "simt")
        assert vit_block._operands(flat, depth, F32, heads, "simt") is stacked
    else:
        stacked = vit_block._pad_heads(vit_block._stack(flat, depth), heads, pad)
    e = heads * pad
    assert stacked[2].shape == (depth, d, 3 * e) and stacked[3].shape == (depth, 3 * e)
    assert stacked[4].shape == (depth, e, d)
    cols = torch.arange(3 * e) % pad < dh
    assert not stacked[2][..., ~cols].any() and not stacked[3][..., ~cols].any()
    assert not stacked[4][:, torch.arange(e) % pad >= dh].any()
    gen = torch.Generator().manual_seed(d + heads)
    x = torch.randn((2, 21, d), generator=gen)
    want = vit_block.encoder_reference(x, vit_block._blocks_from_flat(flat, depth),
                                       heads)
    got = _padded_twin(x, stacked, heads, pad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def _width_padded_twin(x, stacked, heads, pad):
    """The twin's block math on weights stacked over depth whose D and MLP
    width are zero-padded (``vit_block._pad_width``) and whose heads are
    padded to ``pad``: x carried at the padded width with zero columns, the
    LayerNorm's mean and variance over x's true D alone (as the mma
    prologue takes them), the attention at the padded head dim with the
    true one's scale.  Every padded column must stay exactly 0."""
    b, s, d = x.shape
    width = stacked[0].shape[-1]
    x = F.pad(x, (0, width - d))

    def ln(t, p):
        mu = t[..., :d].mean(-1, keepdim=True)
        var = ((t[..., :d] - mu) ** 2).mean(-1, keepdim=True)
        return (t - mu) / torch.sqrt(var + 1e-6) * p["scale"] + p["bias"]

    for layer in range(stacked[0].shape[0]):
        p = {}
        for (mod, field), t in zip(vit_block._FIELDS, stacked):
            p.setdefault(mod, {})[field] = t[layer]
        q, k, v = torch.chunk(vit._linear(ln(x, p["ln1"]), p["qkv"]), 3, dim=-1)
        a = tattn.attention_reference(*(tattn._split(t, heads) for t in (q, k, v)),
                                      head_dim=d // heads)
        x = x + vit._linear(a.transpose(1, 2).reshape(b, s, heads * pad), p["proj"])
        assert not x[..., d:].any()
        g = F.gelu(vit._linear(ln(x, p["ln2"]), p["mlp1"]), approximate="tanh")
        x = x + vit._linear(g, p["mlp2"])
        assert not x[..., d:].any()
    return x[..., :d]


@pytest.mark.parametrize("d,heads,hidden,width,mlp", [
    (96, 2, 384, 128, 384),     # the small architecture in bf16: dh 48 -> 64
    (96, 3, 400, 128, 448),     # dh 32 as it is; both widths padded
    (160, 5, 640, 192, 640),
    (40, 8, 100, 64, 128)])     # dh 5 -> 32
def test_padded_width_through_the_twin_equals_the_unpadded(d, heads, hidden,
                                                           width, mlp):
    # The operand cache pads mma's D and MLP width to multiples of 64 (here
    # in float32 arithmetic, the same function): zero LN scale and bias past
    # D, zero rows of qkv / mlp1 / mlp2 past their K, zero columns of proj /
    # mlp1 / mlp2 and their biases.  With x carried at the padded width and
    # the LayerNorm's statistics over the true D, the twin on the padded
    # weights equals the unpadded twin to 1e-6, and the padded columns stay
    # 0 through every block (GELU(0) = 0).
    depth, dh = 2, d // heads
    pad = vit_block.head_pad("mma", dh) or dh
    assert vit_block.width_pads("mma", d, hidden) == (
        width, 0 if mlp == hidden else mlp)
    flat = _flat(depth, d=d, hidden=hidden)
    flat = [t * (d ** -0.5 if t.dim() == 2 else 0.1) for t in flat]
    stacked = vit_block._operands(flat, depth, F32, heads, "mma")
    assert vit_block._operands(flat, depth, F32, heads, "mma") is stacked
    e = heads * pad
    assert [tuple(t.shape[1:]) for t in stacked] == [
        (width,), (width,), (width, 3 * e), (3 * e,), (e, width), (width,),
        (width,), (width,), (width, mlp), (mlp,), (mlp, width), (width,)]
    for i in (0, 1, 4, 5, 6, 7, 11):
        assert not stacked[i][..., d:].any()
    assert not stacked[2][:, d:].any() and not stacked[8][:, d:].any()
    assert not stacked[8][..., hidden:].any() and not stacked[9][:, hidden:].any()
    assert not stacked[10][:, hidden:].any()
    gen = torch.Generator().manual_seed(d + heads)
    x = torch.randn((2, 21, d), generator=gen)
    want = vit_block.encoder_reference(x, vit_block._blocks_from_flat(flat, depth),
                                       heads)
    got = _width_padded_twin(x, stacked, heads, pad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,heads,hidden", [(96, 3, 384), (160, 5, 400)])
def test_padded_width_leaves_the_mma_arithmetic_bit_for_bit(d, heads, hidden):
    # The mma emulation on width-padded bf16 operands (x with zero columns,
    # the LayerNorm over the true D) equals it on the unpadded ones bit for
    # bit: a padded K adds 16-deep steps of exact zeros, and a padded column
    # comes out 0 in every block (head dims 32 here, so no head padding
    # reorders the proj product's chunks).
    depth = 2
    flat = [(t * (d ** -0.5 if t.dim() == 2 else 0.1)).to(BF16)
            for t in _flat(depth, d=d, hidden=hidden)]
    blocks = vit_block._blocks_from_flat(flat, depth)
    width, mlp = vit_block.width_pads("mma", d, hidden)
    stacked = vit_block._pad_width(vit_block._stack(flat, depth), width,
                                   mlp or hidden)
    padded = vit_block._blocks_from_flat(
        [t[i] for i in range(depth) for t in stacked], depth)
    gen = torch.Generator().manual_seed(d)
    x = torch.randn((1, 70, d), generator=gen).to(BF16)
    want = emulate_encoder(x, blocks, heads)
    got = emulate_encoder(F.pad(x, (0, width - d)), padded, heads, dim=d)
    assert torch.equal(got[..., :d], want) and not got[..., d:].any()


def test_encode_passes_masters_and_keeps_the_cpu_path():
    # encode(fused) hands the float32 masters over; on the CPU the result is
    # the twin on the cast weights, as before, and a gradient reaches them.
    cfg = PRESETS["small"]
    from gstreamer_vit_tracker_tpu_torch.models import weights

    bb = weights.load_npz(weights.checkpoint_path("small"), cfg,
                          device=CPU)["backbone"]
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((1, cfg.num_template_tokens, cfg.embed_dim), generator=gen)
    x = torch.randn((1, cfg.num_search_tokens, cfg.embed_dim), generator=gen)
    got = vit.encode(bb, z, x, cfg, fused=True)
    blocks = [vit.cast_params(p, F32) for p in bb["blocks"]]
    want = vit_block.encoder_reference(torch.cat([z, x], 1), blocks, cfg.num_heads)
    want = vit.layer_norm(want, bb["norm"])[:, z.shape[1]:]
    assert torch.equal(got, want)
    leaf = bb["blocks"][0]["qkv"]["kernel"].requires_grad_(True)
    (g,) = torch.autograd.grad(vit.encode(bb, z, x, cfg, fused=True).sum(), [leaf])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# ---------------------------------------------------------------------------
# The attention rule on odd shapes: a head dim no kernel takes raises on the
# card; a layout the kernels cannot read in place is copied
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,dh,dtype", [
    (320, 12, F32), (320, 136, F32), (33, 4, BF16)])
def test_attention_plan_refuses_odd_head_dims(s, dh, dtype):
    # Above 128 the head dim runs in 64-column panels: float32 takes 136 as
    # it is (a multiple of 8; the ragged last panel is zero-filled in shared
    # memory), 64-key blocks through the ring of panel stages that fills
    # the card beside its three resident q panels, one panel of o a CTA
    # (one head: 5 CTAs).  Below, one that is no
    # multiple of 8 is padded: float32 to the next multiple of 8 (tf32x3),
    # bf16 to 32 (mma); the kernel runs at the padded dim with the true
    # one's scale.
    if dh > 128:
        got = tattn.plan(s, dh, dtype, H100_OPTIN)
        assert got == tattn.Plan("flash", "tf32x3", kb=64, stages=5, group=1)
        assert tattn.entry_head_dims(dh, got) == (dh, dh)
        return
    got = tattn.plan(s, dh, dtype, H100_OPTIN)
    pad, variant = {F32: (16, "tf32x3"), BF16: (32, "mma")}[dtype]
    assert got.pad == pad and got.variant == variant
    assert got._replace(pad=0) == tattn.plan(s, pad, dtype, H100_OPTIN)
    assert tattn.entry_head_dims(dh, got) == (pad, dh)


def _odd_case(case, rng):
    """(q, k, v) as CPU tensors laid out as the case says, their contiguous
    numpy values, and the head count."""
    if case == "head dim 12":
        arrs = [rng.standard_normal((2, 37, 24)).astype(np.float32) for _ in range(3)]
        return [torch.from_numpy(a) for a in arrs], arrs, 2
    if case == "last dim not contiguous":
        arrs = [rng.standard_normal((2, 37, 64)).astype(np.float32) for _ in range(3)]
        ts = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).transpose(1, 2)
              for a in arrs]
        return ts, arrs, 2
    # base off by 8 bytes: a view two floats into a wider buffer
    arrs = [rng.standard_normal((2, 37, 64)).astype(np.float32) for _ in range(3)]
    ts = []
    for a in arrs:
        buf = torch.zeros((2, 37, 66))
        buf[..., 2:] = torch.from_numpy(a)
        ts.append(buf[..., 2:])
    return ts, arrs, 2


@pytest.mark.parametrize("case", ["head dim 12", "last dim not contiguous",
                                  "base not 16-byte aligned"])
def test_odd_attention_shapes_take_the_plain_version(case):
    # On the CPU each odd shape takes the plain version, which equals JAX's
    # use_pallas=None.  On the card: the head dim raises before any launch;
    # the two layouts reach the kernel as contiguous copies of the same
    # values, which it reads in place.
    rng = np.random.default_rng(77)
    (q, k, v), arrs, heads = _odd_case(case, rng)
    got = tattn.multihead_attention(q, k, v, heads)
    ref = jattn.multihead_attention(*map(jnp.asarray, arrs), heads,
                                    use_pallas=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if case == "head dim 12":
        # On the card it runs zero-padded to 16: the padded copies through
        # the plain version with the true head dim's scale give the same.
        assert tattn.plan(q.shape[1], 12, q.dtype, H100_OPTIN).pad == 16
        padded = [tattn._padded(t, heads, 16) for t in (q, k, v)]
        assert padded[0].shape == (2, 37, 32) and padded[0].is_contiguous()
        out = tattn.attention_reference(
            *(tattn._split(t, heads) for t in padded), head_dim=12)
        out = out[..., :12].transpose(1, 2).reshape(q.shape)
        np.testing.assert_allclose(out.numpy(), got.numpy(), rtol=1e-6,
                                   atol=1e-6)
        return
    assert not any(map(tattn._aligned, (q, k, v)))
    laid = tattn._laid_out(q, k, v)
    assert all(map(tattn._aligned, laid))
    assert all(torch.equal(a, b) for a, b in zip(laid, (q, k, v)))
