"""The whole ViT encoder, and one block of it, as CUDA kernel calls with
their plain twins.

Port of ``gstreamer_vit_tracker_tpu/ops/vit_block.py::encoder``, whose TPU
kernel ``_encoder_kernel`` runs every block in one ``pallas_call`` with the
activation carried in VMEM.  Here the kernel is
``csrc/vit_encoder.cu::vit_encoder_forward``: a host loop over depth that
launches a block's products and attention on the caller's stream.  The
source's header states what bounds it on the H100.

:func:`plan` decides before any launch, from the shape alone, what a call
takes (a rule, not a fallback; the C entries take the plan's variant and
N tiles as ints):

* ``"mma"``: bf16 with D up to 768 and any MLP width (every bf16 preset,
  and the ``small`` architecture in bf16, D 96).  Five launches a block:
  ``wgmma`` products with the LayerNorm in the prologue of the qkv and mlp1
  products and the bias / GELU / residual epilogue on the accumulator
  registers, and an attention that reads q, k and v from the qkv buffer
  where they lie and walks blocks of 64 keys twice (the row maximum, then
  ``expf`` of the twin's own argument and P.V with p in f32 precision).
* ``"tf32x3"``: float32 (the ``small`` preset, the float32 flagship of the
  dry run and of training) with a head dim that is a multiple of 8 up to
  128, D (up to 512) and the MLP width multiples of 32.  The same five
  launches a block (``csrc/encoder_tf32.cuh``), the products on the tensor
  cores in split TF32 (``mma.sync``, three TF32 products a product into one
  f32 accumulator: float32's accuracy), the LayerNorm in the prologue with
  the twin's roundings, bias / GELU / residual in the epilogue, and the
  attention of ``csrc/attention_tf32.cuh`` on the qkv buffer's head slices
  (64-key blocks, online softmax).  At batch 1 (``Plan.warpgroups``) each CTA
  is two warpgroups that share a query tile's key blocks or a product's
  K.  Its weights arrive split, hi =
  tf32(w) and lo = tf32(w - hi) (:func:`split_tf32`), made once per
  parameter set by the operand cache; the kernels split only the
  activations.
* ``"simt"``: float32 on a shape ``"tf32x3"`` does not take (D above 512
  or no multiple of 32, an MLP width that is a multiple of 16 but not of
  32), with a head dim that is a multiple of 16 up to 128: the first
  design's seven launches a block on the FMA units, an attention that
  walks blocks of 32 keys twice.  Callable by name on any float32 shape it takes
  (``prepared(..., chosen=Plan("simt"))``): the yardstick of the timings.

A head dim from 1 to 128 that the variant does not take as it is (bf16: not
32, 64 or 128; ``"tf32x3"``: not a multiple of 8; ``"simt"``: not a
multiple of 16) is zero-padded to the next one it takes: the qkv weight and
bias get zero columns a head and the proj weight zero rows a head (in the
operand cache, so once per parameter set), the attention runs at the padded
head dim with the true one's scale.  ``"mma"`` also pads a D or an MLP width
that is no multiple of 64 (its products' K chunk) to the next one,
``Plan.width`` and ``Plan.mlp`` (:func:`_pad_width`: zero LN scale and bias,
zero rows of the qkv and mlp1 kernels and of mlp2's past the MLP width, zero
columns of proj, mlp1 and mlp2 and their biases): the kernel carries the
residual stream at the padded width with zero columns, takes the LayerNorm's
statistics over the true D, and copies x in and the result out at D
(``csrc/vit_encoder.cu``'s header says why every padded column stays 0).
Zeros add exactly to an f32 sum: a padded head or width computes what the
unpadded one does.  A CUDA call on a shape no variant of its dtype can take
even so (a head dim above 128; for ``"mma"`` D above 768; in float32 an MLP
width no multiple of 16) raises; none goes to the plain twin.  An x or a
weight that is not contiguous with a 16-byte aligned base is copied into
one that is before the launch.  Neither kernel needs more shared memory for
a longer sequence: both walk the keys through a ring of fixed size.

:func:`encoder` takes the kernel for a CUDA tensor and the plain twin
:func:`encoder_reference` (a chain of ``models/vit.py::_block``, which
rounds where the kernel rounds) for a CPU tensor; it has no fallback from
one to the other.  It casts the blocks' leaves to ``x.dtype``.  On the card,
when a gradient is needed, it is a ``torch.autograd.Function`` whose
backward differentiates the plain twin, as the JAX ``custom_vjp`` does;
without one it launches directly, on weights cast and stacked over depth
once per parameter set (``_operands``) rather than on every call.

:func:`block` is the port of the TPU's per-block kernel ``_block_kernel``
(``vit_block.block``: one block, a grid over the batch): the entry
``vit_block_forward`` of the same source, one block's own weights, any
batch, the same device code.  Its plain twin is :func:`block_reference`; its
backward differentiates that twin and returns gradients for ``x`` and every
leaf of the block's parameters, as ``_block_bwd`` does.

``LAUNCHES`` counts encoder-kernel launches (one per encoder call on the
card), ``BLOCK_LAUNCHES`` block-kernel launches and ``VARIANT_LAUNCHES``
both by variant, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import attention, cuda_build, operand_cache

Params = Dict[str, Any]

__all__ = ["encoder", "encoder_reference", "float64_chain", "block",
           "block_reference", "plan", "Plan", "prepared", "LAUNCHES",
           "BLOCK_LAUNCHES", "VARIANT_LAUNCHES"]

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = 0
BLOCK_LAUNCHES = 0
VARIANT_LAUNCHES = {"mma": 0, "simt": 0, "tf32x3": 0}

# Per-block parameters in the kernel's argument order: (module, field).
_FIELDS = (("ln1", "scale"), ("ln1", "bias"), ("qkv", "kernel"),
           ("qkv", "bias"), ("proj", "kernel"), ("proj", "bias"),
           ("ln2", "scale"), ("ln2", "bias"), ("mlp1", "kernel"),
           ("mlp1", "bias"), ("mlp2", "kernel"), ("mlp2", "bias"))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"simt": 0, "mma": 1, "tf32x3": 2}
# A dtype's variants, the first its own; float32 takes "simt" where
# "tf32x3" refuses a shape.
_DTYPE_VARIANTS = {torch.float32: ("tf32x3", "simt"), torch.bfloat16: ("mma",)}
_VARIANTS = {dtype: v[0] for dtype, v in _DTYPE_VARIANTS.items()}
_MAX_HEAD_DIM = 128
# Geometry of the kernels, as csrc/vit_encoder.cu and encoder_mma.cuh have
# it.  "mma": a product CTA owns 64 rows by an N tile of 32 or 64 columns and
# K arrives in 64-deep chunks (so D and the MLP width run padded to whole
# chunks); the qkv and mlp1 products hold all D / 64 chunks of their rows
# for the LayerNorm, which at D = 768 and N 64 is
# 1024 + 12 x 64 x (64 + 64) x 2 = 197,632 bytes of the H100's 232,448.  The
# attention takes 64 query rows and walks 64-key blocks through a ring of 2
# (82,944 bytes at head dim 128, for any S).  "tf32x3": the same 64 rows,
# N tiles of 16, 32 or 64, K in 32-deep chunks through a ring of 4 slots
# (3 at N 64) a warpgroup of A and the weight's two planes; the LN products
# hold their 64 rows of D and its scale and bias, which at D = 512, N 32 and
# two warpgroups is 64 x 516 x 4 + 2 x 512 x 4 + 8 x 2 x 32 x 40 x 4 =
# 218,112 bytes.  "simt": 16 query rows, 32-key blocks.
_ROWS, _CHUNK, _TF32_CHUNK = 64, 64, 32
_MMA_MAX_DIM, _TF32_MAX_DIM = 768, 512
_SPLIT_MAX_DH = 64         # "tf32x3": two-warpgroup attention built up to it


class Plan(NamedTuple):
    """What :func:`encoder` and :func:`block` launch for one shape."""
    variant: str                               # "mma", "tf32x3" or "simt"
    tiles: Tuple[int, ...] = (0, 0, 0, 0)      # N tile of qkv, proj, mlp1, mlp2
    pad: int = 0                               # padded head dim (0: none)
    warpgroups: int = 1                        # "tf32x3": warpgroups a CTA
    width: int = 0                             # "mma": padded D (0: none)
    mlp: int = 0                               # "mma": padded MLP width

    def config(self) -> Tuple[int, ...]:
        """The 6 ints the C entries take first (``Config`` in the source):
        the variant's code, the N tiles and the warpgroups."""
        return (_VARIANT_CODES[self.variant],) + self.tiles + (self.warpgroups,)


def _refusal(variant: str, dim: int, heads: int,
             hidden: int) -> Optional[str]:
    """Why ``variant`` cannot take this shape, padded or not, or None if it
    can."""
    if heads < 1 or dim % heads:
        return f"embed dim {dim} is not divisible by {heads} heads"
    if dim // heads > _MAX_HEAD_DIM:
        return f"head dim {dim // heads} is above {_MAX_HEAD_DIM}"
    if variant == "mma":
        if dim > _MMA_MAX_DIM or hidden < 1:
            return (f"embed dim {dim} must be at most {_MMA_MAX_DIM} and MLP "
                    f"width {hidden} at least 1")
        return None
    if variant == "tf32x3":
        if dim % _TF32_CHUNK or dim > _TF32_MAX_DIM or hidden % _TF32_CHUNK:
            return (f"embed dim {dim} and MLP width {hidden} must be "
                    f"multiples of 32, the embed dim at most {_TF32_MAX_DIM}")
        return None
    if hidden % 16:                                        # "simt"
        return f"MLP width {hidden} must be a multiple of 16"
    return None


def head_pad(variant: str, dh: int) -> int:
    """The head dim ``variant`` runs a head dim ``dh`` (1 to 128) at when
    it does not take it as it is, else 0: ``"mma"`` the next of 32, 64 and
    128, ``"tf32x3"`` the next multiple of 8, ``"simt"`` the next multiple
    of 16."""
    if variant == "mma":
        return 0 if dh in (32, 64, 128) else next(
            d for d in (32, 64, 128) if d > dh)
    step = 8 if variant == "tf32x3" else 16
    return 0 if dh % step == 0 else -(-dh // step) * step


def width_pads(variant: str, dim: int, hidden: int) -> Tuple[int, int]:
    """(D, MLP width) that ``variant`` runs a ``dim`` and ``hidden`` at
    when it does not take them as they are, else 0 each: ``"mma"`` the next
    multiple of 64 (its products' K chunk); the float32 variants pad
    neither."""
    if variant != "mma":
        return 0, 0
    return tuple(0 if n % _CHUNK == 0 else -(-n // _CHUNK) * _CHUNK
                 for n in (dim, hidden))


def _variant(dtype: torch.dtype, dim: int, heads: int,
             hidden: int) -> Optional[str]:
    """The variant :func:`plan` gives this dtype and width (the first of
    the dtype's that takes it), or None if none does."""
    return next((v for v in _DTYPE_VARIANTS.get(dtype, ())
                 if _refusal(v, dim, heads, hidden) is None), None)


def _tiles(rows: int, inner: int, dim: int, hidden: int, sms: int,
           narrow: bool) -> Tuple[int, ...]:
    """The N tile of each product for ``rows`` 64-row tiles: 64 once
    64-wide tiles give a grid of at least ``sms`` CTAs, else 32; with
    ``narrow`` (``"tf32x3"``) 16 where 32-wide tiles would leave more than
    half the card idle."""
    def tile(n):
        if rows * -(-n // 64) >= sms:
            return 64
        return 16 if narrow and 2 * rows * -(-n // 32) < sms else 32

    return tuple(tile(n) for n in (3 * inner, dim, hidden, dim))


def plan(batch: int, seq: int, dim: int, heads: int, hidden: int,
         dtype: torch.dtype, sms: int) -> Plan:
    """The variant and the product tiles for a ``(batch, seq, dim)`` input
    with ``heads`` heads and MLP width ``hidden`` on a card of ``sms`` SMs.

    * The variant: ``"mma"`` for bf16 (head dim 32, 64 or 128, dim up to
      768); for float32 ``"tf32x3"`` (head dim a multiple of 8, dim and
      hidden multiples of 32, dim up to 512), else ``"simt"`` (head dim a
      multiple of 16, hidden a multiple of 16).  Another head dim up to 128
      gets ``pad``, the one it is zero-padded to (:func:`head_pad`);
      ``"mma"``'s dim and hidden that are no multiple of 64 get ``width``
      and ``mlp``, the ones they are zero-padded to (:func:`width_pads`).
      A shape no variant of the dtype can take even so raises
      ``ValueError``; another dtype raises ``TypeError``.
    * ``"mma"`` and ``"tf32x3"`` N tile of each product (of its padded
      width): 64 once 64-wide tiles give a grid of at least ``sms`` CTAs,
      else 32 (at batch 1 the grid is the latency: more, smaller CTAs), and
      for ``"tf32x3"`` 16 where 32-wide ones would leave more than half the
      SMs idle.  On the
      flagship's shape that is 32 for every bf16 product at batch 1 and 64
      at batch 16.
    * ``"tf32x3"`` ``warpgroups``: 2 when the attention's grid (64-query tiles x
      batch x heads) is smaller than the card and the head dim it runs at is
      at most 64, else 1: two warpgroups a CTA, which in the attention share
      a query tile and take its key blocks in turn, and in a product of N
      tile 16 or 32 take its 32-deep chunks of K in turn (batch 1, where
      one warpgroup an SM leaves every latency exposed).

    Depends on the shape alone, so a chain of :func:`block` calls equals one
    :func:`encoder` call bit for bit.
    """
    if dtype not in _VARIANTS:
        raise TypeError(f"the encoder kernels take float32 or bfloat16, got "
                        f"{dtype}")
    variant = _variant(dtype, dim, heads, hidden) or _VARIANTS[dtype]
    why = (_refusal(variant, dim, heads, hidden) if batch >= 1 and seq >= 1
           else f"batch {batch} and sequence {seq} must be at least 1")
    if why is not None:
        raise ValueError(f"the encoder kernels cannot take this shape "
                         f"({variant}, {dtype}): {why}")
    pad = head_pad(variant, dim // heads)
    if variant == "simt":
        return Plan("simt", pad=pad)
    rows = -(-batch * seq // _ROWS)
    dh = pad or dim // heads
    width, mlp = width_pads(variant, dim, hidden)
    tiles = _tiles(rows, heads * dh, width or dim, mlp or hidden, sms,
                   variant == "tf32x3")
    wgs = (2 if variant == "tf32x3" and dh <= _SPLIT_MAX_DH
           and -(-seq // _ROWS) * batch * heads < sms else 1)
    return Plan(variant, tiles, pad, wgs, width, mlp)


def encoder_reference(x: torch.Tensor, blocks: Sequence[Params],
                      num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the blocks chained."""
    from ..models import vit   # vit imports this module

    for p in blocks:
        x = vit._block(x, p, num_heads)
    return x


def float64_chain(x: torch.Tensor, blocks: Sequence[Params],
                  num_heads: int) -> torch.Tensor:
    """The twin's block math with float64 arithmetic between its rounding
    points: a cast to ``x.dtype`` exactly where ``models/vit.py::_block``
    casts (after each LN, each product with its bias, the attention, each
    residual sum and the GELU), nothing rounded in between.  Where exact
    arithmetic puts the twin's output: the yardstick that the twin and the
    kernel are both measured from."""
    b, s, d = x.shape
    dh = d // num_heads

    def heads(t):
        return t.double().reshape(b, s, num_heads, dh).transpose(1, 2)

    def ln(t, p):
        t = t.double()
        mu = t.mean(-1, keepdim=True)
        var = ((t - mu) ** 2).mean(-1, keepdim=True)
        return ((t - mu) / torch.sqrt(var + 1e-6) * p["scale"].double()
                + p["bias"].double()).to(x.dtype)

    def linear(t, p):
        return (t.double() @ p["kernel"].double()
                + p["bias"].double()).to(x.dtype)

    for p in blocks:
        q, k, v = torch.chunk(linear(ln(x, p["ln1"]), p["qkv"]), 3, dim=-1)
        att = torch.softmax(heads(q) @ heads(k).transpose(-1, -2) * dh ** -0.5,
                            dim=-1)
        a = (att @ heads(v)).transpose(1, 2).reshape(b, s, d).to(x.dtype)
        x = (x.double() + linear(a, p["proj"]).double()).to(x.dtype)
        g = F.gelu(linear(ln(x, p["ln2"]), p["mlp1"]).double(),
                   approximate="tanh").to(x.dtype)
        x = (x.double() + linear(g, p["mlp2"]).double()).to(x.dtype)
    return x


_LIB: List[ctypes.CDLL] = []


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' signatures on a loaded ``vit_encoder``
    library."""
    lib.vit_encoder_forward.argtypes = ([ctypes.c_int] * 15
                                        + [ctypes.c_void_p] * 19)
    lib.vit_block_forward.argtypes = ([ctypes.c_int] * 14
                                      + [ctypes.c_void_p] * 19)
    for fn in (lib.vit_encoder_forward, lib.vit_block_forward):
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    if not _LIB:
        _LIB.append(bind(cuda_build.load("vit_encoder")))
    return _LIB[0]


def _aligned(x: torch.Tensor) -> bool:
    return x.is_contiguous() and x.data_ptr() % 16 == 0


def _laid_out(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it is contiguous with a 16-byte aligned base (what the
    kernels read), else a copy that is."""
    if _aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_x(x: torch.Tensor, num_heads: int) -> None:
    """Raise on what no plan decides about x: a CPU tensor, a dtype, a
    shape."""
    if not x.is_cuda:
        raise ValueError("the encoder kernel needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"encoder kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got shape {tuple(x.shape)}")
    d = x.shape[2]
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"embed dim {d} is not divisible by {num_heads} heads")


def _check(x: torch.Tensor, weights: List[torch.Tensor], inner: int,
           stacked: bool, split: bool = False, width: int = 0):
    """Raise on weights that do not fit x, the inner width ``inner``
    (heads x the head dim the kernels run at) and the residual width
    ``width`` (x's D, or the one it is zero-padded to).  ``weights`` in
    ``_FIELDS`` order: stacked over depth for the encoder, one block's own
    for the block kernel; ``split``: the four kernels as two planes each
    (:func:`split_planes`)."""
    d = width or x.shape[2]
    lead = (weights[0].shape[0],) if stacked else ()
    hidden = weights[8].shape[-1]
    k = (2,) if split else ()
    want = [(d,), (d,), k + (d, 3 * inner), (3 * inner,), k + (inner, d),
            (d,), (d,), (d,), k + (d, hidden), (hidden,), k + (hidden, d),
            (d,)]
    for (mod, field), t, shape in zip(_FIELDS, weights, want):
        shape = lead + shape
        if tuple(t.shape) != shape:
            raise ValueError(f"{mod}/{field}: shape {tuple(t.shape)}, "
                             f"kernel expects {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{mod}/{field}: {t.dtype} on {t.device}, "
                             f"kernel expects {x.dtype} on {x.device}")


_PLANS: Dict[Tuple, Plan] = {}   # (device, B, S, D, H, hidden, dtype) -> Plan


def _plan_for(x: torch.Tensor, heads: int, hidden: int) -> Plan:
    """:func:`plan` for this CUDA tensor, decided once per argument tuple
    (the card's SM count read once per device)."""
    b, s, d = x.shape
    key = (x.device.index, b, s, d, heads, hidden, x.dtype)
    chosen = _PLANS.get(key)
    if chosen is None:
        chosen = _PLANS[key] = plan(b, s, d, heads, hidden, x.dtype,
                                    attention.card(x.device)[1])
    return chosen


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``w`` as (hi, lo): hi = tf32(w), lo = tf32(w - hi), each
    rounded to TF32 (10 mantissa bits) to nearest with ties away from zero
    by an integer add and mask of the bits (``csrc/attention_tf32.cuh::
    to_tf32``), so hi + lo is w to about 2^-22 of it."""
    def tf32(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)

    hi = tf32(w)
    return hi, tf32(w - hi)


# Where the four kernels lie in ``_FIELDS`` order.
_KERNELS = (2, 4, 8, 10)


def split_planes(weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Weights in ``_FIELDS`` order (any leading dims) with each of the
    four kernels (..., in, out) as its two planes (..., 2, in, out), hi
    then lo (:func:`split_tf32`): what ``"tf32x3"`` reads."""
    w = list(weights)
    for i in _KERNELS:
        w[i] = torch.stack(split_tf32(w[i]), dim=-3)
    return w


def _is_split(weights: Sequence[torch.Tensor], stacked: bool) -> bool:
    return weights[2].dim() == (4 if stacked else 3)


def _pad_heads(weights: Sequence[torch.Tensor], heads: int,
               pad: int) -> List[torch.Tensor]:
    """Weights in ``_FIELDS`` order (any leading dims) with each head of
    the qkv kernel's columns, the qkv bias and the proj kernel's rows
    zero-padded from dh to ``pad``; the others as they are."""
    w = list(weights)
    d = w[4].shape[-1]
    dh = d // heads
    lead = w[2].shape[:-2]
    w[2] = F.pad(w[2].reshape(*lead, d, 3, heads, dh), (0, pad - dh)).reshape(
        *lead, d, 3 * heads * pad)
    w[3] = F.pad(w[3].reshape(*lead, 3, heads, dh), (0, pad - dh)).reshape(
        *lead, 3 * heads * pad)
    w[4] = F.pad(w[4].reshape(*lead, heads, dh, d), (0, 0, 0, pad - dh)
                 ).reshape(*lead, heads * pad, d)
    return w


def _pad_width(weights: Sequence[torch.Tensor], width: int,
               mlp: int) -> List[torch.Tensor]:
    """Weights in ``_FIELDS`` order (any leading dims, heads padded or
    not) with D zero-padded to ``width`` and the MLP width to ``mlp``: the
    LN scales and biases, the proj and mlp2 biases and the proj kernel's
    columns to ``width``; the qkv kernel's rows; mlp1's rows to ``width``
    and columns to ``mlp``, its bias to ``mlp``; mlp2's rows to ``mlp`` and
    columns to ``width``.  A leaf already at its width is as it is."""
    w = list(weights)
    dd, dm = width - w[0].shape[-1], mlp - w[8].shape[-1]

    def pad(i, *p):
        if any(p):
            w[i] = F.pad(w[i], p)

    for i in (0, 1, 4, 5, 6, 7, 11):
        pad(i, 0, dd)
    pad(2, 0, 0, 0, dd)
    pad(8, 0, dm, 0, dd)
    pad(9, 0, dm)
    pad(10, 0, dd, 0, dm)
    return w


def _named(chosen: Plan, x: torch.Tensor, heads: int, hidden: int) -> Plan:
    """A plan a caller named (``prepared(..., chosen=...)``) made whole:
    the variant must be one of the dtype's and take the shape; the pads are
    the variant's own, and ``"tf32x3"`` named without tiles gets the rule's
    tiles and warpgroups."""
    b, s, d = x.shape
    if chosen.variant not in _DTYPE_VARIANTS[x.dtype]:
        raise ValueError(f"the encoder kernels run {x.dtype} as one of "
                         f"{_DTYPE_VARIANTS[x.dtype]}, not {chosen.variant}")
    why = _refusal(chosen.variant, d, heads, hidden)
    if why is not None:
        raise ValueError(f"the encoder kernels cannot take this shape "
                         f"({chosen.variant}, {x.dtype}): {why}")
    pad = head_pad(chosen.variant, d // heads)
    width, mlp = width_pads(chosen.variant, d, hidden)
    if chosen.variant == "tf32x3" and not any(chosen.tiles):
        rule = _plan_for(x, heads, hidden)
        chosen = chosen._replace(tiles=rule.tiles, warpgroups=rule.warpgroups)
    return chosen._replace(pad=pad, width=width, mlp=mlp)


def _prepare(x: torch.Tensor, weights: List[torch.Tensor], num_heads: int,
             stacked: bool, chosen: Optional[Plan]):
    """Checks, the plan, the output and the C entry's arguments up to the
    stream, and the tensors that must live as long as the launch (x and
    weights copied where their layout asks for it, the weights' heads and
    widths zero-padded and, for ``"tf32x3"``, split where the plan asks and
    the cache did not, the scratch).  A shape the plan refuses, a
    ``chosen`` variant that is not one of the dtype's, or split weights for
    another variant, raise: a launch was asked for."""
    _check_x(x, num_heads)
    b, s, d = x.shape
    hidden = weights[8].shape[-1]
    chosen = (_plan_for(x, num_heads, hidden) if chosen is None
              else _named(chosen, x, num_heads, hidden))
    dh = chosen.pad or d // num_heads
    inner = num_heads * dh
    width = chosen.width or d
    split = _is_split(weights, stacked)
    if split and chosen.variant != "tf32x3":
        raise ValueError(f"split weights are tf32x3's, not {chosen.variant}'s")
    if not split:
        if chosen.pad and weights[2].shape[-1] == 3 * d:
            weights = _pad_heads(weights, num_heads, chosen.pad)
        if chosen.width or chosen.mlp:
            weights = _pad_width(weights, width, chosen.mlp or hidden)
        if chosen.variant == "tf32x3":
            weights, split = split_planes(weights), True
    hidden = weights[8].shape[-1]
    _check(x, weights, inner, stacked, split, width)
    x, weights = _laid_out(x), [_laid_out(t) for t in weights]
    m = b * s
    out = torch.empty_like(x)
    # One scratch allocation: qkv (m, 3 inner), attn (m, inner), mlp hidden
    # (m, hidden) and h: for "simt" the LN output (m, d), for a padded "mma"
    # width the residual stream (m, width).
    h_rows = d if chosen.variant == "simt" else (width if width != d else 0)
    work = torch.empty(m * (4 * inner + hidden + h_rows), dtype=x.dtype,
                       device=x.device)
    qkv, attn, hid, h = (work.data_ptr() + i * m * x.element_size()
                         for i in (0, 3 * inner, 4 * inner, 4 * inner + hidden))
    args = (*chosen.config(), _DTYPE_CODES[x.dtype], b, s, d, width,
            num_heads, dh, hidden)
    if stacked:
        args += (weights[0].shape[0],)
    args += (x.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in weights],
             h if h_rows else qkv, qkv, attn, hid)
    return chosen, out, (x, weights, work), args


def _enqueue(chosen: Plan, stacked: bool, args: Tuple, index: int) -> None:
    """Launch on the current stream of device ``index`` (the current
    device), check the launch, count it."""
    global LAUNCHES, BLOCK_LAUNCHES
    lib = _library()
    entry = lib.vit_encoder_forward if stacked else lib.vit_block_forward
    err = entry(*args, attention._stream_handle(index))
    if err != 0:
        name = "vit_encoder_forward" if stacked else "vit_block_forward"
        raise RuntimeError(f"{name} ({chosen.variant}) failed: CUDA error "
                           f"{err}")
    if stacked:
        LAUNCHES += 1
    else:
        BLOCK_LAUNCHES += 1
    VARIANT_LAUNCHES[chosen.variant] += 1


def _launch(x: torch.Tensor, weights: List[torch.Tensor], num_heads: int,
            stacked: bool, chosen: Optional[Plan] = None) -> torch.Tensor:
    """``vit_encoder_forward`` on weights stacked over depth, or
    ``vit_block_forward`` on one block's own; ``chosen`` overrides the
    plan.  Raises for what the kernels cannot take."""
    index = x.device.index
    if x.is_cuda and index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(x, weights, num_heads, stacked, chosen)
    # keep: copies made for the launch, alive until it is enqueued.
    chosen, out, keep, args = _prepare(x, weights, num_heads, stacked, chosen)
    _enqueue(chosen, stacked, args, index)
    return out


def prepared(x: torch.Tensor, weights: List[torch.Tensor], num_heads: int,
             stacked: bool, chosen: Optional[Plan] = None):
    """``(out, launch)``: ``launch()`` enqueues the encoder (``stacked``,
    weights stacked over depth in ``_FIELDS`` order) or block kernel on these
    operands into ``out`` again and nothing else, on the current stream of
    the current device.  For timing a launch apart from the wrapper, one
    variant beside another (``chosen``), and for capture into a CUDA
    graph."""
    chosen, out, keep, args = _prepare(x, weights, num_heads, stacked, chosen)
    index = x.device.index

    def launch(keep=keep):        # the operands live as long as launch does
        _enqueue(chosen, stacked, args, index)

    return out, launch


def _stack(flat: Sequence[torch.Tensor], depth: int) -> List[torch.Tensor]:
    n = len(_FIELDS)
    return [torch.stack([flat[i * n + f] for i in range(depth)]).contiguous()
            for f in range(n)]


# Weights stacked over depth, made once per parameter set.
_OPERANDS = operand_cache.OperandCache()


def _operands(flat: Sequence[torch.Tensor], depth: int,
              dtype: torch.dtype, num_heads: int = 1,
              variant: Optional[str] = None) -> List[torch.Tensor]:
    """``flat`` cast to ``dtype`` and stacked over depth, the heads of
    ``num_heads`` zero-padded where ``variant`` (by default the one
    :func:`plan` gives this dtype and width) pads them (:func:`head_pad`),
    D and the MLP width where it pads those (:func:`width_pads`), and for
    ``"tf32x3"`` the four kernels split into their two planes
    (:func:`split_planes`).  Reused while every leaf is the same tensor at
    the same ``_version`` (which any in-place update, such as an optimiser
    step, moves on); made anew otherwise
    (:class:`~.operand_cache.OperandCache`)."""
    d, hidden = flat[0].shape[0], flat[8].shape[-1]
    if variant is None and d % num_heads == 0:
        variant = _variant(dtype, d, num_heads, hidden)

    def make():
        stacked = _stack([t.to(dtype) for t in flat], depth)
        pad = head_pad(variant, d // num_heads) if variant else 0
        if pad:
            stacked = _pad_heads(stacked, num_heads, pad)
        width, mlp = width_pads(variant, d, hidden) if variant else (0, 0)
        if width or mlp:
            stacked = _pad_width(stacked, width or d, mlp or hidden)
        return split_planes(stacked) if variant == "tf32x3" else stacked

    return _OPERANDS.get((dtype, num_heads, variant), flat, make)


def _launch_operands(x: torch.Tensor, flat: Sequence[torch.Tensor],
                     depth: int, num_heads: int = 1
                     ) -> Optional[List[torch.Tensor]]:
    """The encoder kernel's weights for a call that needs no gradient:
    ``flat`` cast to ``x.dtype``, stacked over depth and padded as the
    heads and widths need, made once per parameter set.  None when a gradient is
    needed: then the cast and the stack are made inside the autograd graph,
    on every call (and padded at the launch)."""
    if _wants_grad(x, flat):
        return None
    return _operands(flat, depth, x.dtype, num_heads)


def _blocks_from_flat(flat: Sequence[torch.Tensor], depth: int) -> List[Params]:
    n = len(_FIELDS)
    blocks = []
    for i in range(depth):
        p: Params = {}
        for f, (mod, field) in enumerate(_FIELDS):
            p.setdefault(mod, {})[field] = flat[i * n + f]
        blocks.append(p)
    return blocks


def _wants_grad(x: torch.Tensor, flat: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in flat))


class _Encoder(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: autograd of the plain twin."""

    @staticmethod
    def forward(ctx, x, num_heads, depth, *flat):
        ctx.num_heads, ctx.depth = num_heads, depth
        ctx.save_for_backward(x, *flat)
        return _launch(x, _stack(flat, depth), num_heads, stacked=True)

    @staticmethod
    def backward(ctx, grad):
        x, *flat = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(ctx.needs_input_grad[0])
            flat = [t.detach().requires_grad_(need)
                    for t, need in zip(flat, ctx.needs_input_grad[3:])]
            out = encoder_reference(x, _blocks_from_flat(flat, ctx.depth),
                                    ctx.num_heads)
            inputs = [t for t in [x, *flat] if t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad))
        return (next(grads) if x.requires_grad else None, None, None,
                *[next(grads) if t.requires_grad else None for t in flat])


def encoder(x: torch.Tensor, blocks: Sequence[Params],
            num_heads: int) -> torch.Tensor:
    """All ViT blocks on (B, S, D) tokens: the CUDA kernel for a CUDA
    tensor, as :func:`plan` decides (a shape it refuses, or a launch that
    fails, raises), the plain twin for a CPU tensor.

    ``blocks`` are per-block param dicts in any dtype (``models/vit.py::
    encode`` passes the float32 masters); their leaves are cast to
    ``x.dtype`` here.  On the card with no gradient needed, the cast and
    stacked weights are made once per parameter set and reused; under a
    gradient the cast and the stack are made on every call, inside the
    graph, and the kernel runs through the autograd Function."""
    flat = [blk[mod][field] for blk in blocks for mod, field in _FIELDS]
    if not x.is_cuda:
        return encoder_reference(x, _blocks_from_flat(
            [t.to(x.dtype) for t in flat], len(blocks)), num_heads)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"encoder kernel takes float32 or bfloat16, got {x.dtype}")
    stacked = _launch_operands(x, flat, len(blocks), num_heads)
    if stacked is not None:
        return _launch(x, stacked, num_heads, stacked=True)
    return _Encoder.apply(x, num_heads, len(blocks),
                          *[t.to(x.dtype) for t in flat])


def block_reference(x: torch.Tensor, p: Params, num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the block kernel (``models/vit.py::_block``
    with the plain attention); what a CPU tensor takes and what the
    backward differentiates.  Launches no kernel."""
    from ..models import vit   # vit imports this module

    return vit._block(x, p, num_heads)


class _Block(torch.autograd.Function):
    """Forward: the CUDA block kernel.  Backward: autograd of the plain
    twin, gradients for ``x`` and each of the twelve weights."""

    @staticmethod
    def forward(ctx, x, num_heads, *flat):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, *flat)
        return _launch(x, list(flat), num_heads, stacked=False)

    @staticmethod
    def backward(ctx, grad):
        x, *flat = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(ctx.needs_input_grad[0])
            flat = [t.detach().requires_grad_(need)
                    for t, need in zip(flat, ctx.needs_input_grad[2:])]
            out = block_reference(x, _blocks_from_flat(flat, 1)[0],
                                  ctx.num_heads)
            inputs = [t for t in [x, *flat] if t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad))
        return (next(grads) if x.requires_grad else None, None,
                *[next(grads) if t.requires_grad else None for t in flat])


def block(x: torch.Tensor, p: Params, num_heads: int) -> torch.Tensor:
    """One fused ViT block on (B, S, D) tokens: the CUDA kernel for a CUDA
    tensor, as :func:`plan` decides (a shape it refuses, or a launch that
    fails, raises), the plain twin for a CPU tensor.  ``p`` is one block's
    param dict; its leaves are cast to ``x.dtype`` at use, so float32
    masters get their gradients through the cast.  The autograd Function is
    taken only when a gradient is needed."""
    if x.is_cuda and x.dtype not in _DTYPE_CODES:
        raise TypeError(f"block kernel takes float32 or bfloat16, got {x.dtype}")
    p = {mod: {field: t.to(x.dtype) for field, t in leaves.items()}
         for mod, leaves in p.items()}
    flat = [p[mod][field] for mod, field in _FIELDS]
    if not x.is_cuda:
        return block_reference(x, p, num_heads)
    if _wants_grad(x, flat):
        return _Block.apply(x, num_heads, *flat)
    return _launch(x, flat, num_heads, stacked=False)
