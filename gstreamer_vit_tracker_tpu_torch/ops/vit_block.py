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

* ``"mma"``: bf16 at any D and MLP width (every bf16 preset, the ``small``
  architecture in bf16, D 96, and ViT-L's and ViT-H's widths, D 1024 and
  1280).  Five launches a block up to D 768: ``wgmma`` products with the
  LayerNorm in the prologue of the qkv and mlp1 products and the bias /
  GELU / residual epilogue on the accumulator registers (seven above it:
  the LN rows written by launches of their own, ``"prenormed"`` below),
  and an attention that reads q, k
  and v from the qkv buffer where they lie and walks blocks of 64 keys
  twice (the row maximum, then ``expf`` of the twin's own argument and P.V
  with p in f32 precision).
* ``"tf32x3"``: float32 (the ``small`` preset, the float32 flagship of the
  dry run and of training, and every other float32 width) with a head dim
  that is a multiple of 8.  The same five
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
* ``"simt"``: float32 by name only (``prepared(..., chosen=Plan("simt"))``),
  the yardstick of the timings, on a shape with an MLP width that is a
  multiple of 16 and a head dim up to 128 (padded to a multiple of 16; it
  keeps that limit): the first design's seven launches a block on the FMA
  units, an attention that walks blocks of 32 keys twice.

Above a head dim of 128, ``"mma"`` and ``"tf32x3"`` run the attention stage
in panels of 64 columns (``attention_panels_kernel`` of
``csrc/encoder_mma.cuh`` and ``encoder_tf32.cuh``).  ``"mma"``: a CTA keeps
its 64 rows of q resident and ``Plan.group`` = G panels of the output in
registers, K and V come through a TMA ring (``csrc/panel_ring.cuh``), and
each key block's scores are computed once a CTA in each pass (G up to 3:
the fresh accumulators of the twin's arithmetic fill the registers; 1 at
batch 1, where the grid is smaller than the card: :func:`plan`).
``"tf32x3"`` (``csrc/panel_tf32.cuh``): the same geometry, one pass, both
products on ``wgmma``, producer warpgroups splitting each k and v panel
into its TF32 parts once a CTA, one CTA an SM (G up to 4, the fresh
accumulator of a block's P.V beside o; 1 at batch 1).  The products do not
see the head dim.

The LayerNorm products of ``"mma"`` and ``"tf32x3"`` come in two forms
each, ``Plan.ln``, picked from the residual width alone: ``"resident"``
(the CTA's 64 rows of the residual stream held whole and normalised in
place: the flagship, ``small``, every bf16 width up to 768 and every
float32 one up to 544) and, past it, ``"prenormed"`` (the LN rows written
once by their own launch, then every product of the block reading plain
rows through a TMA ring: ViT-L, ViT-H and Model A in both dtypes; float32
on split-TF32 ``wgmma``, ``csrc/ring_tf32.cuh``, whose weight planes the
operand cache lays out transposed).  ``"tf32x3"``'s ``"streamed"`` (a
statistics launch before the product, then each K chunk normalised as it
lands), the design the float32 ring replaced, runs by name only
(``plan(..., ln="streamed")``).  Seven launches a block past the resident
form; every form gives the same LN output bit for bit, and the same
products (:func:`ln_rows_reference` is the prenormed LN rows' plain
version); ``csrc/encoder_mma.cuh``'s and ``ring_tf32.cuh``'s headers say
what bounds each.

A head dim that the variant does not take as it is (bf16: up to 128 not 32,
64 or 128, above 128 not a multiple of 64, a whole panel; ``"tf32x3"``: not a
multiple of 8; ``"simt"``: not a multiple of 16) is zero-padded to the next
one it takes: the qkv weight and
bias get zero columns a head and the proj weight zero rows a head (in the
operand cache, so once per parameter set), the attention runs at the padded
head dim with the true one's scale.  ``"mma"`` also pads a D or an MLP width
that is no multiple of 64 (its products' K chunk) to the next one, and
``"tf32x3"`` one that is no multiple of 32 to the next,
``Plan.width`` and ``Plan.mlp`` (:func:`_pad_width`: zero LN scale and bias,
zero rows of the qkv and mlp1 kernels and of mlp2's past the MLP width, zero
columns of proj, mlp1 and mlp2 and their biases): the kernel carries the
residual stream at the padded width with zero columns, takes the LayerNorm's
statistics over the true D, and copies x in and the result out at D
(``csrc/vit_encoder.cu``'s header says why every padded column stays 0).
Zeros add exactly to an f32 sum: a padded head or width computes what the
unpadded one does (``"tf32x3"`` splits the weights into their planes after
the pad).  Every head dim, D and MLP width runs in both dtypes; a launch
that fails raises, and no call goes to the plain twin.  An x or a
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
           "block_reference", "ln_rows_reference", "plan", "Plan", "prepared",
           "LAUNCHES", "BLOCK_LAUNCHES", "VARIANT_LAUNCHES"]

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
_LN_CODES = {"resident": 0, "streamed": 1, "prenormed": 2}
# Every LN form a caller may name: past the widths where "resident" is kept
# both variants take "prenormed"; "tf32x3"'s "streamed", the design
# "prenormed" replaced, runs by name only, the yardstick of its timings.
_NAMED_LN = {"mma": ("resident", "prenormed"),
             "tf32x3": ("resident", "prenormed", "streamed")}
# A dtype's variants, the first its own and the one the rule gives;
# float32's "simt" runs by name only.
_DTYPE_VARIANTS = {torch.float32: ("tf32x3", "simt"), torch.bfloat16: ("mma",)}
_VARIANTS = {dtype: v[0] for dtype, v in _DTYPE_VARIANTS.items()}
# The opt-in shared memory of a block on the H100 (plan's default).
H100_OPTIN = 232448
# Geometry of the kernels, as csrc/vit_encoder.cu, encoder_mma.cuh and
# encoder_tf32.cuh have it.  "mma": a resident product CTA owns 64 rows by
# an N tile of 32 or 64 columns and K arrives in 64-deep chunks (so D and
# the MLP width run padded to whole chunks) through a ring of 3; its LN
# products hold all W / 64 chunks of their rows instead, which at W = 768
# and N 64 is 1024 + 12 x 64 x (64 + 64) x 2 = 197,632 bytes of the H100's
# 232,448 and at W = 1024 263,168.  The attention takes 64 query rows and
# walks 64-key blocks through a ring of 2 (82,944 bytes at head dim 128, for
# any S); above a head dim of 128 (_TILE_MAX_DH) it runs in panels of 64
# columns: its q panels and a ring of panel stages, "mma" 107,672 bytes at
# head dim 256 for any S (attention.panel_stages), "tf32x3" 230,488
# (attention.tf32_panel_stages); "simt" stops there.  "mma" holds up to
# _MAX_GROUP panels of o a CTA, "tf32x3" _TF32_MAX_GROUP.
# "tf32x3": the same 64 rows, N tiles of 16, 32 or 64, K in 32-deep
# chunks through a ring of 4 slots (3 at N 64) a warpgroup of A and the
# weight's two planes (and, streamed, the chunk's LN scale and bias;
# prenormed, csrc/ring_tf32.cuh's TMA ring, :func:`ln_smem_bytes`); a
# resident LN product holds its 64 rows of W and its scale and bias instead
# of the A ring, which at W = 512, N 32 and two warpgroups is
# 64 x 516 x 4 + 2 x 512 x 4 + 8 x 2 x 32 x 40 x 4 = 218,112 bytes.
# "simt": 16 query rows, 32-key blocks.
_ROWS, _CHUNK, _TF32_CHUNK = 64, 64, 32
_MMA_RING = 3
# "mma"'s prenormed products (ring_product_kernel): one or two warpgroups
# of 64 rows a CTA share each W chunk of an N tile of 32, 64 or 128; a
# stage holds their A chunk and the W chunk, the ring 6 or 8 of them (6 at
# 16 KB and 32 KB stages) and a full and an empty barrier a stage.  The
# resident form is kept up to a residual width of _RESIDENT_MAX_WIDTH (the
# flagship, ``small``, every bf16 D up to 768), "tf32x3"'s up to
# _TF32_RESIDENT_MAX_WIDTH, the widest whose rows fit the H100 at every
# N tile and warpgroups (at N 32 and two warpgroups 226,560 bytes).
_RESIDENT_MAX_WIDTH = 768
_TF32_RESIDENT_MAX_WIDTH = 544
# The prenormed products' builds: N tiles by warpgroups a CTA.
_RING_TILES = {1: (32, 64), 2: (32, 64, 128)}
# "tf32x3"'s prenormed products (csrc/ring_tf32.cuh, _tf32_ring): N tiles
# 16, 32 and 64 (CTAs of 64 rows; at the plan's two warpgroups 16 and 32
# deal K to two consumers) and 128 (CTAs of 128 x 128: every product or
# none, where 128-row CTAs fill the card).
_TF32_RING_TILES = (16, 32, 64, 128)
_TF32_WIDE_TILE = 128
_TF32_RING_MAX_STAGES = 16
_SPLIT_MAX_DH = 64         # "tf32x3": two-warpgroup attention built up to it
_TILE_MAX_DH, _PANEL = 128, 64
_MAX_GROUP = 3
_TF32_MAX_GROUP = attention._TF32_MAX_GROUP


class Plan(NamedTuple):
    """What :func:`encoder` and :func:`block` launch for one shape."""
    variant: str                               # "mma", "tf32x3" or "simt"
    tiles: Tuple[int, ...] = (0, 0, 0, 0)      # N tile of qkv, proj, mlp1, mlp2
    pad: int = 0                               # padded head dim (0: none)
    warpgroups: int = 1                        # "tf32x3": warpgroups a CTA
    width: int = 0                             # padded D (0: none)
    mlp: int = 0                               # padded MLP width (0: none)
    ln: str = "resident"                       # the LN products' form
    group: int = 0                             # above 128: panels of o an
                                               # attention CTA

    def config(self) -> Tuple[int, ...]:
        """The 7 ints the C entries take first (``Config`` in the source):
        the variant's code, the N tiles, the warpgroups and the LN form's
        code."""
        return ((_VARIANT_CODES[self.variant],) + self.tiles
                + (self.warpgroups, _LN_CODES[self.ln]))


def _refusal(variant: str, dim: int, heads: int,
             hidden: int) -> Optional[str]:
    """Why ``variant`` cannot take this shape, padded or not, or None if it
    can."""
    if heads < 1 or dim % heads:
        return f"embed dim {dim} is not divisible by {heads} heads"
    if variant == "simt" and dim // heads > _TILE_MAX_DH:
        return f"simt takes head dims up to {_TILE_MAX_DH}, not {dim // heads}"
    if hidden < 1:
        return f"MLP width {hidden} must be at least 1"
    if variant == "simt" and hidden % 16:
        return f"MLP width {hidden} must be a multiple of 16"
    return None


def ln_smem_bytes(variant: str, ln: str, width: int, tile: int,
                  warpgroups: int = 1) -> int:
    """Dynamic shared memory of one LN product CTA of ``variant`` in form
    ``ln`` at residual width ``width`` and N tile ``tile`` (the sources'
    ``product_smem_bytes`` and ``Ring::smem_bytes``): ``"resident"`` grows
    with the width, a ``"streamed"`` or ``"prenormed"`` ring does not."""
    if variant == "mma":
        if ln == "prenormed":
            stage = warpgroups * _ROWS * _CHUNK * 2 + _CHUNK * tile * 2
            stages = 6 if stage in (16384, 32768) else 8
            return 1024 + stages * (stage + 16)
        return 1024 + width // _CHUNK * _CHUNK * (_ROWS + tile) * 2
    if ln == "prenormed":
        consumers, cols, ksplit = _tf32_ring(tile, warpgroups)
        stage = (1 if ksplit else consumers) * _ROWS * 128 + 2 * cols * 128
        scratch = _ROWS * cols * 4 if ksplit else 0
        budget = (attention._TWO_CTA_BYTES if consumers == 1 or ksplit
                  else H100_OPTIN)
        stages = min(_TF32_RING_MAX_STAGES,
                     (budget - 1024 - scratch) // (stage + 16))
        return 1024 + stages * (stage + 16) + scratch
    nwg = 1 if tile == 64 else warpgroups
    slots = nwg * (3 if tile == 64 else 4)
    w_ring = slots * 2 * _TF32_CHUNK * (tile + 8)
    if ln == "resident":
        return (_ROWS * (width + 4) + 2 * width + w_ring) * 4
    return (slots * _ROWS * (_TF32_CHUNK + 4) + w_ring
            + slots * 2 * _TF32_CHUNK) * 4


def attention_smem_bytes(variant: str, dh: int, warpgroups: int = 1,
                         group: int = 0, optin: int = H100_OPTIN) -> int:
    """Dynamic shared memory of one attention CTA of ``variant`` at the
    head dim it runs (the sources' ``attention_smem_bytes``,
    ``panel::smem_bytes`` and ``tf32_panels::smem_bytes``): up to 128 a
    ring of two 64-key K and V blocks beside the 64-row Q tile
    (``"tf32x3"``: a ring a warpgroup); above 128 the q panels and the ring
    ``attention.panel_stages`` (``"mma"``) or
    ``attention.tf32_panel_stages`` (``"tf32x3"``) gives for ``group``
    panels of o on a card of ``optin`` bytes a block; ``"simt"``'s is
    static."""
    if variant == "simt":
        return 0
    if variant == "mma" and dh > _TILE_MAX_DH:
        panels = dh // _PANEL
        return attention.panel_smem_bytes(
            panels, attention.panel_stages(panels, group, optin))
    if dh > _TILE_MAX_DH:
        panels = -(-dh // _PANEL)
        return attention.tf32_panel_smem_bytes(
            panels, attention.tf32_panel_stages(panels, group, optin))
    if variant == "mma":
        return 1024 + (_ROWS + 2 * 2 * 64) * dh * 2
    return (_ROWS + 4 * warpgroups * 64) * (dh + 4) * 4


def _tf32_ring(tile: int, warpgroups: int) -> Tuple[int, int, bool]:
    """(consumer warpgroups, columns, K split) of a ``"tf32x3"`` prenormed
    product's CTA (``csrc/vit_encoder.cu::ring_tf32``): N tile 128 is two
    consumers of 64 rows by 128 columns; 16 and 32 at two warpgroups deal
    K to two consumers of the same 64 rows, the streamed form's split of
    such a product (the same sums); else one consumer of 64 rows."""
    if tile == _TF32_WIDE_TILE:
        return 2, tile, False
    if warpgroups == 2 and tile < 64:
        return 2, tile, True
    return 1, tile, False


def _fits(variant: str, ln: str, width: int, tiles: Tuple[int, ...],
          warpgroups: int, optin: int) -> bool:
    """Whether the LN products of form ``ln`` fit ``optin`` bytes at their
    N tiles (``"prenormed"``: every product, all four run the ring)."""
    products = tiles if ln == "prenormed" else (tiles[0], tiles[2])
    return all(ln_smem_bytes(variant, ln, width, t, warpgroups) <= optin
               for t in products)


def _resident_max(variant: str) -> int:
    return (_RESIDENT_MAX_WIDTH if variant == "mma"
            else _TF32_RESIDENT_MAX_WIDTH)


def _ln_form(variant: str, width: int, tiles: Tuple[int, ...],
             warpgroups: int, optin: int) -> Optional[str]:
    """The LN products' form: ``"resident"`` up to a width of
    :func:`_resident_max` where both the qkv and mlp1 products' rows fit
    ``optin`` bytes at their N tiles, else ``"prenormed"`` where its ring
    does; None if neither does."""
    if width <= _resident_max(variant) and _fits(
            variant, "resident", width, tiles, warpgroups, optin):
        return "resident"
    return "prenormed" if _fits(variant, "prenormed", width, tiles,
                                warpgroups, optin) else None


def head_pad(variant: str, dh: int) -> int:
    """The head dim ``variant`` runs a head dim ``dh`` at when it does not
    take it as it is, else 0: ``"mma"`` the next of 32, 64 and 128, above
    128 the next multiple of 64 (a whole panel); ``"tf32x3"`` the next
    multiple of 8 (a ragged last panel is zero-filled in shared memory);
    ``"simt"`` (up to 128) the next multiple of 16."""
    if variant == "mma":
        if dh > _TILE_MAX_DH:
            return 0 if dh % _PANEL == 0 else -(-dh // _PANEL) * _PANEL
        return 0 if dh in (32, 64, 128) else next(
            d for d in (32, 64, 128) if d > dh)
    step = 8 if variant == "tf32x3" else 16
    return 0 if dh % step == 0 else -(-dh // step) * step


def width_pads(variant: str, dim: int, hidden: int) -> Tuple[int, int]:
    """(D, MLP width) that ``variant`` runs a ``dim`` and ``hidden`` at
    when it does not take them as they are, else 0 each: the next multiple
    of its products' K chunk, 64 for ``"mma"`` and 32 for ``"tf32x3"``;
    ``"simt"`` pads neither."""
    step = {"mma": _CHUNK, "tf32x3": _TF32_CHUNK}.get(variant)
    if step is None:
        return 0, 0
    return tuple(0 if n % step == 0 else -(-n // step) * step
                 for n in (dim, hidden))


def _variant(dtype: torch.dtype, dim: int, heads: int,
             hidden: int) -> Optional[str]:
    """The variant :func:`plan` gives this dtype and width, or None if it
    cannot take the shape."""
    variant = _VARIANTS.get(dtype)
    if variant is None or _refusal(variant, dim, heads, hidden) is not None:
        return None
    return variant


def _ring_warpgroups(m: int, dim: int, sms: int) -> int:
    """The prenormed products' warpgroups a CTA for ``m`` rows of
    residual width ``dim``: 2 (CTAs of 128 rows that share each W chunk)
    once such CTAs with 64-wide tiles fill ``sms`` SMs in the narrowest
    product (proj and mlp2, N = dim), else 1."""
    return 2 if -(-m // (2 * _ROWS)) * -(-dim // 64) >= sms else 1


def _fit(tile: int, n: int) -> int:
    """The largest of ``tile``, its half, ... down to 32 that divides ``n``:
    ``"mma"``'s products take whole N tiles (every width they see is a
    multiple of 32)."""
    while n % tile and tile > 32:
        tile //= 2
    return tile


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
         dtype: torch.dtype, sms: int, optin: int = H100_OPTIN,
         ln: Optional[str] = None) -> Plan:
    """The variant and the product tiles for a ``(batch, seq, dim)`` input
    with ``heads`` heads and MLP width ``hidden`` on a card of ``sms`` SMs
    and ``optin`` bytes of shared memory a block; ``ln`` names the LN
    products' form (``"tf32x3"``'s ``"streamed"`` among them) in place of
    the rule's, at the tiles the rule gives that form.

    * The variant: ``"mma"`` for bf16 (head dim 32, 64 or 128, above 128 a
      multiple of 64), ``"tf32x3"`` for float32 (head dim a multiple of 8),
      at any dim, head dim and hidden.  Another head dim gets ``pad``, the
      one it is zero-padded to (:func:`head_pad`); a dim or hidden that is
      no multiple of the variant's K chunk (64, 32) gets ``width`` and
      ``mlp``, the ones they are zero-padded to (:func:`width_pads`).
      Another dtype raises ``TypeError``.
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
    * ``ln``, the LN products' form at those tiles (:func:`_ln_form`):
      ``"resident"`` where the qkv and mlp1 CTAs' rows fit ``optin`` up to
      a width of 768 (``"mma"``) or 544 (``"tf32x3"``), else
      ``"prenormed"`` (every bf16 width above 768 and every float32 one
      above 544: ViT-L's D 1024 and ViT-H's 1280 at both batches).
      ``"mma"``'s ``"prenormed"`` products take ``warpgroups`` 64-row
      warpgroups a CTA (:func:`_ring_warpgroups`: 2 at ViT-L's batch 16, 1
      at batch 1), and N tiles of 128 with 2, of 64 with 1 (each product's
      tile halved down to 32 until it divides the product's width,
      :func:`_fit`, as every ``"mma"`` tile is).  ``"tf32x3"``'s keep the
      warpgroups and tiles above (:func:`_tf32_ring`), but for N tile 128
      on every product (CTAs of 128 x 128) where 128-row CTAs fill the card
      (:func:`_ring_warpgroups` 2: batch 16).

    Depends on the shape alone, so a chain of :func:`block` calls equals one
    :func:`encoder` call bit for bit.
    """
    if dtype not in _VARIANTS:
        raise TypeError(f"the encoder kernels take float32 or bfloat16, got "
                        f"{dtype}")
    variant = _VARIANTS[dtype]
    why = (_refusal(variant, dim, heads, hidden) if batch >= 1 and seq >= 1
           else f"batch {batch} and sequence {seq} must be at least 1")
    if why is not None:
        raise ValueError(f"the encoder kernels cannot take this shape "
                         f"({variant}, {dtype}): {why}")
    pad = head_pad(variant, dim // heads)
    rows = -(-batch * seq // _ROWS)
    dh = pad or dim // heads
    width, mlp = width_pads(variant, dim, hidden)
    tiles = _tiles(rows, heads * dh, width or dim, mlp or hidden, sms,
                   variant == "tf32x3")
    wgs = (2 if variant == "tf32x3" and dh <= _SPLIT_MAX_DH
           and -(-seq // _ROWS) * batch * heads < sms else 1)
    if ln is not None and ln not in _NAMED_LN[variant]:
        raise ValueError(f"{variant} takes the LN forms "
                         f"{_NAMED_LN[variant]}, not {ln}")
    wide = (ln == "prenormed" if ln is not None
            else (width or dim) > _resident_max(variant))
    if variant == "mma":
        if (width or dim) > _RESIDENT_MAX_WIDTH:
            wgs = _ring_warpgroups(batch * seq, width or dim, sms)
            tiles = (128 if wgs == 2 else 64,) * 4
        tiles = tuple(_fit(t, n) for t, n in zip(
            tiles, (3 * heads * dh, width or dim, mlp or hidden, width or dim)))
    elif wide and _ring_warpgroups(batch * seq, width or dim, sms) == 2:
        tiles = (_TF32_WIDE_TILE,) * 4
    form = ln or _ln_form(variant, width or dim, tiles, wgs, optin)
    if form is None or not _fits(variant, form, width or dim, tiles, wgs,
                                 optin):
        raise ValueError(f"the encoder kernels cannot take this shape "
                         f"({variant}, {dtype}): no LN product form"
                         f"{'' if ln is None else ' ' + ln} fits {optin} "
                         f"bytes of shared memory")
    return Plan(variant, tiles, pad, wgs, width, mlp, form,
                panel_group(variant, batch, seq, heads, dh, sms))


def panel_group(variant: str, batch: int, seq: int, heads: int, dh: int,
                sms: int) -> int:
    """``Plan.group``: the panels of o a CTA of the attention holds at a
    head dim ``dh`` above 128 (0 elsewhere): ``attention.panel_group``,
    ``"mma"`` with each k panel taken twice (the two passes), up to
    _MAX_GROUP (Model A, dh 256: 2 at batch 16, 536.22 us against 591.17 at
    G 1; 1 at batch 1, 1929.77 against 2002.66 at G 2, where the grid is
    smaller than the card and a CTA's P.V grows with G; ``profile_encoder.py
    wide``), ``"tf32x3"`` with one pass and one CTA an SM, up to
    _TF32_MAX_GROUP."""
    if variant == "simt" or dh <= _TILE_MAX_DH:
        return 0
    if variant == "tf32x3":
        return attention.panel_group(
            -(-dh // _PANEL), -(-seq // _ROWS) * batch * heads, sms, 1,
            lambda g: False, _TF32_MAX_GROUP)
    panels = dh // _PANEL
    return attention.panel_group(
        panels, -(-seq // _ROWS) * batch * heads, sms, 2,
        lambda g: attention_smem_bytes("mma", dh, 1, g)
        <= attention._TWO_CTA_BYTES, _MAX_GROUP)


def encoder_reference(x: torch.Tensor, blocks: Sequence[Params],
                      num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the blocks chained."""
    from ..models import vit   # vit imports this module

    for p in blocks:
        x = vit._block(x, p, num_heads)
    return x


def ln_rows_reference(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, dim: int) -> torch.Tensor:
    """Plain version of the prenormed form's LN rows
    (``csrc/encoder_mma.cuh::ln_rows_kernel``) on bf16 ``x`` (..., W), W a
    multiple of 64, or float32 ``x``, W a multiple of 32: the LayerNorm
    over the first ``dim`` columns with ``scale`` and ``bias`` (W,) (zero
    past ``dim``) in the kernel's order of float32 sums (``row_stats``).
    Eight lanes a row: lane c adds, one at a time, the elements before
    ``dim`` of its 16-byte chunks c, c + 8, ... of the row (8 bf16 or 4
    floats a chunk); the lanes' sums are added as three xor-shuffles (1, 2,
    4) add them; mean = sum / dim, then the same for (x - mean)^2, rstd = 1
    / sqrt(var / dim + 1e-6); y = ((x - mean) * rstd) * scale + bias.
    Every operation rounded to float32 on its own, one rounding to bf16
    (none in float32: the streamed form's LN output bit for bit)."""
    xf = x.float()
    lanes = torch.arange(8, device=x.device)
    k = torch.tensor(float(dim), dtype=torch.float32, device=x.device)
    elems = 16 // x.element_size()

    def group_sum(t):
        acc = torch.zeros(t.shape[:-1] + (8,), dtype=torch.float32,
                          device=x.device)
        for col0 in range(0, t.shape[-1], 8 * elems):
            for i in range(elems):
                cols = col0 + elems * lanes + i
                live = cols < dim
                if live.any():
                    acc = torch.where(live, acc + t[..., cols], acc)
        for shift in (1, 2, 4):
            acc = acc + acc[..., lanes ^ shift]
        return acc[..., :1]

    mu = group_sum(xf) / k
    t = xf - mu
    rstd = 1.0 / torch.sqrt(group_sum(t * t) / k
                            + torch.tensor(1e-6, dtype=torch.float32))
    return (t * rstd * scale.float() + bias.float()).to(x.dtype)


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
    lib.vit_encoder_forward.argtypes = ([ctypes.c_int] * 17
                                        + [ctypes.c_void_p] * 20)
    lib.vit_block_forward.argtypes = ([ctypes.c_int] * 16
                                      + [ctypes.c_void_p] * 20)
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
           stacked: bool, split: bool = False, width: int = 0,
           transposed: bool = False):
    """Raise on weights that do not fit x, the inner width ``inner``
    (heads x the head dim the kernels run at) and the residual width
    ``width`` (x's D, or the one it is zero-padded to).  ``weights`` in
    ``_FIELDS`` order: stacked over depth for the encoder, one block's own
    for the block kernel; ``split``: the four kernels as two planes each
    (:func:`split_planes`), ``transposed`` each plane (out, in)."""
    d = width or x.shape[2]
    lead = (weights[0].shape[0],) if stacked else ()
    hidden = weights[9].shape[-1]
    k = (2,) if split else ()

    def kernel(n_in, n_out):
        return k + ((n_out, n_in) if transposed else (n_in, n_out))

    want = [(d,), (d,), kernel(d, 3 * inner), (3 * inner,), kernel(inner, d),
            (d,), (d,), (d,), kernel(d, hidden), (hidden,), kernel(hidden, d),
            (d,)]
    for (mod, field), t, shape in zip(_FIELDS, weights, want):
        shape = lead + shape
        if tuple(t.shape) != shape:
            raise ValueError(f"{mod}/{field}: shape {tuple(t.shape)}, "
                             f"kernel expects {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{mod}/{field}: {t.dtype} on {t.device}, "
                             f"kernel expects {x.dtype} on {x.device}")


_PLANS: Dict[Tuple, Plan] = {}   # (device, B, S, D, H, hidden, dtype, ln) -> Plan


def _plan_for(x: torch.Tensor, heads: int, hidden: int,
              ln: Optional[str] = None) -> Plan:
    """:func:`plan` for this CUDA tensor (with ``ln``: that LN form by
    name), decided once per argument tuple (the card's SM count read once
    per device)."""
    b, s, d = x.shape
    key = (x.device.index, b, s, d, heads, hidden, x.dtype, ln)
    chosen = _PLANS.get(key)
    if chosen is None:
        optin, sms = attention.card(x.device)
        chosen = _PLANS[key] = plan(b, s, d, heads, hidden, x.dtype, sms,
                                    optin, ln)
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


def split_planes(weights: Sequence[torch.Tensor],
                 transposed: bool = False) -> List[torch.Tensor]:
    """Weights in ``_FIELDS`` order (any leading dims) with each of the
    four kernels (..., in, out) as its two planes (..., 2, in, out), hi
    then lo (:func:`split_tf32`): what ``"tf32x3"`` reads; ``transposed``:
    each plane (out, in), K-major, what its prenormed products' ``wgmma``
    reads (``csrc/ring_tf32.cuh``)."""
    w = list(weights)
    for i in _KERNELS:
        planes = torch.stack(split_tf32(w[i]), dim=-3)
        w[i] = planes.transpose(-1, -2).contiguous() if transposed else planes
    return w


def _is_split(weights: Sequence[torch.Tensor], stacked: bool) -> bool:
    return weights[2].dim() == (4 if stacked else 3)


def _transposes(chosen: Plan) -> bool:
    """Whether ``chosen`` reads its split weights transposed (``"tf32x3"``
    prenormed)."""
    return chosen.variant == "tf32x3" and chosen.ln == "prenormed"


def _split_layout(weights: Sequence[torch.Tensor], transposed: bool,
                  width: int) -> List[torch.Tensor]:
    """Split weights (any leading dims) in the layout ``transposed`` asks
    for: the planes of the four kernels transposed where they lie the other
    way (the qkv kernel's planes end in the residual width ``width`` exactly
    when they are transposed: its out, 3 x the inner width, is never
    ``width``)."""
    if (weights[2].shape[-1] == width) == transposed:
        return list(weights)
    w = list(weights)
    for i in _KERNELS:
        w[i] = w[i].transpose(-1, -2).contiguous()
    return w


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
    the variant's own; ``"mma"`` or ``"tf32x3"`` named without tiles gets
    the rule's tiles, warpgroups and LN form, and a named ``"resident"``
    form must fit the card at the named tiles; ``"mma"`` or ``"tf32x3"``
    above a head dim of 128 named without ``group`` gets the rule's."""
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
    if chosen.variant != "simt" and not any(chosen.tiles):
        rule = _plan_for(x, heads, hidden)
        chosen = chosen._replace(tiles=rule.tiles, warpgroups=rule.warpgroups,
                                 ln=rule.ln)
    if chosen.variant != "simt":
        if chosen.ln not in _NAMED_LN[chosen.variant]:
            raise ValueError(f"{chosen.variant} takes the LN forms "
                             f"{_NAMED_LN[chosen.variant]}, not {chosen.ln}")
        why = _tile_refusal(chosen)
        if why is not None:
            raise ValueError(why)
        if not _fits(chosen.variant, chosen.ln, width or d, chosen.tiles,
                     chosen.warpgroups, attention.card(x.device)[0]):
            raise ValueError(f"the {chosen.ln} LN form does not fit the "
                             f"card's shared memory at width {width or d}, "
                             f"N tiles {chosen.tiles} and {chosen.warpgroups} "
                             f"warpgroups")
    elif chosen.ln != "resident":
        raise ValueError(f"simt takes no LN form, not {chosen.ln}")
    dh = pad or d // heads
    if chosen.variant != "simt" and dh > _TILE_MAX_DH and not chosen.group:
        chosen = chosen._replace(group=_plan_for(x, heads, hidden).group)
    why = group_refusal(chosen.variant, dh, chosen.group)
    if why is not None:
        raise ValueError(f"the encoder kernels cannot take {chosen}: {why}")
    return chosen._replace(pad=pad, width=width, mlp=mlp)


def _tile_refusal(chosen: Plan) -> Optional[str]:
    """Why the products of a named ``"mma"`` or ``"tf32x3"`` plan cannot
    run at its N tiles and warpgroups, or None: ``"mma"``'s prenormed ring
    takes _RING_TILES by warpgroups; ``"tf32x3"``'s _TF32_RING_TILES, 128
    on every product or none; its resident and streamed products 16, 32
    and 64."""
    tiles = set(chosen.tiles)
    if chosen.variant == "mma":
        if chosen.ln == "prenormed" and not tiles <= set(
                _RING_TILES.get(chosen.warpgroups, ())):
            return (f"the prenormed products take N tiles {_RING_TILES} by "
                    f"warpgroups, not {chosen.tiles} at {chosen.warpgroups}")
        return None
    if chosen.ln == "prenormed":
        if not tiles <= set(_TF32_RING_TILES) or (
                _TF32_WIDE_TILE in tiles and len(tiles) > 1):
            return (f"the float32 prenormed products take N tiles "
                    f"{_TF32_RING_TILES}, {_TF32_WIDE_TILE} on every product "
                    f"or none, not {chosen.tiles}")
        return None
    if not tiles <= {16, 32, 64}:
        return (f"the float32 {chosen.ln} products take N tiles 16, 32 and "
                f"64, not {chosen.tiles}")
    return None


def group_refusal(variant: str, dh: int, group: int) -> Optional[str]:
    """Why the attention stage cannot run ``group`` panels of o a CTA at
    the head dim ``dh`` it runs, or None: above a head dim of 128 ``"mma"``
    takes a divisor of dh / 64 from 1 to _MAX_GROUP, ``"tf32x3"`` one of
    ceil(dh / 64) from 1 to _TF32_MAX_GROUP, every other shape 0
    (``csrc/vit_encoder.cu::check`` refuses the rest before a launch)."""
    if variant != "simt" and dh > _TILE_MAX_DH:
        panels, most = ((-(-dh // _PANEL), _TF32_MAX_GROUP)
                        if variant == "tf32x3" else (dh // _PANEL, _MAX_GROUP))
        if 1 <= group <= most and panels % group == 0:
            return None
        return (f"the panel attention takes a divisor of {panels} panels "
                f"from 1 to {most}, not group {group}")
    if group:
        return (f"group is the panel attention's above a head dim of "
                f"{_TILE_MAX_DH}, not {variant}'s at {dh}")
    return None


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
    hidden = weights[9].shape[-1]
    chosen = (_plan_for(x, num_heads, hidden) if chosen is None
              else _named(chosen, x, num_heads, hidden))
    dh = chosen.pad or d // num_heads
    inner = num_heads * dh
    width = chosen.width or d
    split, transposed = _is_split(weights, stacked), _transposes(chosen)
    if split and chosen.variant != "tf32x3":
        raise ValueError(f"split weights are tf32x3's, not {chosen.variant}'s")
    if split:
        weights = _split_layout(weights, transposed, width)
    else:
        if chosen.pad and weights[2].shape[-1] == 3 * d:
            weights = _pad_heads(weights, num_heads, chosen.pad)
        if chosen.width or chosen.mlp:
            weights = _pad_width(weights, width, chosen.mlp or hidden)
        if chosen.variant == "tf32x3":
            weights, split = split_planes(weights, transposed), True
    hidden = weights[9].shape[-1]
    _check(x, weights, inner, stacked, split, width, transposed)
    x, weights = _laid_out(x), [_laid_out(t) for t in weights]
    m = b * s
    out = torch.empty_like(x)
    # One scratch allocation: qkv (m, 3 inner), attn (m, inner), mlp hidden
    # (m, hidden), h: for "simt" the LN output (m, d), for a padded width
    # the residual stream (m, width), and a prenormed plan's LN rows (m,
    # width).  A streamed plan's LN statistics, (m, 2) float32, beside it.
    h_rows = d if chosen.variant == "simt" else (width if width != d else 0)
    n_rows = width if chosen.ln == "prenormed" else 0
    work = torch.empty(m * (4 * inner + hidden + h_rows + n_rows),
                       dtype=x.dtype, device=x.device)
    qkv, attn, hid, h, normed = (
        work.data_ptr() + i * m * x.element_size()
        for i in (0, 3 * inner, 4 * inner, 4 * inner + hidden,
                  4 * inner + hidden + h_rows))
    stats = (torch.empty((m, 2), dtype=torch.float32, device=x.device)
             if chosen.ln == "streamed" else None)
    ln_scratch = (stats.data_ptr() if stats is not None
                  else normed if n_rows else None)
    args = (*chosen.config(), chosen.group, _DTYPE_CODES[x.dtype], b, s, d,
            width, num_heads, dh, hidden)
    if stacked:
        args += (weights[0].shape[0],)
    args += (x.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in weights],
             h if h_rows else qkv, qkv, attn, hid, ln_scratch)
    return chosen, out, (x, weights, work, stats), args


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
              variant: Optional[str] = None,
              stacked: bool = True) -> List[torch.Tensor]:
    """``flat`` cast to ``dtype`` and stacked over depth, the heads of
    ``num_heads`` zero-padded where ``variant`` (by default the one
    :func:`plan` gives this dtype and width) pads them (:func:`head_pad`),
    D and the MLP width where it pads those (:func:`width_pads`), and for
    ``"tf32x3"`` the four kernels split into their two planes
    (:func:`split_planes`), transposed past a residual width of
    _TF32_RESIDENT_MAX_WIDTH, where the rule gives the prenormed form
    whose products read them so.  ``stacked=False``: one block's own
    (depth 1, the leading dim dropped: :func:`block`'s).  Reused while
    every leaf is the same tensor at the same ``_version`` (which any
    in-place update, such as an optimiser step, moves on); made anew
    otherwise (:class:`~.operand_cache.OperandCache`)."""
    d, hidden = flat[0].shape[0], flat[8].shape[-1]
    if variant is None and d % num_heads == 0:
        variant = _variant(dtype, d, num_heads, hidden)

    def make():
        made = _stack([t.to(dtype) for t in flat], depth)
        pad = head_pad(variant, d // num_heads) if variant else 0
        if pad:
            made = _pad_heads(made, num_heads, pad)
        width, mlp = width_pads(variant, d, hidden) if variant else (0, 0)
        if width or mlp:
            made = _pad_width(made, width or d, mlp or hidden)
        if variant == "tf32x3":
            made = split_planes(
                made, (width or d) > _TF32_RESIDENT_MAX_WIDTH)
        return made if stacked else [t[0] for t in made]

    return _OPERANDS.get((dtype, num_heads, variant, stacked), flat, make)


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


def _block_operands(x: torch.Tensor, flat: Sequence[torch.Tensor],
                    num_heads: int) -> Optional[List[torch.Tensor]]:
    """The block kernel's weights for a call that needs no gradient: one
    block's ``flat`` leaves cast to ``x.dtype``, padded and (``"tf32x3"``)
    split as :func:`_operands` makes them, once per parameter set.  None
    when a gradient is needed."""
    if _wants_grad(x, flat):
        return None
    return _operands(flat, 1, x.dtype, num_heads, stacked=False)


def block(x: torch.Tensor, p: Params, num_heads: int) -> torch.Tensor:
    """One fused ViT block on (B, S, D) tokens: the CUDA kernel for a CUDA
    tensor, as :func:`plan` decides (a shape it refuses, or a launch that
    fails, raises), the plain twin for a CPU tensor.  ``p`` is one block's
    param dict; its leaves are cast to ``x.dtype`` at use, so float32
    masters get their gradients through the cast.  On the card with no
    gradient needed, the cast, padded and split weights are made once per
    parameter set (:func:`_block_operands`); the autograd Function is taken
    only when a gradient is needed."""
    if x.is_cuda and x.dtype not in _DTYPE_CODES:
        raise TypeError(f"block kernel takes float32 or bfloat16, got {x.dtype}")
    if x.is_cuda:
        ready = _block_operands(x, [p[mod][field] for mod, field in _FIELDS],
                                num_heads)
        if ready is not None:
            return _launch(x, ready, num_heads, stacked=False)
    p = {mod: {field: t.to(x.dtype) for field, t in leaves.items()}
         for mod, leaves in p.items()}
    flat = [p[mod][field] for mod, field in _FIELDS]
    if not x.is_cuda:
        return block_reference(x, p, num_heads)
    return _Block.apply(x, num_heads, *flat)
