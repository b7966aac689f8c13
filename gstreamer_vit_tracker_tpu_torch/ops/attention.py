"""Multi-head softmax attention: two CUDA kernels and their plain version.

Port of ``gstreamer_vit_tracker_tpu/ops/attention.py``.  Its two TPU
kernels become two kernels of ``csrc/attention.cu``:

* ``_single_block_kernel`` -> ``attention_single``: K and V of all S keys of
  one (batch, head) loaded into shared memory once;
* ``_flash_kernel`` -> ``attention_flash``: key blocks walked through a ring
  of shared-memory stages, the next block's copy in flight.

Both compute one function, ``softmax(q k^T dh^-1/2) v`` with f32 scores, f32
row maximum and sum and one rounding to the input type, for any S >= 1;
nothing is padded in device memory.  On the H100 the work is bound by the
bytes of q, k, v and out (2.3 us at the serving shape (48, 320, 64) bf16;
the products are 1.3 us on the tensor cores), so the kernels read q, k and v
where the qkv product left them and write (B, S, D) directly:
:func:`multihead_attention` hands them strided views, no per-head copy is
made, and a block of the encoder is one launch here.

Each kernel has three variants, chosen by :func:`plan` from (dtype, head
dim) before the launch:

* ``"mma"``: bfloat16, every head dim (the tiles take 32, 64 and 128, and
  above 128 every multiple of 64; another runs zero-padded to the next of
  them, below).  Both products on the tensor cores (``wgmma``), K and V in
  shared memory as they lie, the softmax online over key blocks in the
  accumulator registers, p rounded to bf16 for the second product.  Every
  serving path takes it.
* ``"tf32x3"``: float32, every head dim (the training step, the ``small``
  preset).  Both products on the tensor cores (``mma.sync``) to float32's
  accuracy: each operand split into two TF32 parts, three products a
  product; the softmax online in the accumulator registers as in ``"mma"``.
* ``"simt"``: f32 FMA products, no tensor cores, any head dim up to 128
  that is a multiple of 8 (it keeps that limit).  It was the float32
  variant before ``"tf32x3"`` and the bf16 one of head dims the ``"mma"``
  tiles do not take before those ran padded, and stays reachable through
  ``prepared(..., chosen=Plan(route, "simt"))`` as the yardstick of the
  timings; no rule gives it.

Above a head dim of 128 both tensor-core variants run in panels of 64
columns (``csrc/attention.cu``'s panel kernels): a CTA keeps its 64 rows of
q resident in shared memory and ``Plan.group`` = G panels of the output in
registers, K and V come through a ring of panel stages, and each key
block's scores are computed once a CTA, dh / (64 G) times in all
(:func:`panel_group`).  ``"mma"``: a TMA ring (``csrc/panel_ring.cuh``,
:func:`panel_stages`).  ``"tf32x3"``: both products on ``wgmma`` in split
TF32, producer warpgroups splitting each k and v panel into its TF32 parts
once a CTA as they store it (``csrc/panel_tf32.cuh``,
:func:`tf32_panel_stages`), one CTA an SM; above a head dim of 512 q comes
through the ring too.

A head dim that the dtype's variant does not take as it is (bf16: up to
128 not 32, 64 or 128, above 128 not a multiple of 64; float32: not a
multiple of 8) is zero-padded: q, k and v are copied into contiguous
buffers whose head dim is the next of 32 / 64 / 128, above 128 the next
multiple of 64 (a whole panel), for bf16 and the next multiple of 8 for
float32 (the panel kernels zero-fill a ragged last panel in shared memory),
the kernel runs with the softmax scale of the true head dim (an argument of
the C entries), and the output is sliced back.  Zeros add exactly to an f32 sum,
so the arithmetic is the kernel's own; the padding costs work (a third more
at dh 48 -> 64 and 96 -> 128) and the copies.

and by length: ``attention_single`` while K and V of all S keys fit the shared
memory of an SM twice over (``"mma"``: 384 keys at head dim 64 on the H100;
``"tf32x3"``: 128) or once (``"simt"`` by name, which holds the f32 scores
there too), ``attention_flash`` beyond.  No result depends on the rule.  It
is a rule, not a fallback: a CUDA tensor launches the chosen kernel or
raises.  Operands whose last dimension is not contiguous, or whose bases or
strides are not multiples of 16 bytes, are copied into contiguous ones
first and then launched.

:func:`attention_reference` is the plain version: what the CPU tests run,
what the backward differentiates, and what the encoder kernel's plain twin
(``models/vit.py::_block`` with ``use_kernel=False``) uses.

``SINGLE_LAUNCHES`` and ``FLASH_LAUNCHES`` count kernel launches, so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["attention_reference", "flash_attention", "kernel_route",
           "kernel_variant", "multihead_attention", "plan", "Plan",
           "prepared", "smem_bytes", "card", "SINGLE_LAUNCHES",
           "FLASH_LAUNCHES"]

# Launches of each kernel since import (or since a caller reset them to 0).
SINGLE_LAUNCHES = 0
FLASH_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"simt": 0, "mma": 1, "tf32x3": 2}
_MMA_HEAD_DIMS = (32, 64, 128)
# Geometry of the CTAs, as csrc/attention.cu has it.  Above _TILE_MAX_DH
# the head dim runs in panels of _PANEL columns, 64-key blocks, one
# warpgroup; "simt" stops there.
_MMA_ROWS, _MMA_ALIGN = 64, 1024
_TF32_ROWS, _TF32_KEYS, _TF32_ROW_PAD = 64, 64, 4
_SIMT_ROWS = {"single": 64, "flash": 32}
_SIMT_KEY_BLOCK = 128
_TILE_MAX_DH, _PANEL = 128, 64
# "mma" above _TILE_MAX_DH (csrc/panel_ring.cuh): a CTA holds G of the
# head dim's 64-column panels of o, G a divisor of the panels up to
# _MAX_GROUP (128 accumulator registers a thread at 4); its q panels and a
# ring of panel stages of 64 rows x 128 bytes each, a full and an empty
# barrier a stage and one for q; two CTAs an SM within _TWO_CTA_BYTES each.
_MAX_GROUP, _PANEL_BYTES, _TWO_CTA_BYTES = 4, 64 * _PANEL * 2, 115712
# Two panel CTAs an SM against one: the rate :func:`panel_group` counts.
_TWO_CTA_RATE = 1.6
# (panels, group) the kernel is built for with the panels as a constant (dh
# 192 at G 3, dh 256 at G 2): a block's v panels and the next block's k
# panels held at once.
_CONST_PANELS = ((3, 3), (4, 2))
# "tf32x3" above _TILE_MAX_DH (csrc/panel_tf32.cuh): G panels of o a CTA up
# to _TF32_MAX_GROUP; q resident (16 KB a panel) up to _TF32_MAX_RESIDENT
# panels, else through the ring before each k panel; a ring of stages of
# one k or v panel's TF32 hi and lo parts (32 KB), a full and an empty
# barrier a stage and one for q, from a 1024-byte boundary; one CTA an SM.
_TF32_MAX_GROUP, _TF32_MAX_RESIDENT = 4, 8
_TF32_STAGE_BYTES, _TF32_QPANEL_BYTES = 64 * _PANEL * 8, 64 * _PANEL * 4


class Plan(NamedTuple):
    """What :func:`flash_attention` launches for one (S, dh, dtype)."""
    route: str            # "single" or "flash"
    variant: str          # "mma", "tf32x3" or "simt"
    kb: int = 0           # keys a block ("mma", "tf32x3")
    stages: int = 0       # stages of the ring ("mma", "tf32x3" flash)
    warpgroups: int = 1   # warpgroups that split a stage's keys ("mma" flash)
    pad: int = 0          # head dim q, k, v are zero-padded to (0: none)
    group: int = 0        # above 128: panels of o a CTA (0: none)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seq_len: Optional[int] = None,
                        head_dim: Optional[int] = None) -> torch.Tensor:
    """Softmax attention in float32, cast back to ``q.dtype``.

    q, k, v: (..., S, D).  With ``seq_len``, keys beyond it are masked out.
    The scores are scaled by ``head_dim ** -0.5`` (default: D's), the scale
    of the true head dim when D is a zero-padded one.
    """
    scale = (head_dim or q.shape[-1]) ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if seq_len is not None and seq_len < q.shape[-2]:
        mask = torch.arange(s.shape[-1], device=s.device) < seq_len
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...qk,...kd->...qd", p, v.float())
    return out.to(q.dtype)


def panel_smem_bytes(panels: int, stages: int) -> int:
    """Dynamic shared memory of an ``"mma"`` panel CTA with ``panels`` q
    panels and a ring of ``stages`` (``csrc/panel_ring.cuh``'s
    ``smem_bytes``)."""
    return _MMA_ALIGN + (panels + stages) * _PANEL_BYTES + 8 * (1 + 2 * stages)


def panel_stages(panels: int, group: int, optin: int) -> int:
    """The ``"mma"`` flash panel kernel's ring at ``panels`` q panels and
    ``group`` panels of o a CTA (``csrc/panel_ring.cuh``'s
    ``ring_stages``): two key blocks' loads, ``2 (panels + group)``, as far
    as two CTAs an SM fit; where q leaves no room for ``group + 1`` stages
    within two CTAs', one CTA an SM up to ``optin``; 0 if even that does
    not fit."""
    fixed, per = panel_smem_bytes(panels, 0), _PANEL_BYTES + 16
    budget = (_TWO_CTA_BYTES if fixed + (group + 1) * per <= _TWO_CTA_BYTES
              else optin)
    if fixed + (group + 1) * per > budget:
        return 0
    return min((budget - fixed) // per, 2 * (panels + group))


def tf32_panel_loads(panels: int, group: int) -> int:
    """The ``"tf32x3"`` panel ring's loads of one key block
    (``csrc/panel_tf32.cuh``'s ``block_loads``): its k panels, each after
    its q panel where q is not resident, then the G v panels."""
    return (panels if panels <= _TF32_MAX_RESIDENT else 2 * panels) + group


def tf32_panel_smem_bytes(panels: int, stages: int) -> int:
    """Dynamic shared memory of a ``"tf32x3"`` panel CTA with ``panels``
    panels of the head dim and a ring of ``stages``
    (``csrc/panel_tf32.cuh``'s ``smem_bytes``): slack to a 1024-byte
    boundary, the resident q panels, the stages, the barriers."""
    resident = panels * _TF32_QPANEL_BYTES if panels <= _TF32_MAX_RESIDENT \
        else 0
    return (_MMA_ALIGN + resident + stages * _TF32_STAGE_BYTES
            + 8 * (1 + 2 * stages))


def tf32_panel_stages(panels: int, group: int, optin: int) -> int:
    """The ``"tf32x3"`` flash panel kernel's ring
    (``csrc/panel_tf32.cuh``'s ``ring_stages``): as many stages as
    ``optin`` bytes hold beside q, up to two key blocks' loads; 0 if fewer
    than two fit."""
    fixed, per = tf32_panel_smem_bytes(panels, 0), _TF32_STAGE_BYTES + 16
    if fixed + 2 * per > optin:
        return 0
    return min((optin - fixed) // per, 2 * tf32_panel_loads(panels, group))


def panel_group(panels: int, tiles: int, sms: int, work: int,
                fits_two, most: int = _MAX_GROUP) -> int:
    """G, the panels of o a panel CTA holds, for ``panels`` 64-column
    panels of the head dim and ``tiles`` 64-row tiles (x batch x heads), by
    a count of the panel products on the busiest SM: a CTA takes ``work``
    k panels a key block per panel of q (once a pass) plus G v panels; the
    grid of ``tiles x panels / G`` CTAs puts ``ceil(grid / sms)`` of them on
    it, and two CTAs that share an SM (where ``fits_two(G)``) take
    _TWO_CTA_RATE times one's rate, hiding each other's latencies.  The
    cheapest divisor of ``panels`` up to ``most``, the larger on a tie.
    Fitted on the card (``profile_attention.py``, ``profile_encoder.py
    wide``; PERF.md §5-§6): kernels 3 / 4 at (64, 320, 256) G 4, at (64,
    100, 256) G 2 (256 CTAs two an SM beat 128 alone at G 4), at (3, 1040,
    256) G 2 (one CTA an SM beats two at G 1); the encoder G 2 at Model A's
    batch 16, 1 at its batch 1.  ``"tf32x3"`` (one CTA an SM, ``fits_two``
    never): G 4 at (16, 320, 256), 3 at (16, 320, 192), 1 at its encoder's
    batch 1."""
    best = None
    for g in range(min(most, panels), 0, -1):
        if panels % g:
            continue
        n = -(-tiles * (panels // g) // sms)
        cost = n * (work * panels + g) / (
            _TWO_CTA_RATE if n >= 2 and fits_two(g) else 1)
        if best is None or cost < best[0]:
            best = (cost, g)
    return best[1]


def _panel_plan(s: int, panels: int, group: int, tiles: int, optin: int,
                sms: int) -> Plan:
    """The ``"mma"`` panel plan at G = ``group``: ``"single"`` (a ring of
    every load: nothing waits for a stage, and each stage's copy is waited
    for alone, so a lone CTA an SM loses nothing) while its CTA fits two an
    SM, or one where the grid is no larger than the card; else
    ``"flash"`` with the ring of :func:`panel_stages`."""
    single = panel_smem_bytes(panels, -(-s // _TF32_KEYS) * (panels + group))
    if single <= _TWO_CTA_BYTES or (
            single <= optin and tiles * (panels // group) <= sms):
        return Plan("single", "mma", kb=_TF32_KEYS, group=group)
    return Plan("flash", "mma", kb=_TF32_KEYS,
                stages=panel_stages(panels, group, optin), group=group)


def smem_bytes(route: str, variant: str, s: int, dh: int, elem_bytes: int,
               kb: int = 0, stages: int = 0, warpgroups: int = 1,
               group: int = 0) -> int:
    """Dynamic shared memory of one CTA, as ``csrc/attention.cu`` lays it
    out (``attention_smem`` there returns the same number).  Above a head
    dim of 128 (the panel kernels): the q panels and a ring of ``stages``
    panel stages, ``"single"`` one of every load of the walk (each key
    block's k panels and ``group`` v panels): ``"mma"``'s
    :func:`panel_smem_bytes`, ``"tf32x3"``'s
    :func:`tf32_panel_smem_bytes`."""
    if variant == "mma" and dh > _TILE_MAX_DH:
        panels = dh // _PANEL
        if route == "single":
            stages = -(-s // _TF32_KEYS) * (panels + group)
        return panel_smem_bytes(panels, stages)
    if variant == "tf32x3" and dh > _TILE_MAX_DH:
        panels = -(-dh // _PANEL)
        if route == "single":
            stages = -(-s // _TF32_KEYS) * tf32_panel_loads(panels, group)
        return tf32_panel_smem_bytes(panels, stages)
    if variant in ("mma", "tf32x3"):
        keys = (-(-s // kb) * kb if route == "single"
                else stages * warpgroups * kb)
        if variant == "mma":
            return _MMA_ALIGN + (_MMA_ROWS + 2 * keys) * dh * 2
        return (_TF32_ROWS + 2 * keys) * (dh + _TF32_ROW_PAD) * 4
    rows = _SIMT_ROWS[route]
    keys = s if route == "single" else _SIMT_KEY_BLOCK
    words = ((keys + 2) * elem_bytes + 3) // 4       # transposed K: odd words
    k_stride = (words + 1 - words % 2) * 4 // elem_bytes
    return (dh * k_stride * elem_bytes + keys * dh * elem_bytes
            + rows * dh * 4 + rows * (-(-keys // 4) * 4) * 4)


def variant_pad(variant: str, dh: int) -> int:
    """The head dim ``variant`` runs a head dim ``dh`` at when it does not
    take it as it is, else 0: ``"mma"`` the next of 32, 64 and 128, above
    128 the next multiple of 64 (a whole panel); ``"tf32x3"`` and
    ``"simt"`` the next multiple of 8."""
    if variant == "mma":
        if dh > _TILE_MAX_DH:
            return 0 if dh % _PANEL == 0 else -(-dh // _PANEL) * _PANEL
        return 0 if dh in _MMA_HEAD_DIMS else next(
            d for d in _MMA_HEAD_DIMS if d > dh)
    return 0 if dh % 8 == 0 else -(-dh // 8) * 8


def padded_head_dim(dh: int, dtype: torch.dtype) -> int:
    """The head dim q, k and v are zero-padded to, 0 if the dtype's
    variant takes ``dh`` as it is: bf16 (``"mma"``) pads every head dim up
    to 128 but 32, 64 and 128 to the next of them and one above 128 to the
    next multiple of 64; float32 (``"tf32x3"``) one that is no multiple of
    8 to the next multiple of 8.  Below 1 it raises ``ValueError``."""
    if dh < 1:
        raise ValueError(f"head dim {dh} must be at least 1")
    return variant_pad("mma" if dtype == torch.bfloat16 else "tf32x3", dh)


def entry_head_dims(dh: int, chosen: Plan) -> Tuple[int, int]:
    """(head dim the kernel runs at, head dim its softmax scale is taken
    from): the padded one and the true one."""
    return chosen.pad or dh, dh


def plan(s: int, dh: int, dtype: torch.dtype, optin_bytes: int,
         bh: int = 1, sms: int = 132) -> Plan:
    """The kernel and variant for sequence length ``s``, head dim ``dh`` and
    ``dtype`` on a card whose blocks may opt in to ``optin_bytes`` of shared
    memory.  A head dim no variant takes as it is gets ``pad``
    (:func:`padded_head_dim`) and the plan of the padded one.

    Variant: ``"tf32x3"`` for float32, ``"mma"`` for bf16 (``"simt"``
    only by name).  Kernel: ``"single"`` while two CTAs that hold all S
    keys fit one SM (one CTA's copies then fly while the other computes;
    measured, a lone CTA that first waits for 600 keys loses to the ring);
    ``"flash"`` beyond, ``"tf32x3"`` with a ring of two 64-key blocks.
    ``bh`` (batch x heads) and the card's ``sms`` only shape the ``"mma"``
    ring: while the 64-row tiles are fewer than the SMs, two warpgroups a
    CTA split the keys of 128-key blocks; a grid that fills the card takes
    64-key blocks, one warpgroup and more CTAs an SM.  Above a head dim of
    128 (the panel kernels), 64-key blocks, ``group`` = :func:`panel_group`:
    ``"mma"`` the route of :func:`_panel_plan`; ``"tf32x3"`` (one CTA an
    SM) ``"single"`` while a ring of every load of the walk fits
    ``optin_bytes``, else ``"flash"`` with the ring of
    :func:`tf32_panel_stages`."""
    pad = padded_head_dim(dh, dtype)
    if pad:
        return plan(s, pad, dtype, optin_bytes, bh, sms)._replace(pad=pad)
    if dtype == torch.bfloat16 and dh > _TILE_MAX_DH:
        panels, tiles = dh // _PANEL, -(-s // _MMA_ROWS) * bh

        def plan_at(g):
            return _panel_plan(s, panels, g, tiles, optin_bytes, sms)

        return plan_at(panel_group(
            panels, tiles, sms, 1, lambda g: smem_bytes(
                plan_at(g).route, "mma", s, dh, 2, _TF32_KEYS,
                plan_at(g).stages, 1, g) <= _TWO_CTA_BYTES))
    if dtype == torch.float32 and dh > _TILE_MAX_DH:
        panels, tiles = -(-dh // _PANEL), -(-s // _TF32_ROWS) * bh
        g = panel_group(panels, tiles, sms, 1, lambda g: False,
                        _TF32_MAX_GROUP)
        if smem_bytes("single", "tf32x3", s, dh, 4, _TF32_KEYS, 0, 1,
                      g) <= optin_bytes:
            return Plan("single", "tf32x3", kb=_TF32_KEYS, group=g)
        return Plan("flash", "tf32x3", kb=_TF32_KEYS,
                    stages=tf32_panel_stages(panels, g, optin_bytes), group=g)
    if dtype == torch.float32:
        if smem_bytes("single", "tf32x3", s, dh, 4,
                      kb=_TF32_KEYS) <= optin_bytes // 2:
            return Plan("single", "tf32x3", kb=_TF32_KEYS)
        return Plan("flash", "tf32x3", kb=_TF32_KEYS, stages=2)
    if smem_bytes("single", "mma", s, dh, 2, kb=64) <= optin_bytes // 2:
        return Plan("single", "mma", kb=64)
    if -(-s // _MMA_ROWS) * bh > sms:
        return Plan("flash", "mma", kb=64, stages=2, warpgroups=1)
    return Plan("flash", "mma", kb=128 if dh <= 64 else 64, stages=2,
                warpgroups=2)


_Strides = ctypes.c_longlong * 12
_FORWARD: Dict[str, ctypes._CFuncPtr] = {}     # route -> the C entry


def _library():
    lib = cuda_build.load("attention")
    if not _FORWARD:
        for route, fn in (("single", lib.attention_single_forward),
                          ("flash", lib.attention_flash_forward)):
            fn.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p] * 6
            fn.restype = ctypes.c_int
            _FORWARD[route] = fn
        lib.attention_smem.argtypes = [ctypes.c_int] * 9
        lib.attention_smem.restype = ctypes.c_longlong
        lib.attention_ring_stages.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_longlong]
        lib.attention_ring_stages.restype = ctypes.c_int
        lib.attention_tf32_ring_stages.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_longlong]
        lib.attention_tf32_ring_stages.restype = ctypes.c_int
    return lib


_CARD: Dict[int, Tuple[int, int]] = {}   # device index -> (opt-in bytes, SMs)
_PLANS: Dict[Tuple, Plan] = {}           # (device, S, dh, dtype, bh) -> Plan
_STRIDES: Dict[Tuple, ctypes.Array] = {}  # element strides -> the C array
_raw_stream = None                       # current stream handle of a device


def card(device: torch.device) -> Tuple[int, int]:
    """(opt-in shared memory of a block in bytes, SMs) of a CUDA device,
    read once per device."""
    got = _CARD.get(device.index)
    if got is None:
        props = torch.cuda.get_device_properties(device)
        got = _CARD[device.index] = (props.shared_memory_per_block_optin,
                                     props.multi_processor_count)
    return got


def _plan_for(device: torch.device, s: int, dh: int, dtype: torch.dtype,
              bh: int) -> Plan:
    """:func:`plan` on this device, decided once per argument tuple."""
    key = (device.index, s, dh, dtype, bh)
    chosen = _PLANS.get(key)
    if chosen is None:
        optin, sms = card(device)
        chosen = _PLANS[key] = plan(s, dh, dtype, optin, bh, sms)
    return chosen


def _aligned(t: torch.Tensor) -> bool:
    """Whether ``t`` has a contiguous last dimension and a 16-byte aligned
    base and strides (what the kernels read in place)."""
    *lead, last = t.stride()
    bits = t.data_ptr()
    for st in lead:
        bits |= st * t.element_size()
    return last == 1 and not bits & 15


def _laid_out(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each tensor where the kernels can read it in place, else a
    contiguous copy (whose base and strides are then 16-byte aligned: the
    head dim is a multiple of 8)."""
    return tuple(t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)
                 for t in ts)


def _stream_handle(index: int) -> int:
    """The current stream of device ``index`` as the integer a launch takes."""
    global _raw_stream
    if _raw_stream is None:
        # PyTorch's own accessor (what its compiled kernels launch on); the
        # public object costs several microseconds a call.
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


def kernel_route(q: torch.Tensor, num_heads: int = 1) -> str:
    """Which kernel launches for this CUDA tensor, (batch*heads, S, dh) or
    (B, S, num_heads * dh): ``"single"`` or ``"flash"``."""
    return _plan_for(q.device, q.shape[1], q.shape[2] // num_heads, q.dtype,
                     q.shape[0] * num_heads).route


def kernel_variant(q: torch.Tensor, num_heads: int = 1) -> str:
    """Which variant of that kernel: ``"mma"``, ``"tf32x3"`` or
    ``"simt"``."""
    return _plan_for(q.device, q.shape[1], q.shape[2] // num_heads, q.dtype,
                     q.shape[0] * num_heads).variant


def _padded(t: torch.Tensor, heads: int, pad: int) -> torch.Tensor:
    """(B, S, heads * dh) copied into a contiguous (B, S, heads * pad) whose
    head dims past dh are zeros: one copy, which also lays the operand out
    for the kernels."""
    b, s, dm = t.shape
    dh = dm // heads
    return F.pad(t.reshape(b, s, heads, dh), (0, pad - dh)).reshape(
        b, s, heads * pad)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           heads: int) -> None:
    """Raise on anything the kernels do not take."""
    if not q.is_cuda:
        raise ValueError("the attention kernels need CUDA tensors")
    dtype, shape = q.dtype, q.shape
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if len(shape) != 3 or 0 in shape or shape[2] % heads:
        raise ValueError(f"q must be (B, S, heads * dh) with S >= 1, got "
                         f"shape {tuple(shape)} for {heads} heads")
    if not (k.shape == shape == v.shape and k.dtype == dtype == v.dtype
            and k.device == q.device == v.device):
        raise ValueError("k or v: " + ", ".join(
            f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in (k, v))
            + f"; expected {tuple(shape)} {dtype} on {q.device}")


def _refusal(chosen: Plan, s: int, dh: int, optin: int) -> Optional[str]:
    """Why the kernels cannot launch ``chosen`` at length ``s`` and the
    head dim ``dh`` they run at on a card of ``optin`` bytes a block, or
    None: ``group`` belongs to the tensor-core variants above a head dim of
    128 alone and there is a divisor of its panels up to 4, a flash ring
    holds more than ``group`` stages (``"tf32x3"``: two), and the CTA fits
    the card."""
    if chosen.variant == "simt" or dh <= _TILE_MAX_DH:
        return None if chosen.group == 0 else "group is for panels above 128"
    tf32 = chosen.variant == "tf32x3"
    panels, most = ((-(-dh // _PANEL), _TF32_MAX_GROUP) if tf32
                    else (dh // _PANEL, _MAX_GROUP))
    if not 1 <= chosen.group <= most or panels % chosen.group:
        return f"group must divide {panels} panels and be 1 to {most}"
    least = (2 if tf32 else panels + chosen.group
             if (panels, chosen.group) in _CONST_PANELS else chosen.group + 1)
    if chosen.route == "flash" and chosen.stages < least:
        return f"a flash ring needs {least} stages or more"
    need = smem_bytes(chosen.route, chosen.variant, s, dh, 4 if tf32 else 2,
                      chosen.kb, chosen.stages, chosen.warpgroups,
                      chosen.group)
    if need > optin:
        return f"its CTA needs {need} bytes of shared memory, the card {optin}"
    return None


def _operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              chosen: Optional[Plan]):
    """Checks, the plan, q, k and v as the kernel reads them (read in
    place, copied where their layout asks for it, or zero-padded), the
    output (B, S, heads * the kernel's head dim) and the C entry's arguments
    up to the stream, for q, k, v of shape (B, S, heads * dh).  A plan a
    caller named gets its variant's pad (:func:`variant_pad`)."""
    _check(q, k, v, heads)
    b, s, dm = q.shape
    if chosen is None:
        chosen = _plan_for(q.device, s, dm // heads, q.dtype, b * heads)
    else:
        if chosen.variant == "simt" and dm // heads > _TILE_MAX_DH:
            raise ValueError(f"simt takes head dims up to {_TILE_MAX_DH}, "
                             f"not {dm // heads}")
        chosen = chosen._replace(pad=variant_pad(chosen.variant, dm // heads))
    dh, scale_dh = entry_head_dims(dm // heads, chosen)
    why = _refusal(chosen, s, dh, card(q.device)[0])
    if why is not None:
        raise ValueError(f"attention {chosen}: {why}")
    if chosen.pad:
        q, k, v = (_padded(t, heads, chosen.pad) for t in (q, k, v))
        dm = heads * dh
    else:
        q, k, v = _laid_out(q, k, v)
    if not _FORWARD:
        _library()
    out = torch.empty((b, s, dm), dtype=q.dtype, device=q.device)
    strides = q.stride(), k.stride(), v.stride()
    key = (strides, s, dm, heads)
    c_strides = _STRIDES.get(key)
    if c_strides is None:
        if len(_STRIDES) >= 256:
            _STRIDES.clear()
        (qb, qr, _), (kb, kr, _), (vb, vr, _) = strides
        c_strides = _STRIDES[key] = _Strides(          # batch, head, row
            qb, dh, qr, kb, dh, kr, vb, dh, vr, s * dm, dh, dm)
    return chosen, out, (q, k, v), (
        _VARIANT_CODES[chosen.variant], chosen.kb, chosen.stages,
        chosen.warpgroups, chosen.group, _DTYPE_CODES[q.dtype], b, heads, s,
        dh, scale_dh,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), c_strides)


def _enqueue(chosen: Plan, args: Tuple, index: int) -> None:
    """Launch on the current stream of device ``index`` (the current
    device), check the launch, count it."""
    global SINGLE_LAUNCHES, FLASH_LAUNCHES
    err = _FORWARD[chosen.route](*args, _stream_handle(index))
    if err != 0:
        raise RuntimeError(f"attention_{chosen.route}_forward ({chosen.variant}"
                           f") failed: CUDA error {err}")
    if chosen.route == "single":
        SINGLE_LAUNCHES += 1
    else:
        FLASH_LAUNCHES += 1


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int = 1, chosen: Optional[Plan] = None) -> torch.Tensor:
    """One kernel launch on q, k, v of shape (B, S, heads * dh), read where
    they lie (any batch and row strides whose layout the kernels take, else
    copied first; a padded head dim zero-padded copies); returns a
    contiguous (B, S, heads * dh).  ``chosen`` overrides the plan."""
    index = q.device.index
    if q.is_cuda and index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(q, k, v, heads, chosen)
    # keep: copies made for the launch, alive until it is enqueued.
    chosen, out, keep, args = _operands(q, k, v, heads, chosen)
    _enqueue(chosen, args, index)
    if chosen.pad:
        b, s, dm = q.shape
        out = out.view(b, s, heads, chosen.pad)[..., :dm // heads].reshape(
            b, s, dm)
    return out


def prepared(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             heads: int = 1, chosen: Optional[Plan] = None):
    """``(out, launch)``: ``launch()`` enqueues the kernel on these operands
    into ``out`` again and nothing else, on the current stream of the
    current device.  For timing a launch apart from the wrapper, one variant
    beside another (``chosen``), and for capture into a CUDA graph.  For a
    padded head dim ``out`` is the padded (B, S, heads * pad) the kernel
    writes."""
    chosen, out, keep, args = _operands(q, k, v, heads, chosen)
    index = q.device.index

    def launch(keep=keep):        # the operands live as long as launch does
        _enqueue(chosen, args, index)

    return out, launch


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, heads * dh) as the (B, heads, S, dh) view the plain version
    takes."""
    b, s, dm = t.shape
    return t.reshape(b, s, heads, dm // heads).transpose(1, 2)


def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           heads: int) -> torch.Tensor:
    """The plain version on (B, S, heads * dh)."""
    out = attention_reference(_split(q, heads), _split(k, heads),
                              _split(v, heads))
    return out.transpose(1, 2).reshape(q.shape)


class _Flash(torch.autograd.Function):
    """Forward: a CUDA kernel.  Backward: autograd of the plain version, as
    the JAX ``custom_vjp`` (neither TPU kernel has a backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        return _launch(q, k, v, heads)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            inputs = [t for t in qkv if t.requires_grad]
            grads = iter(torch.autograd.grad(_plain(*qkv, ctx.heads), inputs,
                                             grad))
        return (*(next(grads) if t.requires_grad else None for t in qkv), None)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int) -> torch.Tensor:
    """The kernels on (B, S, heads * dh); through the autograd Function only
    when a gradient is wanted."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, heads)
    return _launch(q, k, v, heads)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention over (batch*heads, S, dh) per-head inputs: a CUDA kernel
    for CUDA tensors (chosen by :func:`plan`; raises if it cannot launch),
    the plain version for CPU tensors.  The kernels read the operands in
    place where their layout allows (else a copy is made first)."""
    if not q.is_cuda:
        return attention_reference(q, k, v)
    return _attend(q, k, v, 1)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Split (B, S, D_model) into heads, attend, merge.

    ``use_kernel`` is the counterpart of the JAX package's ``use_pallas``:
    ``None`` takes the CUDA kernels for a CUDA tensor and the plain version
    for a CPU tensor; ``False`` always takes the plain version; ``True`` on
    a CPU tensor raises (the kernels have no CPU mode).  On a CUDA tensor
    the kernels launch or raise (a launch that fails): the plain version is
    reached there only by ``use_kernel=False``.  A head dim no variant
    takes as it is runs zero-padded (:func:`plan`).

    The kernels read q, k and v in place (any views whose last dimension is
    contiguous and whose bases and strides are 16-byte aligned, such as the
    three ``chunk`` s of a qkv product; others are copied first) and write
    (B, S, D_model): one launch, no copy.
    """
    if use_kernel is None:
        use_kernel = q.is_cuda
    elif use_kernel and not q.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors: the attention "
                         "kernels have no CPU mode")
    if use_kernel:
        return _attend(q, k, v, num_heads)
    return _plain(q, k, v, num_heads)
