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

* ``"mma"``: bfloat16 with head dim 32, 64 or 128.  Both products on the
  tensor cores (``wgmma``), K and V in shared memory as they lie, the softmax
  online over key blocks in the accumulator registers, p rounded to bf16 for
  the second product.  Every serving path takes it.
* ``"tf32x3"``: float32, every head dim (the training step, the ``small``
  preset).  Both products on the tensor cores (``mma.sync``) to float32's
  accuracy: each operand split into two TF32 parts, three products a
  product; the softmax online in the accumulator registers as in ``"mma"``.
* ``"simt"``: bf16 head dims the tiles do not take (f32 FMA products, no
  tensor cores).  It was the float32 variant before ``"tf32x3"`` and stays
  reachable through ``prepared(..., chosen=Plan(route, "simt"))`` as the
  yardstick of the timings.

A head dim from 1 to 128 that no variant takes (not a multiple of 8) is
zero-padded: q, k and v are copied into contiguous buffers whose head dim is
the next of 32 / 64 / 128 for bf16 (so that ``"mma"`` runs) or the next
multiple of 8 for float32, the kernel runs with the softmax scale of the
true head dim (an argument of the C entries), and the output is sliced
back.  Zeros add exactly to an f32 sum, so the arithmetic is the kernel's
own.

and by length: ``attention_single`` while K and V of all S keys fit the shared
memory of an SM twice over (``"mma"``: 384 keys at head dim 64 on the H100;
``"tf32x3"``: 128) or once (``"simt"``, which holds the f32 scores there
too), ``attention_flash`` beyond.  No result depends on the rule.  It is a
rule, not a fallback: a CUDA tensor launches the chosen kernel or raises.
A head dim above 128 raises (a tile's shared memory and registers hold 128);
operands whose last dimension is not contiguous, or whose bases or strides
are not multiples of 16 bytes, are copied into contiguous ones first and
then launched.

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
_MAX_HEAD_DIM = 128
_MMA_HEAD_DIMS = (32, 64, 128)
# Geometry of the CTAs, as csrc/attention.cu has it.
_MMA_ROWS, _MMA_ALIGN = 64, 1024
_TF32_ROWS, _TF32_KEYS, _TF32_ROW_PAD = 64, 64, 4
_SIMT_ROWS = {"single": 64, "flash": 32}
_SIMT_KEY_BLOCK = 128


class Plan(NamedTuple):
    """What :func:`flash_attention` launches for one (S, dh, dtype)."""
    route: str            # "single" or "flash"
    variant: str          # "mma", "tf32x3" or "simt"
    kb: int = 0           # keys a block ("mma", "tf32x3")
    stages: int = 0       # stages of the ring ("mma", "tf32x3" flash)
    warpgroups: int = 1   # warpgroups that split a stage's keys ("mma" flash)
    pad: int = 0          # head dim q, k, v are zero-padded to (0: none)


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


def smem_bytes(route: str, variant: str, s: int, dh: int, elem_bytes: int,
               kb: int = 0, stages: int = 0, warpgroups: int = 1) -> int:
    """Dynamic shared memory of one CTA, as ``csrc/attention.cu`` lays it
    out (``attention_smem`` there returns the same number)."""
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


def padded_head_dim(dh: int, dtype: torch.dtype) -> int:
    """The head dim q, k and v are zero-padded to, 0 if a variant takes
    ``dh`` as it is (a multiple of 8); bf16 pads to the next of 32 / 64 /
    128 (``"mma"``), float32 to the next multiple of 8 (``"tf32x3"``).
    Above 128 it raises ``ValueError``."""
    if dh < 1 or dh > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} must be 1 to {_MAX_HEAD_DIM}")
    if dh % 8 == 0:
        return 0
    if dtype == torch.bfloat16:
        return next(d for d in _MMA_HEAD_DIMS if d > dh)
    return -(-dh // 8) * 8


def entry_head_dims(dh: int, chosen: Plan) -> Tuple[int, int]:
    """(head dim the kernel runs at, head dim its softmax scale is taken
    from): the padded one and the true one."""
    return chosen.pad or dh, dh


def plan(s: int, dh: int, dtype: torch.dtype, optin_bytes: int,
         bh: int = 1, sms: int = 132) -> Plan:
    """The kernel and variant for sequence length ``s``, head dim ``dh`` and
    ``dtype`` on a card whose blocks may opt in to ``optin_bytes`` of shared
    memory.  A head dim no variant takes as it is gets ``pad``
    (:func:`padded_head_dim`) and the plan of the padded one; above 128 it
    raises ``ValueError``.

    Variant: ``"tf32x3"`` for float32, ``"mma"`` for bf16 at the head dims
    the tiles take, ``"simt"`` for other bf16 head dims.  Kernel:
    ``"mma"`` and ``"tf32x3"`` take ``"single"`` while two CTAs that hold
    all S keys fit one SM (one CTA's copies then fly while the other
    computes; measured, a lone CTA that first waits for 600 keys loses to
    the ring), ``"simt"`` while one fits; ``"flash"`` beyond, ``"tf32x3"``
    with a ring of two 64-key blocks.  ``bh`` (batch x heads)
    and the card's ``sms`` only shape the ``"mma"`` ring: while the 64-row
    tiles are fewer than the SMs, two warpgroups a CTA split the keys of
    128-key blocks; a grid that fills the card takes 64-key blocks, one
    warpgroup and more CTAs an SM."""
    pad = padded_head_dim(dh, dtype)
    if pad:
        return plan(s, pad, dtype, optin_bytes, bh, sms)._replace(pad=pad)
    if dtype == torch.float32:
        if smem_bytes("single", "tf32x3", s, dh, 4,
                      kb=_TF32_KEYS) <= optin_bytes // 2:
            return Plan("single", "tf32x3", kb=_TF32_KEYS)
        return Plan("flash", "tf32x3", kb=_TF32_KEYS, stages=2)
    if dh in _MMA_HEAD_DIMS:
        if smem_bytes("single", "mma", s, dh, 2, kb=64) <= optin_bytes // 2:
            return Plan("single", "mma", kb=64)
        if -(-s // _MMA_ROWS) * bh > sms:
            return Plan("flash", "mma", kb=64, stages=2, warpgroups=1)
        return Plan("flash", "mma", kb=128 if dh <= 64 else 64, stages=2,
                    warpgroups=2)
    if smem_bytes("single", "simt", s, dh, 2) <= optin_bytes:
        return Plan("single", "simt")
    return Plan("flash", "simt")


_Strides = ctypes.c_longlong * 12
_FORWARD: Dict[str, ctypes._CFuncPtr] = {}     # route -> the C entry


def _library():
    lib = cuda_build.load("attention")
    if not _FORWARD:
        for route, fn in (("single", lib.attention_single_forward),
                          ("flash", lib.attention_flash_forward)):
            fn.argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 6
            fn.restype = ctypes.c_int
            _FORWARD[route] = fn
        lib.attention_smem.argtypes = [ctypes.c_int] * 8
        lib.attention_smem.restype = ctypes.c_longlong
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
    if shape[2] // heads > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {shape[2] // heads} must be 1 to "
                         f"{_MAX_HEAD_DIM}")
    if not (k.shape == shape == v.shape and k.dtype == dtype == v.dtype
            and k.device == q.device == v.device):
        raise ValueError("k or v: " + ", ".join(
            f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in (k, v))
            + f"; expected {tuple(shape)} {dtype} on {q.device}")


def _operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              chosen: Optional[Plan]):
    """Checks, the plan, q, k and v as the kernel reads them (read in
    place, copied where their layout asks for it, or zero-padded), the
    output (B, S, heads * the kernel's head dim) and the C entry's arguments
    up to the stream, for q, k, v of shape (B, S, heads * dh)."""
    _check(q, k, v, heads)
    b, s, dm = q.shape
    if chosen is None:
        chosen = _plan_for(q.device, s, dm // heads, q.dtype, b * heads)
    dh, scale_dh = entry_head_dims(dm // heads, chosen)
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
        chosen.warpgroups, _DTYPE_CODES[q.dtype], b, heads, s, dh, scale_dh,
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
    the kernels launch or raise (a head dim they cannot take): the plain
    version is reached there only by ``use_kernel=False``.  A head dim no
    variant takes as it is runs zero-padded (:func:`plan`).

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
