"""The whole ViT encoder, and one block of it, as CUDA kernel calls with
their plain twins.

Port of ``gstreamer_vit_tracker_tpu/ops/vit_block.py::encoder``, whose TPU
kernel ``_encoder_kernel`` runs every block in one ``pallas_call`` with the
activation carried in VMEM.  Here the kernel is
``csrc/vit_encoder.cu::vit_encoder_forward``: a host loop over depth that
launches LN, the four products (fused bias / GELU / residual epilogues)
and attention on the caller's stream.  The source's header states what
bounds it on the H100.

:func:`encoder` takes the kernel for a CUDA tensor and the plain twin
:func:`encoder_reference` (a chain of ``models/vit.py::_block``, which
rounds where the kernel rounds) for a CPU tensor; it has no fallback from
one to the other.  On the card it is a ``torch.autograd.Function`` whose
backward differentiates the plain twin, as the JAX ``custom_vjp`` does.

:func:`block` is the port of the TPU's per-block kernel ``_block_kernel``
(``vit_block.block``: one block, a grid over the batch): the entry
``vit_block_forward`` of the same source, one block's own weights, any
batch.  Its plain twin is :func:`block_reference`; its backward
differentiates that twin and returns gradients for ``x`` and every leaf of
the block's parameters, as ``_block_bwd`` does.

``LAUNCHES`` counts encoder-kernel launches (one per encoder call on the
card) and ``BLOCK_LAUNCHES`` block-kernel launches, so a run can show that
its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Sequence

import torch

from . import cuda_build

Params = Dict[str, Any]

__all__ = ["encoder", "encoder_reference", "block", "block_reference",
           "LAUNCHES", "BLOCK_LAUNCHES"]

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = 0
BLOCK_LAUNCHES = 0

# Per-block parameters in the kernel's argument order: (module, field).
_FIELDS = (("ln1", "scale"), ("ln1", "bias"), ("qkv", "kernel"),
           ("qkv", "bias"), ("proj", "kernel"), ("proj", "bias"),
           ("ln2", "scale"), ("ln2", "bias"), ("mlp1", "kernel"),
           ("mlp1", "bias"), ("mlp2", "kernel"), ("mlp2", "bias"))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def encoder_reference(x: torch.Tensor, blocks: Sequence[Params],
                      num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the blocks chained."""
    from ..models import vit   # vit imports this module

    for p in blocks:
        x = vit._block(x, p, num_heads)
    return x


def _library():
    lib = cuda_build.load("vit_encoder")
    fn = lib.vit_encoder_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 19
        fn.restype = ctypes.c_int
        lib.vit_block_forward.argtypes = ([ctypes.c_int] * 6
                                          + [ctypes.c_void_p] * 19)
        lib.vit_block_forward.restype = ctypes.c_int
        lib.vit_encoder_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.vit_encoder_attention_smem.restype = ctypes.c_longlong
    return lib


def _check(x: torch.Tensor, weights: List[torch.Tensor], num_heads: int,
           stacked: bool):
    """Raise on anything the kernels do not take.  ``weights`` in
    ``_FIELDS`` order: stacked over depth for the encoder, one block's own
    for the block kernel."""
    if not x.is_cuda:
        raise ValueError("the encoder kernel needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"encoder kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S, D) tensor, got "
                         f"shape {tuple(x.shape)}")
    b, s, d = x.shape
    if d % num_heads:
        raise ValueError(f"embed dim {d} is not divisible by {num_heads} heads")
    dh = d // num_heads
    if dh % 16 or dh > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} must be a multiple of 16 up to "
                         f"{_MAX_HEAD_DIM}")
    lead = (weights[0].shape[0],) if stacked else ()
    hidden = weights[8].shape[-1]
    if hidden % 16:
        raise ValueError(f"MLP width {hidden} must be a multiple of 16")
    want = [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
            (d, hidden), (hidden,), (hidden, d), (d,)]
    for (mod, field), t, shape in zip(_FIELDS, weights, want):
        shape = lead + shape
        if tuple(t.shape) != shape:
            raise ValueError(f"{mod}/{field}: shape {tuple(t.shape)}, "
                             f"kernel expects {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{mod}/{field}: {t.dtype} on {t.device}, "
                             f"kernel expects {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{mod}/{field} is not contiguous")


def _launch(x: torch.Tensor, weights: List[torch.Tensor], num_heads: int,
            stacked: bool) -> torch.Tensor:
    """``vit_encoder_forward`` on weights stacked over depth, or
    ``vit_block_forward`` on one block's own."""
    global LAUNCHES, BLOCK_LAUNCHES
    _check(x, weights, num_heads, stacked)
    b, s, d = x.shape
    hidden = weights[8].shape[-1]
    lib = _library()
    dh = d // num_heads
    elem = x.element_size()
    with torch.cuda.device(x.device):
        smem = lib.vit_encoder_attention_smem(s, dh, elem)
        optin = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
        if smem > optin:
            raise ValueError(
                f"sequence {s} x head dim {dh} needs {smem} bytes of shared "
                f"memory for K and V, above the card's {optin}")
        m = b * s
        out = torch.empty_like(x)
        h = torch.empty((m, d), dtype=x.dtype, device=x.device)
        attn = torch.empty_like(h)
        qkv = torch.empty((m, 3 * d), dtype=x.dtype, device=x.device)
        hid = torch.empty((m, hidden), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tensors = (x.data_ptr(), out.data_ptr(),
                   *[t.data_ptr() for t in weights], h.data_ptr(),
                   qkv.data_ptr(), attn.data_ptr(), hid.data_ptr(), stream)
        dims = (_DTYPE_CODES[x.dtype], b, s, d, num_heads, hidden)
        if stacked:
            name = "vit_encoder_forward"
            err = lib.vit_encoder_forward(*dims, weights[0].shape[0], *tensors)
        else:
            name = "vit_block_forward"
            err = lib.vit_block_forward(*dims, *tensors)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    if stacked:
        LAUNCHES += 1
    else:
        BLOCK_LAUNCHES += 1
    return out


def _stack(flat: Sequence[torch.Tensor], depth: int) -> List[torch.Tensor]:
    n = len(_FIELDS)
    return [torch.stack([flat[i * n + f] for i in range(depth)]).contiguous()
            for f in range(n)]


def _blocks_from_flat(flat: Sequence[torch.Tensor], depth: int) -> List[Params]:
    n = len(_FIELDS)
    blocks = []
    for i in range(depth):
        p: Params = {}
        for f, (mod, field) in enumerate(_FIELDS):
            p.setdefault(mod, {})[field] = flat[i * n + f]
        blocks.append(p)
    return blocks


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
    tensor (raises if it cannot launch), the plain twin for a CPU tensor.
    ``blocks`` are per-block param dicts already in ``x.dtype``."""
    if not x.is_cuda:
        return encoder_reference(x, blocks, num_heads)
    flat = [blk[mod][field] for blk in blocks for mod, field in _FIELDS]
    return _Encoder.apply(x, num_heads, len(blocks), *flat)


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
        return _launch(x, [t.contiguous() for t in flat], num_heads,
                       stacked=False)

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
    tensor (raises if it cannot launch), the plain twin for a CPU tensor.
    ``p`` is one block's param dict; its leaves are cast to ``x.dtype`` at
    use, so float32 masters get their gradients through the cast."""
    p = {mod: {field: t.to(x.dtype) for field, t in leaves.items()}
         for mod, leaves in p.items()}
    if not x.is_cuda:
        return block_reference(x, p, num_heads)
    flat = [p[mod][field] for mod, field in _FIELDS]
    return _Block.apply(x.contiguous(), num_heads, *flat)
