"""Multi-head softmax attention: two CUDA kernels and their plain version.

Port of ``gstreamer_vit_tracker_tpu/ops/attention.py``.  Its two TPU
kernels become two kernels of ``csrc/attention.cu``:

* ``_single_block_kernel`` -> ``attention_single``: the whole sequence of
  one (batch x head) in shared memory, plain softmax;
* ``_flash_kernel`` -> ``attention_flash``: blocked online softmax over
  key blocks of 128.

:func:`flash_attention` is the one entry to both.  Its rule is the card's,
not the TPU's ``SINGLE_BLOCK_MAX``: ``attention_single`` while K and V of
all S keys (with the query tile and its scores) fit the shared memory one
block may opt in to (``shared_memory_per_block_optin``; at head dim 64 in
bf16 that is about 420 keys on the H100), ``attention_flash`` beyond.  Both
compute one function, so no result depends on the rule.  The kernels take
any S >= 1; nothing is padded.

:func:`attention_reference` is the plain version: what the CPU tests run,
what the backward differentiates, and what the encoder kernel's plain twin
(``models/vit.py::_block`` with ``use_kernel=False``) uses.  On a CUDA
tensor :func:`flash_attention` launches a kernel or raises; there is no
way from the kernel to the plain version.

``SINGLE_LAUNCHES`` and ``FLASH_LAUNCHES`` count kernel launches, so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

__all__ = ["attention_reference", "flash_attention", "kernel_route",
           "multihead_attention", "SINGLE_LAUNCHES", "FLASH_LAUNCHES"]

# Launches of each kernel since import (or since a caller reset them to 0).
SINGLE_LAUNCHES = 0
FLASH_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seq_len: Optional[int] = None) -> torch.Tensor:
    """Softmax attention in float32, cast back to ``q.dtype``.

    q, k, v: (..., S, D).  With ``seq_len``, keys beyond it are masked out.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if seq_len is not None and seq_len < q.shape[-2]:
        mask = torch.arange(s.shape[-1], device=s.device) < seq_len
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...qk,...kd->...qd", p, v.float())
    return out.to(q.dtype)


def _library():
    lib = cuda_build.load("attention")
    if lib.attention_single_forward.argtypes is None:
        for fn in (lib.attention_single_forward, lib.attention_flash_forward):
            fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
        lib.attention_single_smem.argtypes = [ctypes.c_int] * 3
        lib.attention_single_smem.restype = ctypes.c_longlong
        lib.attention_flash_smem.argtypes = [ctypes.c_int] * 2
        lib.attention_flash_smem.restype = ctypes.c_longlong
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if not q.is_cuda:
        raise ValueError("the attention kernels need CUDA tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 3 or q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"q must be (batch*heads, S, dh) with S >= 1, got "
                         f"shape {tuple(q.shape)}")
    dh = q.shape[2]
    if dh % 8 or dh > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} must be a multiple of 8 up to "
                         f"{_MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def kernel_route(q: torch.Tensor) -> str:
    """Which kernel :func:`flash_attention` launches for this CUDA tensor:
    ``"single"`` while the whole sequence fits one block's opt-in shared
    memory, ``"flash"`` beyond."""
    lib = _library()
    _, s, dh = q.shape
    optin = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    return ("single" if lib.attention_single_smem(s, dh, q.element_size())
            <= optin else "flash")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global SINGLE_LAUNCHES, FLASH_LAUNCHES
    _check(q, k, v)
    lib = _library()
    bh, s, dh = q.shape
    with torch.cuda.device(q.device):
        route = kernel_route(q)
        fn = (lib.attention_single_forward if route == "single"
              else lib.attention_flash_forward)
        out = torch.empty_like(q)
        err = fn(_DTYPE_CODES[q.dtype], bh, s, dh, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_{route}_forward failed: CUDA error {err}")
    if route == "single":
        SINGLE_LAUNCHES += 1
    else:
        FLASH_LAUNCHES += 1
    return out


class _Flash(torch.autograd.Function):
    """Forward: a CUDA kernel.  Backward: autograd of the plain version, as
    the JAX ``custom_vjp`` (neither TPU kernel has a backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            inputs = [t for t in qkv if t.requires_grad]
            grads = iter(torch.autograd.grad(attention_reference(*qkv),
                                             inputs, grad))
        return tuple(next(grads) if t.requires_grad else None for t in qkv)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention over (batch*heads, S, dh) per-head inputs: a CUDA kernel
    for CUDA tensors (chosen by length, see the module docstring; raises if
    it cannot launch), the plain version for CPU tensors."""
    if not q.is_cuda:
        return attention_reference(q, k, v)
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous())


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Split (B, S, D_model) into heads, attend, merge.

    ``use_kernel`` is the counterpart of the JAX package's ``use_pallas``:
    ``None`` takes the CUDA kernels for a CUDA tensor and the plain version
    for a CPU tensor; ``False`` always takes the plain version; ``True`` on
    a CPU tensor raises (the kernels have no CPU mode).
    """
    b, s, dm = q.shape
    dh = dm // num_heads
    if use_kernel is None:
        use_kernel = q.is_cuda
    elif use_kernel and not q.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors: the attention "
                         "kernels have no CPU mode")

    def split(x):
        return x.reshape(b, s, num_heads, dh).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    if use_kernel:
        out = flash_attention(*(x.reshape(b * num_heads, s, dh)
                                for x in (qh, kh, vh)))
        out = out.reshape(b, num_heads, s, dh)
    else:
        out = attention_reference(qh, kh, vh)
    return out.transpose(1, 2).reshape(b, s, dm)
