"""Multi-head softmax attention, plain PyTorch.

Port of the plain path of ``gstreamer_vit_tracker_tpu/ops/attention.py``.
The JAX package also has two Pallas attention kernels there
(``_single_block_kernel`` and ``_flash_kernel``); its dispatch never
selects them at the tracker's sequence length (320 tokens pad to 384,
below its 512-token crossover), so they are not on this slice's path and
are ported later.  The encoder's own attention runs inside the CUDA
encoder kernel (ops/vit_block.py).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_reference", "multihead_attention"]


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


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Split (B, S, D_model) into heads, attend, merge."""
    b, s, dm = q.shape
    dh = dm // num_heads

    def split(x):
        return x.reshape(b, s, num_heads, dh).transpose(1, 2)

    out = attention_reference(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(b, s, dm)
