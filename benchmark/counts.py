"""The benchmark's frozen arithmetic: the work and the bytes of the model's
shapes, and the card's published peaks, behind every MFU and roofline.

Counts are of the model, not of what an implementation launches: a matrix
product is 2 * M * N * K operations; the crop's resample products, zero
padding, block-diagonal zeros and elementwise work (LayerNorm, GELU,
softmax, colour conversion, the decode) are not counted.  ``fields`` is a
configuration file's field mapping.
"""

from __future__ import annotations

from typing import Mapping

# NVIDIA H100 SXM, the data sheet's dense rates at a 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16_BYTES = 2


def tokens(fields: Mapping) -> tuple:
    """(template tokens, search tokens) of one track."""
    p = int(fields["patch_size"])
    return ((int(fields["template_size"]) // p) ** 2,
            (int(fields["search_size"]) // p) ** 2)


def hidden(fields: Mapping) -> int:
    return int(int(fields["embed_dim"]) * float(fields["mlp_ratio"]))


def embed_flops(fields: Mapping) -> float:
    """The search crop's patch embed (the template's is made once, at
    init)."""
    p, d = int(fields["patch_size"]), int(fields["embed_dim"])
    return 2.0 * tokens(fields)[1] * (p * p * 3) * d


def block_flops(fields: Mapping) -> float:
    """One encoder block over the joint sequence: qkv, scores, values,
    proj, the two MLP products."""
    n = sum(tokens(fields))
    d = int(fields["embed_dim"])
    return (2.0 * n * d * 3 * d + 4.0 * n * n * d + 2.0 * n * d * d
            + 4.0 * n * d * hidden(fields))


def head_flops(fields: Mapping) -> float:
    """The three conv towers over the (fs, fs, D) search map: 3x3 convs
    D -> D/2 -> D/4 -> D/8, then a 1x1 conv to 1 + 2 + 2 outputs."""
    d = int(fields["embed_dim"])
    cells = tokens(fields)[1]
    w = [d, d // 2, d // 4, d // 8]
    f = sum(3 * 2.0 * cells * 9 * w[i] * w[i + 1] for i in range(3))
    return f + 2.0 * cells * w[3] * 5


def frame_flops(fields: Mapping) -> float:
    """The model operations of one tracked frame."""
    return (embed_flops(fields) + int(fields["depth"]) * block_flops(fields)
            + head_flops(fields))


def encoder_weight_bytes(fields: Mapping) -> float:
    """Every block's weights once, in bf16: qkv, proj, the MLP, biases,
    both LayerNorms."""
    d, h = int(fields["embed_dim"]), hidden(fields)
    per = d * 3 * d + 3 * d + d * d + d + d * h + h + h * d + d + 4 * d
    return float(int(fields["depth"]) * per * BF16_BYTES)


def encoder_bound_s(fields: Mapping, batch: int) -> float:
    """The least time of all blocks over ``batch`` joint sequences: the
    larger of their operations at the bf16 peak and their bytes (the
    tokens in and out once, each weight once) at the HBM rate."""
    n, d = sum(tokens(fields)), int(fields["embed_dim"])
    flops = batch * int(fields["depth"]) * block_flops(fields)
    byts = 2.0 * batch * n * d * BF16_BYTES + encoder_weight_bytes(fields)
    return max(flops / PEAK_BF16_FLOPS, byts / PEAK_HBM_BYTES_S)


def attention_bound_s(fields: Mapping, batch: int) -> float:
    """The least time of one block's attention over ``batch`` sequences,
    every head: scores and values 4 * S^2 * dh a head, q, k, v read and o
    written once in bf16."""
    n = sum(tokens(fields))
    heads = int(fields["num_heads"])
    dh = int(fields["embed_dim"]) // heads
    bh = batch * heads
    flops = 4.0 * bh * n * n * dh
    byts = 4.0 * bh * n * dh * BF16_BYTES
    return max(flops / PEAK_BF16_FLOPS, byts / PEAK_HBM_BYTES_S)
