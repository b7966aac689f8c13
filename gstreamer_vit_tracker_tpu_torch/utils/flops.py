"""Static per-frame FLOP accounting for the tracking update (MFU), and the
peaks of the card it is measured against.

Port of ``gstreamer_vit_tracker_tpu/utils/flops.py``: the same counts (pure
arithmetic on the config, equal to the JAX package's,
``tests/test_torch_flops.py``).  Counts the matmul/conv FLOPs (2*M*N*K per
GEMM, the "model FLOPs" convention) of one tracked frame as the update
performs them:

* preprocess: the resample products of ``ops/preprocess.py`` (row matrix
  @ plane @ column matrix per plane, chroma at half resolution, banded);
* patch embed: search tokens only (template tokens are made at init and
  carried in the ``TrackState``);
* encoder blocks: qkv / scores / values / proj / mlp over the joint
  template + search token sequence;
* heads: the 4-conv grouped serving head or the 3-tower head; the grouped
  head's block-diagonal layers execute dense, so they are counted dense.

Elementwise work (LayerNorm, GELU, softmax, colour conversion, decode) is
excluded.

MFU denominator: the NVIDIA H100's dense bf16 tensor-core peak (SXM part,
NVIDIA's data sheet, at the full 700 W power limit).  The same module holds
the card's float32 peak and HBM rate, the figures ``chip_smoke.py`` takes
its bounds from.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, dense rates without sparsity, at a 700 W power limit.
H100_BF16_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12      # TF32 on the tensor cores
H100_HBM_BYTES_S = 3.35e12    # HBM3 bandwidth


def _banded(frame_h: int, frame_w: int, band) -> tuple:
    if band is None:
        return frame_h, frame_w
    return min(band, frame_h), min(band, frame_w)


def preprocess_flops(cfg, frame_h: int, frame_w: int,
                     frame_format: str = "nv12") -> float:
    """FLOPs of one crop/resize/convert (the search crop of an update
    step): two resample products per plane; NV12/YUY2 chroma planes run
    at half resolution."""
    o = cfg.search_size
    bh, bw = _banded(frame_h, frame_w, cfg.preprocess_band)
    if frame_format == "nv12":
        # Y: (o,bh)@(bh,bw) + (o,bw)@(bw,o); U,V at (bh/2, bw/2).
        return 3.0 * o * bh * bw + 4.0 * o * o * bw
    if frame_format == "yuy2":
        # Y full res; U,V at (bh, bw/2) with full-res row matrix.
        return 4.0 * o * bh * bw + 4.0 * o * o * bw
    if frame_format == "rgb":
        # einsum over 3 channels both passes.
        return 6.0 * o * bh * bw + 6.0 * o * o * bw
    raise ValueError(f"unknown frame format {frame_format!r}")


def encoder_flops(cfg) -> float:
    """Patch embed (search tokens) + all transformer blocks over the
    joint template+search sequence."""
    d = cfg.embed_dim
    p = cfg.patch_size
    tz = (cfg.template_size // p) ** 2
    tx = (cfg.search_size // p) ** 2
    n = tz + tx
    embed = 2.0 * tx * (p * p * 3) * d
    per_block = (2.0 * n * d * 3 * d        # qkv
                 + 4.0 * n * n * d          # scores + values
                 + 2.0 * n * d * d          # proj
                 + 4.0 * cfg.mlp_ratio * n * d * d)   # mlp1 + mlp2
    return embed + cfg.depth * per_block


def head_flops(cfg, grouped: bool = True) -> float:
    """Conv head over the (fs, fs, D) search feature map.

    ``grouped=True`` counts the 4-conv serving head (block-diagonal
    layers dense, ``models/heads.py::conv_head_grouped``); ``False`` the
    3-tower head (what the batched paths and training run)."""
    d = cfg.embed_dim
    tx = (cfg.search_size // cfg.patch_size) ** 2
    w = [d, d // 2, d // 4, d // 8]          # per-tower channel ladder
    if grouped:
        f = 2.0 * tx * 9 * w[0] * 3 * w[1]           # concat layer
        f += 2.0 * tx * 9 * (3 * w[1]) * (3 * w[2])  # block-diag, dense
        f += 2.0 * tx * 9 * (3 * w[2]) * (3 * w[3])
        f += 2.0 * tx * (3 * w[3]) * 5               # 1x1 -> score1+off2+sz2
        return f
    f = 3 * 2.0 * tx * 9 * w[0] * w[1]
    f += 3 * 2.0 * tx * 9 * w[1] * w[2]
    f += 3 * 2.0 * tx * 9 * w[2] * w[3]
    f += 2.0 * tx * w[3] * 5
    return f


def update_gflops(cfg, frame_h: int, frame_w: int,
                  frame_format: str = "nv12",
                  grouped_head: bool = True) -> float:
    """Model GFLOPs of ONE tracked frame (preprocess + embed + encoder
    + head), as executed."""
    total = (preprocess_flops(cfg, frame_h, frame_w, frame_format)
             + encoder_flops(cfg)
             + head_flops(cfg, grouped=grouped_head))
    return total / 1e9


def mfu_fields(fps: float, gflop_per_frame: float,
               prefix: str = "") -> Dict[str, float]:
    """GFLOP a frame, achieved TFLOP/s at ``fps``, and their share of the
    H100's dense bf16 peak."""
    tflops = fps * gflop_per_frame / 1e3
    return {
        prefix + "gflop_per_frame": round(gflop_per_frame, 3),
        prefix + "achieved_tflops": round(tflops, 2),
        prefix + "mfu_vs_h100_bf16": round(tflops * 1e12 / H100_BF16_FLOPS,
                                           4),
    }
