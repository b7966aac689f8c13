"""VitTrack model: joint template/search ViT encoder + prediction heads.

Port of ``gstreamer_vit_tracker_tpu/models/vittrack.py``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..device import resolve_device
from . import heads as heads_mod
from . import vit, weights

Params = Dict[str, Any]


class TrackMaps(NamedTuple):
    score: torch.Tensor    # (B, fs, fs)
    offset: torch.Tensor   # (B, fs, fs, 2)
    size: torch.Tensor     # (B, fs, fs, 2)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """A seeded parameter tree of ``cfg`` (``weights.param_shapes``'s
    structure): the backbone, and the conv head where ``cfg`` has one.
    ``gen`` is a CPU generator: the tree is drawn on the CPU and then moved
    to ``device``, so one seed gives one tree on every device."""
    dev = resolve_device(device)
    params: Params = {"backbone": vit.init_vit_params(gen, cfg)}
    if cfg.head_mode == "conv":
        params["head"] = heads_mod.init_head_params(gen, cfg)
    return weights.tree_to(params, dev)


def embed_template(params: Params, z_img: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Normalised template crop (B, Hz, Wz, 3) -> cached template tokens,
    computed at ``init`` and carried across every ``update``."""
    return vit.embed_template(params["backbone"], z_img, cfg)


def forward(params: Params, z_tok: torch.Tensor, x_img: torch.Tensor,
            cfg: ModelConfig, use_kernel: Optional[bool] = None,
            fused: Optional[bool] = None) -> TrackMaps:
    """One tracking forward pass.  z_tok: (B, Nz, D) cached template
    tokens; x_img: (B, Hx, Wx, 3) normalised search crop.  ``use_kernel``
    and ``fused`` are those of ``vit.encode``."""
    x_tok = vit.embed_search(params["backbone"], x_img, cfg)
    return forward_tokens(params, z_tok, x_tok, cfg, use_kernel=use_kernel,
                          fused=fused)


def embed_search_patches(params: Params, patches: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """Patch-major search pixels (..., p, N, p*3) -> search tokens
    (``vit.embed_search_patches``); feeds :func:`forward_tokens`."""
    return vit.embed_search_patches(params["backbone"], patches, cfg)


def forward_tokens(params: Params, z_tok: torch.Tensor, x_tok: torch.Tensor,
                   cfg: ModelConfig, use_kernel: Optional[bool] = None,
                   fused: Optional[bool] = None) -> TrackMaps:
    """Forward from already-embedded search tokens (B, Nx, D).  The conv
    head is served grouped when :func:`with_grouped_head` attached one,
    except for the batched callers (``fused=False``), which run the three
    towers: at real batch the grouped head's block-diagonal waste grows
    with the batch, as in JAX.  The corr head correlates the search map
    with ``z_tok``."""
    x_feat = vit.encode(params["backbone"], z_tok.to(x_tok.dtype), x_tok, cfg,
                        use_kernel=use_kernel, fused=fused)
    if cfg.head_mode == "conv":
        g = params.get("head_grouped")
        if g is not None and fused is not False:
            score, offset, size = heads_mod.conv_head_grouped(g, x_feat, cfg)
        else:
            score, offset, size = heads_mod.conv_head(params["head"], x_feat,
                                                      cfg)
    else:
        score, offset, size = heads_mod.corr_head(z_tok, x_feat, cfg)
    return TrackMaps(score=score, offset=offset, size=size)


def with_grouped_head(params: Params) -> Params:
    """Serving-time param prep: attach the derived 4-conv grouped head
    (models/heads.py::group_head_params).  Call once after loading."""
    if "head" not in params or "head_grouped" in params:
        return params
    out = dict(params)
    out["head_grouped"] = heads_mod.group_head_params(params["head"])
    return out


def count_params(params: Params) -> int:
    """Number of parameter values in the tree."""
    return sum(t.numel() for t in weights.flatten(params).values())
