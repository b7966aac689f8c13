"""ViT encoder backbone (params as nested dicts of tensors).

Port of ``gstreamer_vit_tracker_tpu/models/vit.py``: template and search
crops are patch-embedded (separate learned position embeddings),
concatenated into one token sequence, and encoded jointly by a pre-LN ViT.

``encode`` has two routes, as in JAX.  Fused (the default at batch 1): all
blocks through ``ops/vit_block.py::encoder``, the CUDA encoder kernel on a
CUDA tensor and its plain twin (a chain of :func:`_block`) on a CPU
tensor.  Per block (``fused=False``, what the batched callers ask for): LN
and the four products in PyTorch, attention through
``ops/attention.py::multihead_attention`` (the CUDA attention kernels on a
CUDA tensor).  The final LN and the split back to search tokens stay
outside both.

Under a mesh whose model axis is wider than 1 (``parallel/mesh.py::
use_mesh``) and on block shards (``parallel/sharding.py::shard_params``),
every block takes :func:`_tp_block`, the per-block route with the
Megatron collectives.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops import vit_block
from ..ops.attention import multihead_attention

Params = Dict[str, Any]

LN_EPS = 1e-6   # torch's default is 1e-5


def _trunc_normal(gen: torch.Generator, shape, std: float = 0.02
                  ) -> torch.Tensor:
    """float32 draws of ``std`` x a standard normal truncated to [-2, 2],
    JAX's ``std * truncated_normal(-2, 2)``: ``trunc_normal_``'s bounds are
    in the distribution's own units, so they are +-2 std, not +-2."""
    return torch.nn.init.trunc_normal_(
        torch.empty(shape, dtype=torch.float32), std=std, a=-2.0 * std,
        b=2.0 * std, generator=gen)


def init_vit_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """A seeded backbone tree of ``cfg`` on the CPU (the structure of
    ``models/weights.py::param_shapes``): linear kernels and position
    embeddings from :func:`_trunc_normal` at std 0.02, biases 0, LayerNorm
    scales 1.  The draws cannot match JAX's PRNG bits, only its
    distribution."""
    d = cfg.embed_dim
    p = cfg.patch_size
    hidden = int(d * cfg.mlp_ratio)

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    def linear(n_in, n_out):
        return {"kernel": _trunc_normal(gen, (n_in, n_out)),
                "bias": torch.zeros(n_out)}

    params: Params = {
        "patch_embed": linear(p * p * 3, d),
        "pos_embed_z": _trunc_normal(gen, (cfg.num_template_tokens, d)),
        "pos_embed_x": _trunc_normal(gen, (cfg.num_search_tokens, d)),
        "norm": ln(),
        "blocks": [],
    }
    for _ in range(cfg.depth):
        params["blocks"].append({
            "ln1": ln(), "ln2": ln(),
            "qkv": linear(d, 3 * d), "proj": linear(d, d),
            "mlp1": linear(d, hidden), "mlp2": linear(hidden, d)})
    return params


def cast_params(p: Any, dtype: torch.dtype) -> Any:
    """Cast floating tensors of a param tree to the compute dtype at use
    (masters stay float32).  A tensor already in ``dtype`` is returned as
    is."""
    if isinstance(p, dict):
        return {k: cast_params(v, dtype) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [cast_params(v, dtype) for v in p]
    return p.to(dtype) if p.is_floating_point() else p


def layer_norm(x: torch.Tensor, p: Params, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm in float32 (scale and bias promoted to float32), cast back
    to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def patch_embed(img: torch.Tensor, p: Params, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, D) via reshape + matmul (stride == kernel
    conv).  Each patch flattens in (p, q, c) order, the kernel's row
    order."""
    b, h, w, c = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)
    return x @ p["kernel"] + p["bias"]


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``x @ kernel + bias`` accumulated and biased in float32, rounded to
    ``x.dtype`` once (the encoder kernel's rounding point)."""
    return (torch.matmul(x.float(), p["kernel"].float())
            + p["bias"].float()).to(x.dtype)


def _linear_native(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``x @ kernel + bias`` as one ``addmm`` in ``x.dtype``: the library's
    product (float32 accumulation, one rounding), as the JAX package leaves
    these products to XLA."""
    k = p["kernel"]
    return torch.addmm(p["bias"], x.reshape(-1, k.shape[0]), k).reshape(
        *x.shape[:-1], k.shape[1])


def _block(x: torch.Tensor, p: Params, num_heads: int,
           use_kernel: Optional[bool] = False,
           native: bool = False, fused: bool = False) -> torch.Tensor:
    """One pre-LN transformer block.

    ``fused=True`` hands the whole block to ``ops/vit_block.py::block``: the
    CUDA block kernel on a CUDA tensor, this function's plain body on a CPU
    tensor.

    With the defaults this is the plain twin of one step of the CUDA
    encoder kernel and of the TPU's ``ops/vit_block.py::_block_math``, and
    stays plain PyTorch on a CUDA tensor.  In float32 it computes what
    JAX's ``vit._block`` computes.  In bf16 it rounds where the fused
    kernels round: each product is accumulated and biased in float32 and
    rounded once, attention runs in float32, and the tanh GELU is taken in
    float32 of the rounded mlp1 output.  JAX's ``vit._block`` rounds the
    product and the bias sum separately.

    The per-block route of :func:`encode` is this same body with
    ``use_kernel`` passed on to ``multihead_attention`` (``None``: the CUDA
    attention kernels on a CUDA tensor) and ``native=True``: the four
    products as ``addmm`` in the compute dtype instead of widened to
    float32.
    """
    if fused:
        return vit_block.block(x, p, num_heads)
    dt = x.dtype
    linear = _linear_native if native else _linear
    h = layer_norm(x, p["ln1"])
    qkv = linear(h, p["qkv"])
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    attn = multihead_attention(q, k, v, num_heads, use_kernel=use_kernel)
    x = x + linear(attn, p["proj"])
    h = layer_norm(x, p["ln2"])
    g = F.gelu(linear(h, p["mlp1"]).float(), approximate="tanh").to(dt)
    return x + linear(g, p["mlp2"])


def _row_parallel(x: torch.Tensor, p: Params, group) -> torch.Tensor:
    """A row-parallel product: this rank's partial ``x @ kernel`` in
    float32, summed over the model group, the bias added once and rounded
    to ``x.dtype`` once, as one device's ``addmm`` rounds."""
    from ..parallel.tensor import reduce_from

    part = torch.matmul(x.float(), p["kernel"].float())
    return (reduce_from(part, group) + p["bias"].float()).to(x.dtype)


def _tp_block(x: torch.Tensor, p: Params, num_heads: int, group,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """:func:`_block`'s per-block route on this rank's shards of ``p``:
    qkv and mlp1 column-parallel, proj and mlp2 row-parallel with an
    all-reduce after each.

    qkv's column split is not head-aligned (the product lies ``[q | k |
    v]``), so its shards are gathered and every model rank attends over
    all heads, as the single-device route does (the attention kernel
    launches on each); proj then reads this rank's rows of the result.
    The row-parallel sums run in another order than one device's, in
    float32 and rounded once (:func:`_row_parallel`)."""
    from ..parallel import tensor as ptensor

    dt = x.dtype
    h = ptensor.copy_to(layer_norm(x, p["ln1"]), group)
    qkv = ptensor.gather_from(_linear_native(h, p["qkv"]), group)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    attn = multihead_attention(q, k, v, num_heads, use_kernel=use_kernel)
    x = x + _row_parallel(ptensor.scatter_to(attn, group), p["proj"], group)
    h = ptensor.copy_to(layer_norm(x, p["ln2"]), group)
    g = F.gelu(_linear_native(h, p["mlp1"]).float(), approximate="tanh").to(dt)
    return x + _row_parallel(g, p["mlp2"], group)


def _tp_group(blocks, dim: int):
    """The model group when a mesh with a model axis wider than 1 is in
    context and ``blocks`` are its shards (qkv's columns split), else
    None."""
    from ..parallel.mesh import MODEL_AXIS, axis_size, current_mesh

    mesh = current_mesh()
    if mesh is None or not blocks or axis_size(mesh, MODEL_AXIS) == 1:
        return None
    if blocks[0]["qkv"]["kernel"].shape[1] == 3 * dim:
        return None             # whole params: every rank computes in full
    return mesh.get_group(MODEL_AXIS)


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def embed_template(params: Params, z_img: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Normalised template crop (B, Hz, Wz, 3) -> (B, Nz, D) tokens, the
    part of the forward pass cached across frames in ``TrackState``."""
    dt = _cdtype(cfg)
    pe = cast_params(params["patch_embed"], dt)
    tok = patch_embed(z_img.to(dt), pe, cfg.patch_size)
    return tok + params["pos_embed_z"].to(tok.dtype)


def embed_search(params: Params, x_img: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    dt = _cdtype(cfg)
    pe = cast_params(params["patch_embed"], dt)
    tok = patch_embed(x_img.to(dt), pe, cfg.patch_size)
    return tok + params["pos_embed_x"].to(tok.dtype)


def embed_search_patches(params: Params, patches: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """Patch-embed pre-patchified search pixels: (..., p, N, p*3) ->
    (..., N, D).  Companion to ``ops/preprocess.py``'s ``patch_major=p``:
    the patchify of :func:`patch_embed` collapses to one swap of the two
    leading axes with the (q, c) minor dimension kept contiguous, and the
    contraction is the same (N, p*p*3) @ (p*p*3, D) product, so the tokens
    are :func:`embed_search`'s."""
    dt = _cdtype(cfg)
    p, n, k = patches.shape[-3:]
    pe = params["patch_embed"]
    x = patches.to(dt).transpose(-3, -2).reshape(*patches.shape[:-3], n, p * k)
    tok = x @ pe["kernel"].to(dt) + pe["bias"].to(dt)
    return tok + params["pos_embed_x"].to(tok.dtype)


def encode(params: Params, z_tok: torch.Tensor, x_tok: torch.Tensor,
           cfg: ModelConfig, use_kernel: Optional[bool] = None,
           fused: Optional[bool] = None) -> torch.Tensor:
    """Joint encoding of [template; search] tokens.

    Returns the encoded search tokens (B, Nx, D) after the final LN, the
    input to the heads.

    ``fused=None`` takes the whole-encoder kernel for an unbatched (B = 1)
    encode, as JAX does on its accelerator; ``fused=True`` takes it at any
    batch.  ``fused=False`` is the per-block route, which the batched
    callers (tracker/multi.py) pass: its attention goes through
    ``multihead_attention(use_kernel)``, the counterpart of JAX's
    ``use_pallas``.  Under a tensor-parallel mesh on shards every block
    takes :func:`_tp_block` (module docstring), whatever ``fused`` says.
    """
    dt = _cdtype(cfg)
    if fused is None:
        fused = x_tok.shape[0] == 1
    x = torch.cat([z_tok.to(dt), x_tok.to(dt)], dim=1)
    group = _tp_group(params["blocks"], cfg.embed_dim)
    if group is not None:
        for bp in params["blocks"]:
            x = _tp_block(x, cast_params(bp, dt), cfg.num_heads, group,
                          use_kernel=use_kernel)
    elif fused and params["blocks"]:     # depth 0 has no blocks to fuse
        # The masters go in as they are: the encoder casts and stacks them
        # once per parameter set (on every call under a gradient).
        x = vit_block.encoder(x, params["blocks"], cfg.num_heads)
    else:
        for bp in params["blocks"]:
            x = _block(x, cast_params(bp, dt), cfg.num_heads,
                       use_kernel=use_kernel, native=True)
    x = layer_norm(x, params["norm"])
    return x[:, z_tok.shape[1]:, :]
