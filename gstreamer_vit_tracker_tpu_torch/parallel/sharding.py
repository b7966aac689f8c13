"""Sharding rules: how params, optimizer state and batches lay out on the
mesh.

Port of ``gstreamer_vit_tracker_tpu/parallel/sharding.py``.  The rules are
JAX's, as partition specs (a tuple: the mesh axis each dimension is split
over, or ``None``):

* qkv kernel  (D, 3D)      -> (None, 'model')   column-parallel
* qkv bias    (3D,)        -> ('model',)
* proj kernel (D, D)       -> ('model', None)   row-parallel
* mlp1 kernel (D, H)       -> (None, 'model')   column-parallel
* mlp1 bias   (H,)         -> ('model',)
* mlp2 kernel (H, D)       -> ('model', None)   row-parallel
* everything else          -> replicated

Where JAX places a global array on the mesh, a rank here holds its local
part as a plain tensor: :func:`shard_params` gives this rank's shard of
every leaf, :func:`shard_batch` its slice of the leading axis over
``data``, and :func:`gather_params` puts the full tree back together (for
a checkpoint and for tests).  The tensor-parallel forward on shards is
``models/vit.py::_tp_block``; it gathers qkv's columns before attention,
so the heads need not divide the model axis.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from .mesh import DATA_AXIS, MODEL_AXIS, axis_size
from .tensor import all_gather_cat, all_reduce_sum

__all__ = ["param_pspec", "tree_map_with_path", "shard_params", "replicate",
           "shard_batch", "gather_params", "data_mean", "sq_norm"]


def tree_map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts, lists, tuples and named
    tuples; the path holds the dict keys and sequence indices."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (i,))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_pspec(path, leaf) -> Tuple:
    name = _path_str(path)
    if "qkv/kernel" in name:
        return (None, MODEL_AXIS)
    if "qkv/bias" in name:
        return (MODEL_AXIS,)
    if "proj/kernel" in name:
        return (MODEL_AXIS, None)
    if "mlp1/kernel" in name:
        return (None, MODEL_AXIS)
    if "mlp1/bias" in name:
        return (MODEL_AXIS,)
    if "mlp2/kernel" in name:
        return (MODEL_AXIS, None)
    return ()  # replicated


def _split_dim(path, leaf):
    """The dimension of ``leaf`` split over ``model``, or None."""
    spec = param_pspec(path, leaf)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_params(params: Any, mesh) -> Any:
    """This rank's shard of every leaf per :func:`param_pspec` (new
    storage; replicated leaves are copies).  A split dimension that the
    model axis does not divide raises."""
    tp, r = axis_size(mesh, MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS)

    def put(path, x):
        d = _split_dim(path, x)
        if d is None:
            return x.detach().clone()
        if x.shape[d] % tp:
            raise ValueError(f"{_path_str(path)}: dimension {d} of "
                             f"{tuple(x.shape)} does not split over "
                             f"{tp} model ranks")
        return x.detach().chunk(tp, dim=d)[r].clone()

    return tree_map_with_path(put, params)


def replicate(tree: Any, mesh) -> Any:
    """The whole of every leaf on this rank (a copy)."""
    return tree_map_with_path(lambda _p, x: x.detach().clone(), tree)


def shard_batch(tree: Any, mesh) -> Any:
    """This rank's slice of the leading axis of every leaf (tensor or numpy
    array) over the ``data`` axis.  A leading axis that the data axis does
    not divide raises, as ``jax.device_put`` does."""
    dp, r = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)

    def put(path, x):
        n = x.shape[0]
        if n % dp:
            raise ValueError(f"leading axis {n} does not split over {dp} "
                             "data ranks")
        return x[r * (n // dp):(r + 1) * (n // dp)]

    return tree_map_with_path(put, tree)


def gather_params(params: Any, mesh) -> Any:
    """The full tree from every model rank's shard (a collective over the
    ``model`` group: every rank calls it)."""
    group = mesh.get_group(MODEL_AXIS)

    def get(path, x):
        d = _split_dim(path, x)
        return x.detach().clone() if d is None else all_gather_cat(
            x.detach(), d, group)

    return tree_map_with_path(get, params)


def data_mean(tensors: list, mesh) -> list:
    """The mean over the ``data`` group of each tensor in ``tensors``
    (float32 tensors of any shapes), as one all-reduce of their
    concatenation."""
    dp = axis_size(mesh, DATA_AXIS)
    if dp == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce_sum(flat, mesh.get_group(DATA_AXIS)) / dp
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def sq_norm(grads: Any, mesh) -> torch.Tensor:
    """The squared global norm of a gradient tree of shards: the split
    leaves' squares summed over the ``model`` group, the replicated
    leaves' (equal on every model rank) counted once."""
    split, whole = [], []
    tree_map_with_path(
        lambda p, g: (whole if _split_dim(p, g) is None else split).append(
            torch.sum(g * g)), grads)
    zero = torch.zeros((), dtype=torch.float32,
                       device=(split or whole)[0].device)
    total = sum(whole, zero)
    if split:
        total = total + all_reduce_sum(sum(split, zero),
                                       mesh.get_group(MODEL_AXIS))
    return total
