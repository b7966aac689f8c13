"""Weights in: the flat npz checkpoints the JAX package writes, as torch
tensors.

``gstreamer_vit_tracker_tpu/models/weights.py::_flatten`` stores the
parameter tree as flat keys joined by ``/`` (``backbone/blocks/3/qkv/kernel``,
``head/score/0/kernel``, ...).  :func:`params_from_flat` rebuilds the same
nested tree (dicts, lists for blocks and tower layers) with every shape
checked against the config, as the JAX ``load_npz`` checks against its
``like`` tree.  Layouts stay as stored: linear kernels (in, out), conv
kernels HWIO.

The other direction: :func:`save_npz` writes the port's parameters as such
a checkpoint; :func:`tree_to_numpy` turns them (or Adam moments, which
share their tree) into a nested tree of numpy arrays, and :func:`flatten`
into the flat ``/``-joined keys of the checkpoints.

A ``TrackState`` crosses the same way: :func:`state_from_numpy` and
:func:`state_to_numpy` carry its six leaves (with any leading batch
dimensions) between numpy arrays and the port's tensors.

:func:`save_tree` / :func:`load_tree` checkpoint an arbitrary tree (params,
a ``TrackState``, ``train/step.py``'s AdamW state): the port's counterpart
of the JAX package's Orbax pair.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..tracker.state import TrackState

Params = Dict[str, Any]

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")

# Shipped checkpoints of the presets in config.PRESETS.
CHECKPOINTS = {
    "small": "weights_small_synthetic.npz",
    "vittrack-t": "weights_vittrack_t_synthetic.npz",
}


def checkpoint_path(preset: str) -> str:
    return os.path.join(ASSETS, CHECKPOINTS[preset])


def default_checkpoint(preset: str) -> str:
    """The shipped checkpoint of ``preset`` if it has one and the file is
    there, else "" (corr-tiny runs on its seeded weights)."""
    if preset not in CHECKPOINTS:
        return ""
    path = checkpoint_path(preset)
    return path if os.path.exists(path) else ""


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree of ``cfg`` with a shape tuple at every leaf (the
    structure of the JAX ``vittrack.init_params``)."""
    d = cfg.embed_dim
    p = cfg.patch_size
    hidden = int(d * cfg.mlp_ratio)
    ln = {"scale": (d,), "bias": (d,)}
    backbone = {
        "patch_embed": {"kernel": (p * p * 3, d), "bias": (d,)},
        "pos_embed_z": (cfg.num_template_tokens, d),
        "pos_embed_x": (cfg.num_search_tokens, d),
        "norm": dict(ln),
        "blocks": [{
            "ln1": dict(ln), "ln2": dict(ln),
            "qkv": {"kernel": (d, 3 * d), "bias": (3 * d,)},
            "proj": {"kernel": (d, d), "bias": (d,)},
            "mlp1": {"kernel": (d, hidden), "bias": (hidden,)},
            "mlp2": {"kernel": (hidden, d), "bias": (d,)},
        } for _ in range(cfg.depth)],
    }
    tree: Params = {"backbone": backbone}
    if cfg.head_mode == "conv":
        chans = [d, d // 2, d // 4, d // 8]

        def tower(out_ch):
            layers = [{"kernel": (3, 3, chans[i], chans[i + 1]),
                       "bias": (chans[i + 1],)} for i in range(len(chans) - 1)]
            layers.append({"kernel": (1, 1, chans[-1], out_ch),
                           "bias": (out_ch,)})
            return layers

        tree["head"] = {"score": tower(1), "offset": tower(2),
                        "size": tower(2)}
    return tree


def params_from_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                     device="cuda", dtype=torch.float32) -> Params:
    """Rebuild the nested parameter tree of ``cfg`` from flat npz arrays.

    Raises ``KeyError`` on a missing key and ``ValueError`` on a shape
    mismatch.  Floating arrays become ``dtype`` tensors on ``device``
    (float32 masters by default; the model casts at use, as the JAX
    package does)."""
    dev = resolve_device(device)

    def rebuild(tree: Any, prefix: str) -> Any:
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        key = prefix[:-1]
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter {key!r}")
        arr = np.asarray(flat[key])
        if arr.shape != tuple(tree):
            raise ValueError(f"shape mismatch for {key!r}: "
                             f"checkpoint {arr.shape} vs model {tuple(tree)}")
        return torch.as_tensor(arr, dtype=dtype, device=dev)

    return rebuild(param_shapes(cfg), "")


def load_npz(path: str, cfg: ModelConfig, device="cuda",
             dtype=torch.float32) -> Params:
    """Load a checkpoint written by :func:`save_npz` or by the JAX
    package's ``save_npz``."""
    resolve_device(device)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_flat(flat, cfg, device=device, dtype=dtype)


def save_npz(path: str, params: Params, dtype=None) -> None:
    """Save the parameter tree as a flat npz of ``/``-joined keys, the
    layout the JAX package's ``load_npz`` and :func:`load_npz` read.
    ``dtype`` (e.g. ``np.float16``) downcasts the floating arrays for a
    compact file (the loaders cast back to the model's dtype)."""
    flat = flatten(tree_to_numpy(params))
    if dtype is not None:
        flat = {k: (v.astype(dtype) if np.issubdtype(v.dtype, np.floating)
                    else v) for k, v in flat.items()}
    np.savez(path, **flat)


def tree_to_numpy(tree: Any) -> Any:
    """Nested dicts and lists of tensors -> the same tree of numpy arrays
    (floats as float32), comparable leaf by leaf with a JAX ``TrainState``'s
    ``params`` and optax's ``mu`` / ``nu``."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    t = tree.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def tree_to(tree: Any, device, copy: bool = False) -> Any:
    """Nested dicts and lists of tensors moved to ``device``; with
    ``copy=True`` every leaf is a new tensor even where it already lies
    there (a host copy to recover from, or a fresh upload of it)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, copy) for v in tree]
    return tree.detach().to(device, copy=copy)


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested tree as flat ``a/b/0/c`` keys, the checkpoints' layout
    (the inverse of :func:`params_from_flat`'s rebuild)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def state_from_numpy(leaves, cfg: ModelConfig, device="cuda") -> TrackState:
    """A ``TrackState`` from six numpy leaves in field order (a JAX
    ``TrackState`` fetched to the host, unbatched or with leading (N,) or
    (S, M) dimensions).  Template tokens take the config's compute dtype
    (bf16 leaves widen to float32 on the way, which is exact), the others
    float32 and int32."""
    dev = resolve_device(device)
    tok = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    dtypes = TrackState(tok, tok, torch.float32, torch.float32, torch.int32,
                        torch.int32)
    return TrackState(*(
        torch.tensor(np.asarray(a, np.float32 if dt.is_floating_point
                                else np.int32), dtype=dt, device=dev)
        for a, dt in zip(leaves, dtypes)))


def state_to_numpy(state: TrackState) -> TrackState:
    """The state's leaves as numpy arrays (floats as float32: bf16 tokens
    widen exactly; ints as int32), for JAX's ``TrackState(*leaves)``."""
    return TrackState(*(
        (t.float() if t.is_floating_point() else t).cpu().numpy()
        for t in state))


def _plain(tree: Any) -> Any:
    """A tree with every container made a dict or list and every array leaf
    a CPU tensor: what ``torch.load(weights_only=True)`` reads back.  numpy
    bfloat16 (``ml_dtypes``, JAX's) travels as its bits."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, np.ndarray):
        if tree.dtype.name == "bfloat16":
            return torch.from_numpy(tree.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"save_tree cannot store a {type(tree).__name__} leaf")


def save_tree(path: str, tree: Any) -> None:
    """Checkpoint an arbitrary tree: nested dicts, lists, tuples and
    NamedTuples (``TrackState``, ``TrainState``) of tensors on any device
    and of any dtype (bf16, int, bool), numpy arrays, Python scalars and
    ``None``.  The port's counterpart of the JAX package's ``save_orbax``
    (``torch.save`` of plain containers; Orbax is not used)."""
    torch.save(_plain(tree), path)


def _restore(like: Any, got: Any, key: str) -> Any:
    if isinstance(like, dict):
        if not isinstance(got, dict) or set(got) != set(like):
            raise KeyError(f"checkpoint keys at {key or '/'!r} differ from "
                           f"the model's")
        return {k: _restore(v, got[k], f"{key}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(got, list) or len(got) != len(like):
            raise ValueError(f"checkpoint length at {key or '/'!r} differs "
                             f"from the model's")
        leaves = [_restore(v, g, f"{key}/{i}")
                  for i, (v, g) in enumerate(zip(like, got))]
        if isinstance(like, list):
            return leaves
        return type(like)(*leaves) if hasattr(like, "_fields") \
            else tuple(leaves)
    if isinstance(like, (torch.Tensor, np.ndarray)):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"checkpoint has no array at {key!r}")
        if tuple(got.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                             f"{tuple(got.shape)} vs model "
                             f"{tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            return got.to(device=like.device, dtype=like.dtype)
        if like.dtype.name == "bfloat16":
            return got.to(torch.bfloat16).view(torch.uint16).numpy().view(
                like.dtype)
        return got.numpy().astype(like.dtype, copy=False)
    if like is None:
        if got is not None:
            raise ValueError(f"checkpoint has a value at {key!r}, the model "
                             f"None")
        return None
    return type(like)(got)


def load_tree(path: str, like: Any) -> Any:
    """Read a :func:`save_tree` checkpoint into ``like``'s structure (the
    same container types), each leaf on ``like``'s device and in its dtype;
    a missing key or another shape raises, as :func:`load_npz` does.  The
    counterpart of the JAX package's ``load_orbax``."""
    return _restore(like, torch.load(path, map_location="cpu",
                                     weights_only=True), "")
