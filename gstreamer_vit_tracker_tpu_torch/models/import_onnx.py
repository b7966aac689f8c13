"""Import weights from an ONNX checkpoint of the VitTrack model family.

The reference's tracker is OpenCV Zoo's ``object_tracking_vittrack_2023sep``
(reference main.rs:25), distributed as an ONNX file (the .rknn blob the
reference loads is compiled from it).  A user migrating from the reference
arrives with that ONNX artifact; this module turns its weight tensors into
the port's parameter tree (tensors on an explicit device) so the same
trained model serves on the card.

Port of ``gstreamer_vit_tracker_tpu/models/import_onnx.py``: the protobuf
reader and writer, BN folding and name map are the same numpy code (the
bytes written and the trees read equal the JAX package's,
``tests/test_torch_onnx.py``); only the placement into the tree differs.

No ``onnx`` package is assumed (it is not installable in every
environment): ONNX files are protobuf messages, and the only thing needed
here is the flat list of graph initializers (name, dims, dtype, bytes), so
:func:`read_onnx_tensors` walks the protobuf wire format directly with a
~60-line parser.  :func:`write_onnx_tensors` emits the same subset — used
by the round-trip tests and handy for exporting our own checkpoints to
ONNX-consumers.

Weight layout conversion follows the PyTorch export conventions the OpenCV
Zoo models use:

* linear ``weight`` is (out, in)  -> ours (in, out): transpose;
* conv ``weight`` is (O, I, kh, kw) -> ours (kh, kw, I, O);
* the patch-embed conv (D, 3, P, P) -> our single-matmul kernel
  (P*P*3, D) with (row, col, channel) flattening — matching
  ``models/vit.py::patch_embed``'s reshape order;
* position embeddings (1, N, D) -> (N, D).

Tensor names in the artifact vary between exports; :func:`default_name_map`
covers the standard ``backbone.blocks.N.attn.qkv.weight`` style, and
``load_onnx(..., name_map=...)`` accepts explicit overrides.  Unmatched
names are reported exactly so a user can build the map for their file.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import weights

Params = Dict[str, Any]

__all__ = ["read_onnx_tensors", "write_onnx_tensors", "default_name_map",
           "map_tensors", "load_onnx"]


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader/writer (the ONNX subset we need)
# ---------------------------------------------------------------------------
# Field numbers from the public onnx.proto3 schema:
#   ModelProto.graph = 7 (GraphProto)
#   GraphProto.initializer = 5 (repeated TensorProto), .name = 2
#   TensorProto.dims = 1 (repeated int64), .data_type = 2, .float_data = 4,
#       .int64_data = 7, .name = 8, .raw_data = 9
_MODEL_GRAPH = 7
_GRAPH_INITIALIZER = 5
_T_DIMS, _T_DTYPE, _T_FLOATS, _T_INT64S, _T_NAME, _T_RAW = 1, 2, 4, 7, 8, 9

# ONNX TensorProto.DataType values -> numpy dtypes.
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
    10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64,
}
_DTYPE_TO_ONNX = {np.dtype(v): k for k, v in _ONNX_DTYPES.items()}


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _signed64(v: int) -> int:
    """Protobuf int64 varints are two's-complement in 64 bits: a negative
    value arrives as an unsigned >= 2^63 (10-byte varint)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one protobuf message.

    wire_type 0 -> int value; 2 -> bytes; 1/5 -> raw 8/4-byte value.
    """
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw: Optional[bytes] = None
    floats: List[float] = []
    int64s: List[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == _T_DIMS:
            if wire == 0:
                dims.append(val)
            else:                              # packed repeated
                j = 0
                while j < len(val):
                    d, j = _read_varint(val, j)
                    dims.append(d)
        elif field == _T_DTYPE:
            dtype_code = val
        elif field == _T_NAME:
            name = val.decode("utf-8")
        elif field == _T_RAW:
            raw = val
        elif field == _T_FLOATS:
            if wire == 2:                      # packed repeated float
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == _T_INT64S:
            if wire == 2:
                j = 0
                while j < len(val):
                    d, j = _read_varint(val, j)
                    int64s.append(_signed64(d))
            else:
                int64s.append(_signed64(val))
    if dtype_code not in _ONNX_DTYPES:
        raise ValueError(f"tensor {name!r}: unsupported ONNX dtype "
                         f"{dtype_code}")
    np_dtype = _ONNX_DTYPES[dtype_code]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np_dtype)
    elif int64s:
        arr = np.asarray(int64s, dtype=np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_tensors(path: str) -> Dict[str, np.ndarray]:
    """All graph initializers of an ONNX file as {name: array}."""
    with open(path, "rb") as f:
        buf = f.read()
    tensors: Dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(buf):
        if field == _MODEL_GRAPH and wire == 2:
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == _GRAPH_INITIALIZER and gwire == 2:
                    name, arr = _parse_tensor(gval)
                    tensors[name] = arr
    if not tensors:
        raise ValueError(f"{path}: no graph initializers found "
                         "(not an ONNX model file?)")
    return tensors


def _emit_tag(field: int, wire: int) -> bytes:
    return _emit_varint((field << 3) | wire)


def _emit_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _emit_len(field: int, payload: bytes) -> bytes:
    return _emit_tag(field, 2) + _emit_varint(len(payload)) + payload


def write_onnx_tensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: array} as a minimal valid ONNX ModelProto (initializers
    only — enough for weight interchange and for the importer round-trip
    tests; there are no graph nodes)."""
    inits = bytearray()
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _DTYPE_TO_ONNX:
            raise ValueError(f"{name!r}: dtype {arr.dtype} not exportable")
        t = bytearray()
        for d in arr.shape:
            t += _emit_tag(_T_DIMS, 0) + _emit_varint(d)
        t += _emit_tag(_T_DTYPE, 0) + _emit_varint(_DTYPE_TO_ONNX[arr.dtype])
        t += _emit_len(_T_NAME, name.encode("utf-8"))
        t += _emit_len(_T_RAW, arr.tobytes())
        inits += _emit_len(_GRAPH_INITIALIZER, bytes(t))
    graph = _emit_len(2, b"vittrack_weights") + bytes(inits)
    model = (_emit_tag(1, 0) + _emit_varint(8)        # ir_version = 8
             + _emit_len(_MODEL_GRAPH, graph))
    with open(path, "wb") as f:
        f.write(model)


# ---------------------------------------------------------------------------
# BatchNorm folding (real exports carry conv+BN head towers)
# ---------------------------------------------------------------------------

def fold_bn_groups(tensors: Dict[str, np.ndarray],
                   eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Fold ``Sequential(conv, bn, relu)`` parameter groups into plain
    conv weight+bias tensors.

    The OSTrack-family center head (the architecture behind OpenCV Zoo's
    VitTrack, SURVEY.md §2.9) builds its towers as conv_bn_relu blocks; a
    torch export therefore carries ``X.0.weight`` (conv, usually biasless)
    plus ``X.1.{weight,bias,running_mean,running_var,num_batches_tracked}``
    (BN).  This framework's head is BN-free (inference-only folding is
    exact), so imports fold:

        W' = W * gamma / sqrt(var + eps)        (per output channel)
        b' = beta + (b - mean) * gamma / sqrt(var + eps)

    Groups are detected by the ``X.1.running_mean`` + ``X.0.weight``
    signature; everything else passes through untouched.
    """
    out = dict(tensors)
    for name in list(tensors):
        if not name.endswith(".1.running_mean"):
            continue
        pre = name[:-len(".1.running_mean")]
        w_name = pre + ".0.weight"
        if w_name not in tensors or pre + ".1.running_var" not in tensors:
            continue
        w = np.asarray(tensors[w_name], np.float64)
        gamma = np.asarray(tensors.get(pre + ".1.weight",
                                       np.ones(w.shape[0])), np.float64)
        beta = np.asarray(tensors.get(pre + ".1.bias",
                                      np.zeros(w.shape[0])), np.float64)
        mean = np.asarray(tensors[name], np.float64)
        var = np.asarray(tensors[pre + ".1.running_var"], np.float64)
        b = np.asarray(tensors.get(w_name[:-len("weight")] + "bias",
                                   np.zeros(w.shape[0])), np.float64)
        scale = gamma / np.sqrt(var + eps)
        out[w_name] = (w * scale.reshape(-1, 1, 1, 1)).astype(np.float32)
        out[pre + ".0.bias"] = (beta + (b - mean) * scale).astype(np.float32)
        for suffix in (".1.weight", ".1.bias", ".1.running_mean",
                       ".1.running_var", ".1.num_batches_tracked"):
            out.pop(pre + suffix, None)
    return out


# ---------------------------------------------------------------------------
# Name mapping + layout conversion
# ---------------------------------------------------------------------------

def _t(arr: np.ndarray) -> np.ndarray:          # torch linear -> ours
    return np.ascontiguousarray(arr.T)


def _conv(arr: np.ndarray) -> np.ndarray:       # (O,I,kh,kw) -> (kh,kw,I,O)
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))


def _patch(arr: np.ndarray) -> np.ndarray:      # (D,3,P,P) -> (P*P*3, D)
    d = arr.shape[0]
    return np.ascontiguousarray(
        np.transpose(arr, (2, 3, 1, 0)).reshape(-1, d))


def _pos(arr: np.ndarray) -> np.ndarray:        # (1,N,D) -> (N,D)
    return np.ascontiguousarray(arr[0] if arr.ndim == 3 else arr)


def _ident(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr)


def default_name_map(like: Params) -> Dict[str, Tuple[Tuple[str, ...], Any]]:
    """ONNX tensor name -> (path into our param tree, converter fn).

    Paths are tuples of dict keys / list indices.  Covers the standard
    PyTorch-export naming of the OSTrack-style one-stream backbone and the
    CenterNet-style conv head towers.
    """
    m: Dict[str, Tuple[Tuple[str, ...], Any]] = {
        "backbone.patch_embed.proj.weight":
            (("backbone", "patch_embed", "kernel"), _patch),
        "backbone.patch_embed.proj.bias":
            (("backbone", "patch_embed", "bias"), _ident),
        "backbone.pos_embed_z": (("backbone", "pos_embed_z"), _pos),
        "backbone.pos_embed_x": (("backbone", "pos_embed_x"), _pos),
        "backbone.norm.weight": (("backbone", "norm", "scale"), _ident),
        "backbone.norm.bias": (("backbone", "norm", "bias"), _ident),
    }
    n_blocks = len(like["backbone"]["blocks"])
    for i in range(n_blocks):
        b = ("backbone", "blocks", i)
        pre = f"backbone.blocks.{i}."
        m[pre + "norm1.weight"] = (b + ("ln1", "scale"), _ident)
        m[pre + "norm1.bias"] = (b + ("ln1", "bias"), _ident)
        m[pre + "norm2.weight"] = (b + ("ln2", "scale"), _ident)
        m[pre + "norm2.bias"] = (b + ("ln2", "bias"), _ident)
        m[pre + "attn.qkv.weight"] = (b + ("qkv", "kernel"), _t)
        m[pre + "attn.qkv.bias"] = (b + ("qkv", "bias"), _ident)
        m[pre + "attn.proj.weight"] = (b + ("proj", "kernel"), _t)
        m[pre + "attn.proj.bias"] = (b + ("proj", "bias"), _ident)
        m[pre + "mlp.fc1.weight"] = (b + ("mlp1", "kernel"), _t)
        m[pre + "mlp.fc1.bias"] = (b + ("mlp1", "bias"), _ident)
        m[pre + "mlp.fc2.weight"] = (b + ("mlp2", "kernel"), _t)
        m[pre + "mlp.fc2.bias"] = (b + ("mlp2", "bias"), _ident)
    if "head" in like:
        # OSTrack's CenterPredictor names its towers ctr/offset/size and
        # builds each layer as Sequential(conv, bn, relu) -> exported
        # names ``box_head.convK_ctr.0.weight`` (+ BN params that
        # fold_bn_groups collapses into ``.0.weight/.0.bias``); the final
        # layer is a plain Conv2d (``box_head.convK_ctr.weight``).  Accept
        # both that dialect and the plain ``box_head.score.K.*`` one.
        tower_alias = {"score": ("score", "ctr", "cls"),
                       "offset": ("offset",), "size": ("size",)}
        for tower in ("score", "offset", "size"):
            n_layers = len(like["head"][tower])
            for j in range(n_layers):
                p = ("head", tower, j)
                names = [f"box_head.{tower}.{j}."]
                for alias in tower_alias[tower]:
                    names.append(f"box_head.conv{j + 1}_{alias}.0.")
                    if j == n_layers - 1:       # final plain-conv layer
                        names.append(f"box_head.conv{j + 1}_{alias}.")
                        names.append(f"box_head.conv{j + 2}_{alias}.")
                for pre in names:
                    m[pre + "weight"] = (p + ("kernel",), _conv)
                    m[pre + "bias"] = (p + ("bias",), _ident)
    # Prefix dialects seen in the wild: DataParallel's ``module.`` wrapper
    # and exports whose graph drops the ``backbone.`` scoping.
    for name in list(m):
        m["module." + name] = m[name]
        if name.startswith("backbone."):
            m[name[len("backbone."):]] = m[name]
    return m


def _get_path(tree: Any, path: Tuple) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _set_path(tree: Any, path: Tuple, value: Any) -> None:
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def map_tensors(tensors: Dict[str, np.ndarray], like: Params,
                name_map: Optional[Dict[str, Tuple[Tuple, Any]]] = None,
                strict: bool = True, fold_bn: bool = True,
                device="cuda") -> Params:
    """Place ONNX ``tensors`` into a copy of the ``like`` param tree (the
    port's nested dicts and lists of tensors) on ``device``: every leaf of
    the result lies there, each filled one in its ``like`` leaf's dtype.

    ``fold_bn`` (default) first collapses conv+BN groups via
    :func:`fold_bn_groups`.  Every mapped tensor is layout-converted and
    shape-checked against the destination leaf.  With ``strict`` (default)
    a destination leaf left unfilled, or a checkpoint tensor with no
    mapping, raises with the exact names involved — the error message is
    the worksheet for building a custom ``name_map`` for a
    differently-named export.
    """
    dev = resolve_device(device)
    if fold_bn:
        tensors = fold_bn_groups(tensors)
    name_map = dict(default_name_map(like) if name_map is None else name_map)
    out = weights.tree_to(like, dev, copy=True)
    filled = set()
    unmatched = []
    for name, arr in tensors.items():
        if name not in name_map:
            unmatched.append(name)
            continue
        path, conv = name_map[name]
        dst = _get_path(like, path)
        val = conv(np.asarray(arr))
        if tuple(val.shape) != tuple(dst.shape):
            raise ValueError(
                f"{name!r} -> {'/'.join(map(str, path))}: converted shape "
                f"{val.shape} != model shape {tuple(dst.shape)}")
        # A copy: ``val`` may view the file's read-only bytes.
        _set_path(out, path, torch.tensor(val, dtype=dst.dtype, device=dev))
        filled.add(path)
    if strict:
        wanted = {p for p, _ in name_map.values()}
        missing = sorted("/".join(map(str, p)) for p in wanted - filled)
        if missing or unmatched:
            parts = []
            if missing:
                parts.append(
                    "checkpoint did not fill these model parameters: "
                    + ", ".join(missing[:8])
                    + (f" (+{len(missing) - 8} more)"
                       if len(missing) > 8 else ""))
            if unmatched:
                um = sorted(unmatched)
                parts.append(
                    "checkpoint tensors with no mapping: " + ", ".join(um[:8])
                    + (f" (+{len(um) - 8} more)" if len(um) > 8 else ""))
            raise ValueError("; ".join(parts)
                             + " (pass strict=False / --no-strict to load "
                               "the mapped intersection)")
    return out


def load_onnx(path: str, like: Params, name_map: Optional[Dict] = None,
              strict: bool = True, fold_bn: bool = True,
              device="cuda") -> Params:
    """Read an ONNX VitTrack checkpoint and return the port's parameter
    tree on ``device``."""
    return map_tensors(read_onnx_tensors(path), like, name_map, strict,
                       fold_bn, device)
