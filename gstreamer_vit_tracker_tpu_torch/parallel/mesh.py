"""Process groups and the (data, model) device mesh.

Port of ``gstreamer_vit_tracker_tpu/parallel/mesh.py``.  The JAX package
scales two ways over a ``jax.sharding.Mesh``: multi-stream serving sharded
over a ``data`` axis and tensor-parallel training over a ``model`` axis,
with XLA inserting the collectives.  Here the mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group (one process a rank, as ``torchrun`` starts them), and the port's
own code issues the collectives (``parallel/tensor.py``,
``parallel/sharding.py``).

A model routes to its tensor-parallel form through the mesh in context
(:func:`use_mesh`), as JAX routes through ``with mesh:``.

The group's backend: NCCL when each rank has a card of its own, gloo on
the CPU and when ranks share a card (NCCL refuses two ranks on one
device).  Gloo takes CUDA tensors for its all-reduce and all-gather.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

__all__ = ["DATA_AXIS", "MODEL_AXIS", "init_group", "make_mesh",
           "factor_mesh", "use_mesh", "current_mesh", "axis_size"]

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def backend_for(dev: torch.device, world: int) -> str:
    """``nccl`` when every rank can have a card of its own, else ``gloo``."""
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_group(device="cuda", rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None) -> str:
    """Join the default process group unless this process is in one, and
    return its backend.

    ``rank``, ``world_size`` and ``init_method`` default to what
    ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``env://``); a process
    that no launcher started forms a group of one.  On the card each rank
    takes card ``LOCAL_RANK`` modulo the card count (so ranks beyond it
    share cards)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_backend()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend_for(dev, world)
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise ValueError(f"a group of {world} ranks needs an init_method "
                             "or torchrun's environment")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    return backend


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
              device="cuda") -> DeviceMesh:
    """Build a (data, model) mesh over the default group's ranks (joined
    first if needed, :func:`init_group`).

    ``shape=None`` uses all ranks as (n, 1): pure data parallel.  A mesh
    that needs more ranks than the group has raises."""
    dev = resolve_device(device)
    init_group(dev)
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    n = shape[0] * shape[1]
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} devices, have {world}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def factor_mesh(n_devices: int) -> Tuple[int, int]:
    """Pick a (data, model) factorisation: prefer model-parallel width 2
    when it divides, else pure DP."""
    if n_devices % 2 == 0 and n_devices >= 4:
        return (n_devices // 2, 2)
    return (n_devices, 1)


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """The mesh in context for this thread: ``models/vit.py::encode`` takes
    the tensor-parallel route on shards under a mesh whose model axis is
    wider than 1, and ``train/step.py`` averages over its data axis."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    return _MESH.get()


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the mesh axis named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))
