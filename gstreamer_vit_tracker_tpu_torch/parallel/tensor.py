"""The collectives of the tensor-parallel (Megatron) block, with their
backward.

What XLA inserts for the JAX package's ``param_pspec`` layout, written out
for local shards on the ``model`` group:

* :func:`copy_to`: identity forward, all-reduce backward (the input of a
  column-parallel product, replicated on every rank);
* :func:`reduce_from`: all-reduce forward, identity backward (the partial
  sums of a row-parallel product);
* :func:`gather_from`: all-gather along the last dimension forward, this
  rank's slice backward (a column-parallel output every rank needs whole);
* :func:`scatter_to`: this rank's slice forward, all-gather backward (a
  replicated value of which a row-parallel product reads its rows).

The backward of :func:`gather_from` is a slice because what flows back into
it is whole on every rank: it comes from a computation every rank runs in
full, whose own input gradient :func:`scatter_to` has made whole.  Sums run
in float32 (:func:`reduce_from` casts), gathers move bytes.

These are the collectives the compiled programs under a mesh issue
(``utils/graph.py``): on NCCL they are captured into the CUDA graph like
any kernel, so each allocates its output with the op (the graph's pool)
and issues no host sync.  :func:`no_collectives` marks a body that runs
on a subset of the ranks (the engine's slot write): a collective there
would wait for ranks that never come, so it raises instead.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "all_reduce_sum", "copy_to", "reduce_from",
           "gather_from", "scatter_to", "no_collectives"]

_FORBIDDEN: contextvars.ContextVar = contextvars.ContextVar(
    "no_collectives", default=None)


@contextlib.contextmanager
def no_collectives(name: str) -> Iterator[None]:
    """Inside, :func:`all_gather_cat` and :func:`all_reduce_sum` raise,
    naming ``name``: the body runs on some ranks only."""
    token = _FORBIDDEN.set(name)
    try:
        yield
    finally:
        _FORBIDDEN.reset(token)


def _issue(what: str) -> None:
    name = _FORBIDDEN.get()
    if name is not None:
        raise RuntimeError(f"{name}: {what} inside a body that runs on a "
                           f"subset of the ranks (it would wait for the "
                           f"others)")


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order.  The
    bytes are gathered (a uint8 view), so any dtype crosses any backend;
    on NCCL into one buffer (``all_gather_into_tensor``)."""
    _issue("an all-gather")
    n = dist.get_world_size(group)
    if n == 1:
        return t
    raw = t.contiguous().view(torch.uint8)
    if dist.get_backend(group) == "nccl":
        out = raw.new_empty((n,) + tuple(raw.shape))
        dist.all_gather_into_tensor(out, raw, group=group)
        parts = list(out.unbind(0))
    else:
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=group)
    return torch.cat(parts, dim=dim).view(t.dtype)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of every rank's ``t``."""
    _issue("an all-reduce")
    out = t.contiguous().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def _local_slice(t: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    return t.chunk(n, dim=-1)[dist.get_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return all_reduce_sum(x.float(), group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(g, ctx.group), None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _local_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, -1, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum over the group (the backward casts back to x's
    dtype)."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFrom.apply(x, group)


def scatter_to(x: torch.Tensor, group) -> torch.Tensor:
    return _ScatterTo.apply(x, group)
