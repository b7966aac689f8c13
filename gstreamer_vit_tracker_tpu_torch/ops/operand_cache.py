"""Kernel operands made once per parameter set.

The encoder's weights stacked over depth (``ops/vit_block.py``) and kernel
5's embed weight and ``pos_embed_x + bias`` (``ops/fused_prep_embed.py``)
are cast and laid out for their kernels once, not on every call.  This is
the one rule for when such operands go stale.
"""

from __future__ import annotations

import collections
import weakref
from typing import Any, Callable, Hashable, Sequence

import torch

from ..utils import graph


class OperandCache:
    """The last ``sets`` results of ``make()``, each kept while the leaves
    it was made from are the same tensors at the same ``_version`` (any
    in-place update, such as an optimiser step, moves it on)."""

    def __init__(self, sets: int = 4):
        self.sets = sets
        self._made: "collections.OrderedDict[Hashable, tuple]" = \
            collections.OrderedDict()

    def get(self, key: Hashable, leaves: Sequence[torch.Tensor],
            make: Callable[[], Any]) -> Any:
        """``make()``'s result for ``leaves`` under ``key`` (what else
        shapes it, such as the dtype), made anew when a leaf is another
        tensor or has been updated in place.  When a gradient is wanted of
        a leaf it is made on every call and not kept: the kernels have no
        backward.  A CUDA graph captured with the result holds it
        (``utils/graph.py``), so an eviction here never frees what a graph
        reads."""
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            return make()
        key = (key, tuple(map(id, leaves)))
        versions = tuple(t._version for t in leaves)
        hit = self._made.get(key)
        if hit is not None and hit[1] == versions and all(
                r() is t for r, t in zip(hit[0], leaves)):
            self._made.move_to_end(key)
            return graph.keep(hit[2])
        with torch.no_grad():
            made = make()
        self._made[key] = ([weakref.ref(t) for t in leaves], versions, made)
        while len(self._made) > self.sets:
            self._made.popitem(last=False)
        return graph.keep(made)
