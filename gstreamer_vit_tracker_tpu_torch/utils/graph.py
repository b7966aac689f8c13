"""Compiled entry points: a step function captured into a CUDA graph once
per key and replayed.

The counterpart of ``functools.partial(jax.jit, static_argnames=...,
donate_argnums=...)``.  A captured CUDA graph is PyTorch's counterpart of a
compiled XLA program with static shapes; donation becomes static state
buffers that the replay updates in place.

* **The key.** One capture per key: the static arguments (the config, the
  frame format, ``exclusive`` ... and the device), the shape, strides,
  dtype and device of every tensor argument, the identity and
  ``_version`` of every parameter leaf, and the numerics switches in
  force (TF32, cuDNN's ``deterministic`` and ``benchmark``: a captured op
  keeps the algorithm chosen under the switches of its capture), and the
  mesh in context (below).  An
  in-place parameter update (an optimiser step) moves a leaf's
  ``_version`` and a re-uploaded tree has new leaves: both miss the key,
  as ``ops/operand_cache.py``'s operands do.
* **Parameters** (a ``params`` argument, where the function has one) are
  read in place, never copied.  The graph holds the kernel operands it
  was captured against (``OperandCache`` results) so that their cache may
  evict them; a graph whose parameter leaves died is dropped (weak
  references).  A training step has no ``params`` argument: its
  parameters, moments, step count and EMA are the donated state, keyed by
  shape and dtype like any array argument.
* **Inputs.** Every other tensor argument (the state, the frame planes,
  ``active``, ``bbox``, the slot index) is copied into the graph's static
  input buffers before each call's replays, numbers and numpy arrays
  first made tensors.  A buffer has its source's layout (a transposed
  weight stays transposed: a product of another layout may round
  otherwise).  The copies are ``non_blocking``: nothing reads back.
  A ``cached`` argument (a dataset, a frame pool) is copied only when
  another tensor, or a new version of the same one, comes in.  Array
  arguments may be trees of tuples, lists, named tuples and dicts, with
  ``None`` leaves.
* **Donation.** A donated argument is the graph's static buffer: the step
  writes the new value into it and the call returns that same object, as
  JAX's donation invalidates the old buffer.  Passing it back in costs no
  copy.  A value passed in from elsewhere is copied in and left untouched;
  if a result handed out earlier is still held when another value comes
  in, it is first given storage of its own, so it keeps its values.
* **Outputs** other than the donated ones are fresh tensors on every call
  (a clone of the graph's output), so a caller may hold the result of call
  N while call N+1 is enqueued.
* **First use** of a key on the card: the body runs once eagerly on the
  static buffers, on the capture stream (which builds the kernels, fills
  the ``lru_cache`` s and the operand caches, and settles cuBLAS); that run
  is the call's first step.  Then the body is captured; the capture
  launches nothing.  Further steps and calls replay the graph.
* **Launch counters** (``entry.launch_counts``) keep meaning "kernels run
  on the card": what the capture's Python calls added is taken back out
  and added again at every replay.
* **Steps.** ``steps=<argument>`` replays the step that many times a call
  (the scan pools, JAX's ``lax.scan``): the wrapper passes the body a device
  step index ``i`` ((1,) int64, 0 at each call's first step) that the graph
  increments.  The count is not part of the key.
* **Gradients.** The call runs under ``torch.no_grad()``; a body that
  differentiates (the training step) enables them itself.  Its backward
  ops run on autograd's device thread, on the stream of their forward op,
  which is the capture stream: they land in the graph with the forward.
* **On the CPU** the same static-buffer plumbing runs, with the body called
  eagerly for each step in place of a replay.  On the card a failed capture
  raises, naming the entry point and the op; there is no eager fallback.
* **Under a mesh** (``parallel/mesh.py::use_mesh``), JAX's ``jax.jit``
  under ``with mesh:``: the mesh is part of the key (its shape and axis
  names, this rank's coordinates, and each axis group's backend and name,
  since a graph holds the communicators it was captured against), and
  the body's collectives (``parallel/tensor.py``) run inside it.  On the
  card a mesh whose groups are NCCL is captured: the eager first step
  issues every collective of the body once, so each communicator exists
  before the capture, and the collectives then go into the graph like any
  kernel.  A gloo group cannot be captured (its collectives run on the
  host): with CUDA tensors a call raises before any launch, naming the
  entry point and the backend (:func:`capturable`), and the callers of
  ranks that share a card call the eager bodies by name
  (:func:`compiles_under`).  On the CPU the plumbing runs with the body
  called eagerly, as without a mesh.  Every rank must make the same hit,
  miss and capture decisions in the same order (a rank that captures
  while another replays waits on the first collective): the keys hold
  per-rank leaf identities, so a miss must come from what every rank does
  alike (the first call, a new parameter tree, ``recover``, the ``SETS``
  eviction), and a body that runs on some ranks only must hold no
  collective (``parallel/tensor.py::no_collectives``).
* **The capture mode** is ``thread_local``: a capture then forbids the
  unsafe calls of the capturing thread only, not those of the process's
  other threads (the NCCL watchdog queries the events of earlier
  collectives).  The backward's ops, which autograd's device thread
  launches onto the capture stream, land in the graph.  On an H100 with
  torch 2.11 and NCCL 2.28.9 both modes captured a backward and an
  all-reduce taken just after an eager one (``chip_smoke.py`` phase 15
  tries both).
"""

from __future__ import annotations

import collections
import inspect
import numbers
import sys
import threading
import traceback
import weakref
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..device import resolve_device

# The kernel-launch counters of the port: (module, attribute), an int or a
# dict of ints (``entry.launch_counts`` reads the same ones).
_COUNTERS = (("ops.vit_block", "LAUNCHES"),
             ("ops.vit_block", "BLOCK_LAUNCHES"),
             ("ops.vit_block", "VARIANT_LAUNCHES"),
             ("ops.attention", "SINGLE_LAUNCHES"),
             ("ops.attention", "FLASH_LAUNCHES"),
             ("ops.fused_prep_embed", "LAUNCHES"),
             ("ops.fused_prep_embed", "VARIANT_LAUNCHES"))
_PKG = __name__.rsplit(".", 2)[0]
SETS = 4                            # keys a wrapper keeps captured

_local = threading.local()          # .keep: the capture's list, or None
_side_streams: Dict[int, Any] = {}  # device index -> capture stream


def _numerics() -> Tuple[bool, ...]:
    """The switches that choose an op's algorithm when it is captured."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def keep(obj: Any) -> Any:
    """Hold ``obj`` for as long as the graph being captured on this thread
    lives (no-op outside a capture).  ``OperandCache.get`` calls it with
    the operands it hands a kernel."""
    held = getattr(_local, "keep", None)
    if held is not None:
        held.append(obj)
    return obj


def _read_counts() -> Dict[Tuple, int]:
    import importlib

    out = {}
    for mod, name in _COUNTERS:
        value = getattr(importlib.import_module(f"{_PKG}.{mod}"), name)
        if isinstance(value, dict):
            out.update({(mod, name, k): n for k, n in value.items()})
        else:
            out[(mod, name)] = value
    return out


def _add_counts(delta: Sequence[Tuple[Tuple, int]]) -> None:
    for key, n in delta:
        module = sys.modules[f"{_PKG}.{key[0]}"]
        if len(key) == 3:
            getattr(module, key[1])[key[2]] += n
        else:
            setattr(module, key[1], getattr(module, key[1]) + n)


# -- trees of tensors ---------------------------------------------------------

def _is_number(x) -> bool:
    return isinstance(x, (numbers.Number, np.generic)) and not isinstance(
        x, torch.Tensor)


def _numbers(x) -> bool:
    """A (nested) sequence of numbers only: one array argument."""
    if isinstance(x, (tuple, list)):
        return all(_numbers(c) for c in x)
    return _is_number(x)


_NONE = "none"                     # the spec of a None leaf


def flatten(x) -> Tuple[List[torch.Tensor], Hashable]:
    """An array argument as (tensor leaves, spec): tuples, lists, named
    tuples and dicts are walked; a tensor is a leaf; ``None`` has no leaf;
    a numpy array, a number or a sequence of numbers becomes one tensor
    leaf (on the host, where it lies)."""
    if isinstance(x, torch.Tensor):
        return [x], None
    if x is None:
        return [], _NONE
    if isinstance(x, dict):
        leaves, specs = [], []
        for c in x.values():
            got, spec = flatten(c)
            leaves += got
            specs.append(spec)
        return leaves, (dict, tuple(x), tuple(specs))
    if isinstance(x, (tuple, list)) and x and not _numbers(x):
        leaves, specs = [], []
        for c in x:
            got, spec = flatten(c)
            leaves += got
            specs.append(spec)
        return leaves, (type(x), tuple(specs))
    return [torch.as_tensor(np.asarray(x) if isinstance(x, np.generic)
                            else x)], None


def unflatten(spec: Hashable, leaves: Sequence[torch.Tensor]):
    """The inverse of :func:`flatten` (its leaves in order)."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        if s == _NONE:
            return None
        if s[0] is dict:
            return dict(zip(s[1], (build(c) for c in s[2])))
        kind, children = s
        built = [build(c) for c in children]
        if hasattr(kind, "_fields"):          # a named tuple
            return kind(*built)
        return kind(built)

    return build(spec)


def param_leaves(tree) -> List[Any]:
    """Every leaf of a parameter tree (dicts, lists, tuples), in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in param_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in param_leaves(v)]
    return [tree]


def _map_tensors(x, fn):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tensors(v, fn) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(v, fn) for v in x)
    return x


def _at(x, path: Tuple[int, ...]):
    for i in path:
        x = x[i]
    return x


def _replace_at(x, path: Tuple[int, ...], value):
    if not path:
        return value
    items = list(x)
    items[path[0]] = _replace_at(items[path[0]], path[1:], value)
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def _where(err: BaseException) -> str:
    """The innermost frame of this package in ``err``'s traceback, as
    ``file:line in function: source``."""
    for frame in reversed(traceback.extract_tb(err.__traceback__)):
        if f"{_PKG}" in frame.filename.replace("/", ".") and \
                not frame.filename.endswith("graph.py"):
            return (f"{frame.filename.rsplit(_PKG + '/', 1)[-1]}:"
                    f"{frame.lineno} in {frame.name}: {frame.line}")
    return "an op outside the package"


# -- meshes -----------------------------------------------------------------

def capturable(backend: str, device) -> bool:
    """Whether a body whose collectives run on a ``backend`` group can be
    compiled with its tensors on ``device``: on the card only NCCL's
    collectives go into a CUDA graph (gloo's run on the host); on the CPU
    nothing is captured, so any backend will do."""
    return torch.device(device).type != "cuda" or backend == "nccl"


def mesh_backends(mesh) -> Tuple[str, ...]:
    """The backend of each axis group of ``mesh``."""
    import torch.distributed as dist

    return tuple(dist.get_backend(mesh.get_group(i))
                 for i in range(mesh.ndim))


def compiles_under(mesh, device) -> bool:
    """Whether the compiled entry points run under ``mesh`` (None: no
    mesh) with tensors on ``device``; where not, the callers call the eager
    bodies by name (ranks that share a card talk over gloo)."""
    return mesh is None or all(capturable(b, device)
                               for b in mesh_backends(mesh))


_mesh_keys: Dict[int, Tuple[Any, Hashable]] = {}


def _mesh_key(mesh) -> Hashable:
    """The mesh in context as part of a key (module docstring); None
    without one.  Worked out once a mesh."""
    if mesh is None:
        return None
    got = _mesh_keys.get(id(mesh))
    if got is not None and got[0]() is mesh:
        return got[1]
    import torch.distributed as dist

    groups = [mesh.get_group(i) for i in range(mesh.ndim)]
    key = (tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names or ()),
           tuple(mesh.get_coordinate() or ()),
           tuple((dist.get_backend(g), g.group_name) for g in groups))
    _mesh_keys[id(mesh)] = (weakref.ref(mesh), key)
    return key


def _check_mesh(name: str, mesh, dev: torch.device) -> None:
    """Raise, before any launch, where ``mesh``'s collectives cannot be
    captured with tensors on ``dev``."""
    if mesh is None:
        return
    for axis, backend in zip(mesh.mesh_dim_names or range(mesh.ndim),
                             mesh_backends(mesh)):
        if not capturable(backend, dev):
            raise RuntimeError(
                f"{name}: the mesh's {axis!r} group is {backend}, whose "
                f"collectives cannot be captured into a CUDA graph (NCCL's "
                f"can); with tensors on {dev} under this mesh call the "
                f"eager function")


def _side_stream(dev: torch.device):
    stream = _side_streams.get(dev.index)
    if stream is None:
        stream = _side_streams[dev.index] = torch.cuda.Stream(dev)
    return stream


# -- one captured key -------------------------------------------------------

class _Graph:
    """What one key owns: the static input buffers, the aliases of the
    donated ones handed out, the captured graph and what it reads."""

    def __init__(self, dev, param_refs, inputs):
        self.dev = dev
        self.param_refs = param_refs
        # name -> (spec, static buffers)
        self.inputs: Dict[str, Tuple[Hashable, List[torch.Tensor]]] = inputs
        # donated name -> weak references to the aliases handed out last
        self.handed: Dict[str, List[weakref.ref]] = {}
        # cached name -> (weak reference, _version) of each leaf copied last
        self.sources: Dict[str, List[Tuple[weakref.ref, int]]] = {}
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = None
        self.out = None          # the captured step's outputs (graph memory)
        self.launches: Tuple[Tuple[Tuple, int], ...] = ()
        self.keep: List[Any] = []

    def alive(self, leaves) -> bool:
        return all(r() is t for r, t in zip(self.param_refs, leaves))

    def tree(self, name: str):
        spec, bufs = self.inputs[name]
        return unflatten(spec, bufs)


class Compiled:
    """``fn`` as a compiled entry point (module docstring).

    ``static``: argument names that form the key by value (hashable).
    ``donate``: argument name -> the path of its new value in ``fn``'s
    result (``()`` for the whole result, ``(0,)`` for its first element).
    ``scratch``: array arguments whose values are not copied in (the body
    overwrites them; their shape and dtype size the static buffer, so a
    ``meta`` tensor will do).  ``cached``: array arguments copied in only
    when another tensor or a new version of it comes in.  ``steps``: the
    argument that gives the number of steps a call (not part of the key),
    the body then taking ``i`` as well.  ``params``, where ``fn`` has it,
    is read in place, ``device`` is always static, and every other
    argument of ``fn`` is an array argument."""

    def __init__(self, fn: Callable, name: str, static: Sequence[str] = (),
                 donate: Optional[Dict[str, Tuple[int, ...]]] = None,
                 scratch: Sequence[str] = (), cached: Sequence[str] = (),
                 steps: Optional[str] = None):
        self.fn = fn
        self.name = name
        sig = inspect.signature(fn)
        # The step index is the wrapper's own argument.
        self.sig = sig.replace(parameters=[
            p for n, p in sig.parameters.items() if not (steps and n == "i")])
        names = [n for n in self.sig.parameters if n != steps]
        self.static = tuple(static) + ("device",)
        self.donate = dict(donate or {})
        self.scratch = frozenset(scratch)
        self.cached = frozenset(cached)
        self.steps = steps
        self.arrays = tuple(n for n in names
                            if n not in self.static and n != "params")
        unknown = (set(self.donate) | self.scratch | self.cached) - set(
            self.arrays)
        if unknown or "device" not in names:
            raise ValueError(f"{name}: {sorted(unknown)} are not array "
                             f"arguments, or device is missing")
        self.traces = 0          # captures (keys made, on the CPU)
        self.copies = 0          # leaves copied into static buffers
        self._graphs: "collections.OrderedDict[Hashable, _Graph]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()
        self.__doc__ = fn.__doc__
        self.__wrapped__ = fn

    # -- the cache ---------------------------------------------------------

    def drop(self, params) -> None:
        """Drop the keys captured against any leaf of ``params``."""
        with self._lock:
            ids = {id(t) for t in param_leaves(params)}
            for key in [k for k, g in self._graphs.items()
                        if any(id(r()) in ids for r in g.param_refs)]:
                del self._graphs[key]

    def __len__(self) -> int:
        return len(self._graphs)

    def _purge(self) -> None:
        dead = [k for k, g in self._graphs.items()
                if any(r() is None for r in g.param_refs)]
        for k in dead:
            del self._graphs[k]
        while len(self._graphs) >= SETS:
            self._graphs.popitem(last=False)

    # -- a call --------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        dev = resolve_device(a["device"])
        a["device"] = dev
        from ..parallel.mesh import current_mesh

        mesh = current_mesh()
        _check_mesh(self.name, mesh, dev)
        pleaves = param_leaves(a.get("params", ()))
        tensors = [t for t in pleaves if isinstance(t, torch.Tensor)]
        arrays = {n: flatten(a[n]) for n in self.arrays}
        key = (tuple(a[n] for n in self.static),
               tuple((id(t), t._version) if isinstance(t, torch.Tensor)
                     else t for t in pleaves),
               tuple((n, spec, tuple((tuple(t.shape), t.stride(), t.dtype,
                                      t.device) for t in leaves))
                     for n, (leaves, spec) in arrays.items()),
               _numerics(), _mesh_key(mesh))
        steps = int(a[self.steps]) if self.steps else 1
        if steps < 1:
            raise ValueError(f"{self.name}: {self.steps}={steps}, at least "
                             f"one step is needed")
        with self._lock, torch.no_grad():
            g = self._graphs.get(key)
            if g is not None and not g.alive(tensors):
                del self._graphs[key]
                g = None
            if g is None:
                self._purge()
                g = self._new(dev, tensors, arrays)
                self._graphs[key] = g
                self.traces += 1
            else:
                self._graphs.move_to_end(key)
            self._copy_in(g, arrays)
            call = {n: a[n] for n in self.static}
            if "params" in a:
                call["params"] = a["params"]
            call.update({n: g.tree(n) for n in self.arrays})
            if self.steps:
                call[self.steps], call["i"] = steps, g.index
                g.index.zero_()
            out = self._run(g, call, steps)
            return self._result(g, out)

    def _new(self, dev, tensors, arrays) -> _Graph:
        inputs = {}
        for n, (leaves, spec) in arrays.items():
            inputs[n] = (spec, [torch.empty_like(t, device=dev)
                                for t in leaves])
        return _Graph(dev, [weakref.ref(t) for t in tensors], inputs)

    def _copy_in(self, g: _Graph, arrays) -> None:
        for n, (leaves, _spec) in arrays.items():
            bufs = g.inputs[n][1]
            if n in self.scratch:
                continue
            if n in self.cached:
                src = g.sources.get(n)
                if src and all(r() is t and v == t._version
                               for (r, v), t in zip(src, leaves)):
                    continue                  # these values are in place
                g.sources[n] = [(weakref.ref(t), t._version) for t in leaves]
            if n in self.donate:
                handed = [r() for r in g.handed.get(n, ())]
                if handed and all(x is h for x, h in zip(leaves, handed)):
                    continue                  # the chain: already in place
                for h, b in zip(handed, bufs):
                    if h is not None:         # still held: keep its values
                        h.set_(b.clone())
                g.handed.pop(n, None)
            for b, t in zip(bufs, leaves):
                b.copy_(t, non_blocking=True)
            self.copies += len(leaves)

    def _step(self, g: _Graph, call: Dict[str, Any]):
        """One step: the body on the static buffers, then each donated
        value written into its buffers, then the step index moved on."""
        out = self.fn(**call)
        for n, path in self.donate.items():
            new, _ = flatten(_at(out, path))
            for b, t in zip(g.inputs[n][1], new):
                if t is not b:
                    b.copy_(t)
        if self.steps:
            g.index.add_(1)
        return out

    def _run(self, g: _Graph, call, steps: int):
        if g.dev.type != "cuda":
            for _ in range(steps):
                out = self._step(g, call)
            return out
        first = g.graph is None
        if first:
            out = self._capture(g, call)
            steps -= 1
        for _ in range(steps):
            g.graph.replay()
            _add_counts(g.launches)
        return out if first and steps == 0 else g.out

    def _capture(self, g: _Graph, call):
        """The first call of a key: the body eagerly on the capture stream
        (the call's first step), then its capture."""
        cur = torch.cuda.current_stream(g.dev)
        side = _side_stream(g.dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._step(g, call)
        before = _read_counts()
        graph = torch.cuda.CUDAGraph()
        _local.keep = g.keep
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                g.out = self._step(g, call)
        except Exception as err:
            raise RuntimeError(
                f"{self.name}: the CUDA graph capture failed at "
                f"{_where(err)}: {type(err).__name__}: {err}") from err
        finally:
            _local.keep = None
            after = _read_counts()
            _add_counts([(k, before[k] - n) for k, n in after.items()
                         if n != before[k]])
        g.launches = tuple((k, n - before[k]) for k, n in after.items()
                           if n != before[k])
        g.graph = graph
        cur.wait_stream(side)
        return out

    def _result(self, g: _Graph, out):
        """``out`` with each donated value replaced by aliases of its static
        buffers (the same objects while the caller holds them) and every
        other tensor cloned."""
        paths = list(self.donate.items())
        res = out
        for _, path in paths:
            res = _replace_at(res, path, None)
        res = _map_tensors(res, torch.clone)
        for n, path in paths:
            spec, bufs = g.inputs[n]
            handed = [r() for r in g.handed.get(n, ())]
            if not handed or any(h is None for h in handed):
                handed = [torch.empty(0, dtype=b.dtype,
                                      device=b.device).set_(b) for b in bufs]
                g.handed[n] = [weakref.ref(h) for h in handed]
            res = _replace_at(res, path, unflatten(spec, handed))
        return res


def compiled(name: str, **options) -> Callable[[Callable], Compiled]:
    """Decorator form of :class:`Compiled`."""
    return lambda fn: Compiled(fn, name, **options)
