"""Training step for the VitTrack model (float32: train in float32, serve
in bf16).

Port of ``gstreamer_vit_tracker_tpu/train/step.py``.  Parameters stay plain
nested dicts of tensors, so the state compares leaf by leaf with the JAX
package's; the optimiser is written out here instead of taken from
``torch.optim``, because three of its details differ from PyTorch's:

* AdamW's weight decay defaults to ``1e-4`` on every leaf, no mask, and is
  added to the Adam direction before the learning rate scales both;
* gradient clipping scales by ``max_norm / norm`` exactly (no ``1e-6`` in
  the denominator) and only when ``norm >= max_norm``;
* the warmup + cosine schedule decays over ``total_steps - warmup_steps``
  and reads the step count from the optimiser state, on the device.

The forward pass encodes per block (``fused=False``), as the JAX step does:
on the card its attention goes through ``ops/attention.py::flash_attention``
(kernel forward, backward through the plain version).  Nothing of a step is
read back to the host.  Random draws take an explicit ``torch.Generator``.

:func:`train_step` and :func:`train_scan` are compiled, as JAX's are
jitted (``utils/graph.py::Compiled``): on the card the step, forward and
backward with kernel 4 in it, is captured into a CUDA graph once a key
and replayed, the state donated (the graph's static buffers, the same
tensors from call to call; passing it back copies nothing).  ``train_scan`` draws a
window of steps' randoms from the CPU generator on the host first, in the
eager scan's order, uploads them once (pinned) and replays one captured
step a step, step ``i`` reading row ``i``: it computes what the eager
scan computes and leaves the generator where the eager scan leaves it.
The eager bodies are :func:`train_step_eager` and :func:`train_scan_eager`.

Under a mesh (``parallel/mesh.py::use_mesh``) a rank holds its shards of
the params (``parallel/sharding.py::shard_params``) and steps its slice of
the batch: the gradients, the loss and its parts are averaged over the
``data`` group, and clipping reads the norm of the whole gradient
(``parallel/sharding.py::sq_norm``), so a mesh step computes what one
process computes on the whole batch.  The mesh runs the eager functions;
the compiled ones raise under a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import vit
from ..models.heads import conv_head
from ..ops.preprocess import _channel_constant
from ..utils import graph
from . import losses

Params = Dict[str, Any]

__all__ = ["TrainState", "OptState", "Optimizer", "make_optimizer",
           "create_train_state", "loss_fn", "train_step", "train_scan",
           "train_step_eager", "train_scan_eager", "tree_map", "tree_leaves"]

# The loss parts in the order the compiled scan writes them beside the loss.
PARTS = ("focal", "l1_offset", "l1_size", "giou")
# At most this many bytes of randoms are drawn ahead on the host: the
# compiled scan replays in windows of as many steps as fit (at least one).
# While the card replays one window the host draws the next.
DRAW_WINDOW_BYTES = 64 << 20


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts and lists of one shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


class OptState(NamedTuple):
    count: torch.Tensor     # 0-d int32: steps taken
    mu: Params              # first moments, the params' tree
    nu: Params              # second moments


class TrainState(NamedTuple):
    params: Params
    opt_state: OptState
    step: torch.Tensor
    # Exponential moving average of params (None disables; made by
    # create_train_state(ema_decay > 0) as a distinct copy).
    ema_params: Optional[Params] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Global-norm clipping, then AdamW, as ``optax.chain(
    clip_by_global_norm, adamw)``."""

    lr: float = 1e-4
    weight_decay: float = 1e-4
    total_steps: Optional[int] = None
    warmup_steps: int = 0
    end_lr_frac: float = 0.05
    clip_norm: Optional[float] = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """Learning rate at step ``count`` (a tensor, so nothing is read
        back): constant without ``total_steps``; else a linear warmup from
        0 over ``warmup_steps``, then a cosine decay to ``lr * end_lr_frac``
        over ``total_steps - warmup_steps``."""
        count = count.to(torch.float32)
        if not self.total_steps:
            return torch.full_like(count, self.lr)
        decay_steps = float(self.total_steps - self.warmup_steps)
        alpha = 0.0 if self.lr == 0.0 else (self.lr * self.end_lr_frac) / self.lr
        t = torch.clamp_max(count - self.warmup_steps, decay_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / decay_steps))
        decayed = self.lr * ((1 - alpha) * cosine + alpha)
        if self.warmup_steps <= 0:
            return decayed
        frac = 1 - torch.clamp(count, 0, self.warmup_steps) / self.warmup_steps
        warm = (0.0 - self.lr) * frac + self.lr
        return torch.where(count < self.warmup_steps, warm, decayed)

    def init(self, params: Params) -> OptState:
        first = tree_leaves(params)[0]
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def clip(self, grads: Params) -> Params:
        """Gradients scaled to a global norm of ``clip_norm`` when theirs
        is not below it (a ``where``, no host read)."""
        if not self.clip_norm:
            return grads
        g_norm = torch.sqrt(_sq_norm(grads))
        keep = g_norm < self.clip_norm
        return tree_map(
            lambda g: torch.where(keep, g, (g / g_norm) * self.clip_norm),
            grads)

    def update(self, grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        """(updates to add to the params, new state)."""
        grads = self.clip(grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        step_size = -self.schedule(state.count)

        def leaf(m, v, p):
            direction = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            return step_size * (direction + self.weight_decay * p)

        return tree_map(leaf, mu, nu, params), OptState(count, mu, nu)


def _sq_norm(grads: Params) -> torch.Tensor:
    """The squared global norm of ``grads``; of the whole gradient when
    they are shards under a tensor-parallel mesh."""
    from ..parallel.mesh import current_mesh
    from ..parallel.sharding import sq_norm

    mesh = current_mesh()
    if mesh is None:
        return sum(torch.sum(g * g) for g in tree_leaves(grads))
    return sq_norm(grads, mesh)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-4, *,
                   total_steps: Optional[int] = None, warmup_steps: int = 0,
                   end_lr_frac: float = 0.05,
                   clip_norm: Optional[float] = 1.0) -> Optimizer:
    """AdamW with optional warmup + cosine schedule and global-norm
    clipping (the JAX package's ``make_optimizer``)."""
    return Optimizer(lr=lr, weight_decay=weight_decay, total_steps=total_steps,
                     warmup_steps=warmup_steps, end_lr_frac=end_lr_frac,
                     clip_norm=clip_norm)


def create_train_state(params: Params, lr: float = 1e-4,
                       opt: Optional[Optimizer] = None,
                       ema_decay: float = 0.0) -> TrainState:
    opt = opt if opt is not None else make_optimizer(lr)
    ema = tree_map(torch.clone, params) if ema_decay > 0 else None
    first = tree_leaves(params)[0]
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      ema_params=ema)


def loss_fn(params: Params, z_imgs: torch.Tensor, x_imgs: torch.Tensor,
            gts: torch.Tensor, cfg: ModelConfig,
            use_kernel: Optional[bool] = None):
    """Mean loss over the batch.  Inputs are normalised crops (B, Hz, Wz,
    3), (B, Hx, Wx, 3) and (B, 4) crop-normalised gt boxes, or (B, 5) with
    a trailing per-sample visibility flag (0 = target fully occluded in the
    search crop; trains the all-negative score map)."""
    z_tok = vit.embed_template(params["backbone"], z_imgs, cfg)
    x_tok = vit.embed_search(params["backbone"], x_imgs, cfg)
    # fused=False: training encodes per block (the encoder kernel's forward
    # with its twin's backward would mix implementations).
    x_feat = vit.encode(params["backbone"], z_tok, x_tok, cfg,
                        use_kernel=use_kernel, fused=False)
    score, offset, size = conv_head(params["head"], x_feat, cfg)
    vis = gts[:, 4] if gts.shape[1] == 5 else None
    total, parts = losses.total_loss(score, offset, size, gts[:, :4],
                                     visible=vis)
    return total.mean(), {k: v.mean() for k, v in parts.items()}


def _data_mean(grads: list, loss, parts):
    """Under a mesh, average ``grads`` (in place in the list), the loss and
    its parts over the ``data`` group: two all-reduces."""
    from ..parallel.mesh import current_mesh
    from ..parallel.sharding import data_mean

    mesh = current_mesh()
    if mesh is None:
        return loss, parts
    grads[:] = data_mean(list(grads), mesh)
    names = sorted(parts)
    vals = data_mean([torch.stack([loss] + [parts[k] for k in names])],
                     mesh)[0]
    return vals[0], dict(zip(names, vals[1:]))


def _step_impl(state: TrainState, z_imgs, x_imgs, gts, cfg: ModelConfig,
               opt: Optimizer, use_kernel: Optional[bool], ema_decay: float):
    with torch.enable_grad():      # a compiled call runs under no_grad
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
        loss, parts = loss_fn(params, z_imgs, x_imgs, gts, cfg, use_kernel)
        leaves = tree_leaves(params)
        flat = list(torch.autograd.grad(loss, leaves))
    with torch.no_grad():
        loss, parts = _data_mean(flat, loss, parts)
    flat = iter(flat)
    grads = tree_map(lambda _p: next(flat), params)
    with torch.no_grad():
        updates, new_opt = opt.update(grads, state.opt_state, state.params)
        new_params = tree_map(lambda p, u: p.detach() + u, state.params,
                              updates)
        ema = state.ema_params
        if ema is not None and ema_decay > 0:
            ema = tree_map(lambda e, p: e * ema_decay + p * (1 - ema_decay),
                           ema, new_params)
    return (TrainState(new_params, new_opt, state.step + 1, ema),
            loss.detach(), {k: v.detach() for k, v in parts.items()})


def train_step_eager(state: TrainState, z_imgs, x_imgs, gts,
                     cfg: ModelConfig, lr: float = 1e-4,
                     use_kernel: Optional[bool] = None,
                     opt: Optional[Optimizer] = None, ema_decay: float = 0.0,
                     device="cuda"
                     ) -> Tuple[TrainState, torch.Tensor,
                                Dict[str, torch.Tensor]]:
    """One optimisation step, eagerly (what :func:`train_step` compiles;
    the mesh's step).  Returns (new state, loss, loss parts), all tensors
    on the device; the old state is left as it was.  With ``opt=None`` a
    constant-LR AdamW(lr) is built.  ``state`` must lie on ``device``
    (``create_train_state`` keeps the params' device); the batch is moved
    there."""
    dev = resolve_device(device)
    opt = opt if opt is not None else make_optimizer(lr)
    z_imgs, x_imgs, gts = (torch.as_tensor(t, device=dev)
                           for t in (z_imgs, x_imgs, gts))
    return _step_impl(state, z_imgs, x_imgs, gts, cfg, opt, use_kernel,
                      ema_decay)


@graph.compiled("train.train_step",
                static=("cfg", "lr", "use_kernel", "opt", "ema_decay"),
                donate={"state": (0,)})
def train_step(state: TrainState, z_imgs, x_imgs, gts, cfg: ModelConfig,
               lr: float = 1e-4, use_kernel: Optional[bool] = None,
               opt: Optional[Optimizer] = None, ema_decay: float = 0.0,
               device="cuda"
               ) -> Tuple[TrainState, torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimisation step, compiled, the state donated (JAX's jitted
    ``train_step``): returns (state, loss, loss parts), the state's
    leaves being the graph's static buffers (the same tensors when it is
    passed back in; a state from elsewhere is copied in and left as it
    was), loss and parts fresh tensors.  Pass the same ``opt`` every call (it is static); with
    ``opt=None`` a constant-LR AdamW(lr) is built.  The batch is copied
    into the graph's buffers on ``device``.  Raises under a mesh."""
    opt = opt if opt is not None else make_optimizer(lr)
    return _step_impl(state, z_imgs, x_imgs, gts, cfg, opt, use_kernel,
                      ema_decay)


# ---------------------------------------------------------------------------
# Many steps from a device-resident dataset.
# ---------------------------------------------------------------------------


def _normalise(img01: torch.Tensor, mean, std) -> torch.Tensor:
    return ((img01 - _channel_constant(tuple(mean), torch.float32,
                                       img01.device))
            / _channel_constant(tuple(std), torch.float32, img01.device))


def _augment(gen: torch.Generator, z: torch.Tensor, x: torch.Tensor,
             gt: torch.Tensor, mean, std):
    """Per-sample augmentation of uint8 crops -> normalised float32.

    Horizontal flip (geometry-consistent: cx -> 1 - cx, for (B, 4) and
    (B, 5) boxes alike), brightness / contrast jitter shared by template
    and search (same lighting), and light gaussian noise on the search
    crop.  Draws come from ``gen`` on its own device, in this order, and
    move to the crops'."""
    b, dev = z.shape[0], z.device

    def draw(fn, *shape):
        return fn(*shape, generator=gen, device=gen.device).to(dev)

    u_flip = draw(torch.rand, b)
    u_contrast = draw(torch.rand, b, 1, 1, 1)
    u_bright = draw(torch.rand, b, 1, 1, 1)
    noise = draw(torch.randn, *x.shape)
    return _augment_with((u_flip, u_contrast, u_bright, noise), z, x, gt,
                         mean, std)


def _augment_with(draws, z: torch.Tensor, x: torch.Tensor, gt: torch.Tensor,
                  mean, std):
    """:func:`_augment` on its draws (uniforms for the flip, the contrast
    and the brightness, the search crop's standard normal noise)."""
    u_flip, u_contrast, u_bright, noise = draws
    zf = z.to(torch.float32) / 255.0
    xf = x.to(torch.float32) / 255.0

    flip = u_flip < 0.5
    zf = torch.where(flip[:, None, None, None], zf.flip(2), zf)
    xf = torch.where(flip[:, None, None, None], xf.flip(2), xf)
    gt = torch.where(flip[:, None],
                     torch.cat([1.0 - gt[:, :1], gt[:, 1:]], dim=-1), gt)

    contrast = 0.8 + 0.4 * u_contrast
    bright = -0.08 + 0.16 * u_bright
    zf = zf * contrast + bright
    xf = xf * contrast + bright
    xf = xf + 0.01 * noise
    return _normalise(zf, mean, std), _normalise(xf, mean, std), gt


def _minibatch(ds_z, ds_x, ds_gt, idx, draws, cfg: ModelConfig,
               augment: bool):
    """The step's normalised crops and boxes from the dataset rows
    ``idx`` (``draws``: the augmentation's, or None)."""
    mean, std = cfg.norm_mean, cfg.norm_std
    z, x, gt = ds_z[idx], ds_x[idx], ds_gt[idx]
    if augment:
        return _augment_with(draws, z, x, gt, mean, std)
    return (_normalise(z.to(torch.float32) / 255.0, mean, std),
            _normalise(x.to(torch.float32) / 255.0, mean, std), gt)


def train_scan_eager(state: TrainState, ds_z, ds_x, ds_gt,
                     gen: torch.Generator, cfg: ModelConfig, opt: Optimizer,
                     n_steps: int, batch: int,
                     use_kernel: Optional[bool] = None, ema_decay: float = 0.0,
                     augment: bool = True, device="cuda"):
    """Run ``n_steps`` optimisation steps eagerly with nothing read back
    (what :func:`train_scan` compiles; the mesh's scan).

    ``ds_z`` / ``ds_x`` are uint8 crop stacks (N, H, W, 3) and ``ds_gt``
    their boxes, moved to the device once; each step draws a
    with-replacement minibatch from ``gen`` (first the indices, then the
    augmentation's draws), augments, normalises and steps.  Returns (state,
    gen, losses (n_steps,), parts {name: (n_steps,)}).

    Under a mesh every rank draws the whole batch of ``batch`` from the
    same generator and steps its ``data`` slice of it (module
    docstring)."""
    from ..parallel.mesh import current_mesh
    from ..parallel.sharding import shard_batch

    mesh = current_mesh()
    dev = resolve_device(device)
    ds_z, ds_x, ds_gt = (torch.as_tensor(t, device=dev)
                         for t in (ds_z, ds_x, ds_gt))
    mean, std = cfg.norm_mean, cfg.norm_std
    ls, parts = [], []
    for _ in range(n_steps):
        idx = torch.randint(0, ds_z.shape[0], (batch,), generator=gen,
                            device=gen.device).to(dev)
        if augment:
            z, x, gt = _augment(gen, ds_z[idx], ds_x[idx], ds_gt[idx], mean,
                                std)
        else:
            z, x, gt = _minibatch(ds_z, ds_x, ds_gt, idx, None, cfg, False)
        if mesh is not None:
            z, x, gt = shard_batch((z, x, gt), mesh)
        state, loss, part = _step_impl(state, z, x, gt, cfg, opt, use_kernel,
                                       ema_decay)
        ls.append(loss)
        parts.append(part)
    return (state, gen, torch.stack(ls),
            {k: torch.stack([p[k] for p in parts]) for k in parts[0]})


def window_steps(n_steps: int, batch: int, crop_shape, augment: bool
                 ) -> int:
    """Steps in one draw window of the compiled scan: as many as
    ``DRAW_WINDOW_BYTES`` of draws hold (``crop_shape``: one search crop's
    (H, W, 3)), at least one, at most ``n_steps``."""
    per_step = 8 * batch + (4 * batch * (3 + math.prod(crop_shape))
                            if augment else 0)
    return max(1, min(n_steps, DRAW_WINDOW_BYTES // per_step))


def _draw_window(gen: torch.Generator, k: int, rows: int, n: int, batch: int,
                 x_shape: Tuple[int, ...], augment: bool, pin: bool):
    """The draws of ``k`` steps from ``gen`` in the eager scan's order
    (the indices, then the augmentation's flip, contrast, brightness and
    noise), step ``j`` in row ``j`` of ``rows``-row host tensors (pinned
    for a card; the rows past ``k`` are never read)."""
    def rows_of(*shape, dtype=torch.float32):
        return torch.empty((rows,) + shape, dtype=dtype, pin_memory=pin)

    idx = rows_of(batch, dtype=torch.int64)
    aug = (rows_of(batch), rows_of(batch, 1, 1, 1), rows_of(batch, 1, 1, 1),
           rows_of(*x_shape)) if augment else ()
    for j in range(k):
        torch.randint(0, n, (batch,), generator=gen, out=idx[j])
        if augment:
            u_flip, u_contrast, u_bright, noise = (t[j] for t in aug)
            torch.rand((batch,), generator=gen, out=u_flip)
            torch.rand((batch, 1, 1, 1), generator=gen, out=u_contrast)
            torch.rand((batch, 1, 1, 1), generator=gen, out=u_bright)
            torch.randn(x_shape, generator=gen, out=noise)
    return (idx,) + aug


@graph.compiled("train.train_scan",
                static=("cfg", "opt", "batch", "use_kernel", "ema_decay",
                        "augment"),
                donate={"state": (0,)}, scratch=("values",),
                cached=("ds_z", "ds_x", "ds_gt"), steps="n_steps")
def _scan_step(state: TrainState, ds_z, ds_x, ds_gt, draws, values, n_steps,
               cfg: ModelConfig, opt: Optimizer, batch: int,
               use_kernel: Optional[bool], ema_decay: float, augment: bool,
               device, i):
    """Step ``i`` of a window: its minibatch from row ``i`` of the draws,
    one optimisation step, the loss and its parts into row ``i`` of
    ``values``."""
    row = [t.index_select(0, i)[0] for t in draws]
    z, x, gt = _minibatch(ds_z, ds_x, ds_gt, row[0], row[1:], cfg, augment)
    state, loss, parts = _step_impl(state, z, x, gt, cfg, opt, use_kernel,
                                    ema_decay)
    values.index_copy_(0, i, torch.stack([loss] + [parts[k] for k in PARTS]
                                         )[None])
    return state, values


def train_scan(state: TrainState, ds_z, ds_x, ds_gt, gen: torch.Generator,
               cfg: ModelConfig, opt: Optimizer, n_steps: int, batch: int,
               use_kernel: Optional[bool] = None, ema_decay: float = 0.0,
               augment: bool = True, device="cuda"):
    """Run ``n_steps`` optimisation steps, compiled, the state donated
    (JAX's jitted ``train_scan``); computes what :func:`train_scan_eager`
    computes and returns the same (state, gen, losses (n_steps,), parts
    {name: (n_steps,)}), ``gen`` left in the same state.

    ``gen`` is a CPU generator.  The steps run in windows of at most
    ``DRAW_WINDOW_BYTES`` of draws: each window's draws are made on the
    host first, uploaded once, and one captured step is replayed a step
    (module docstring).  The dataset is copied into the graph's buffers
    once, and again only when another one (``--refresh-every``) comes in.
    Raises under a mesh."""
    graph.no_mesh("train.train_scan")
    dev = resolve_device(device)
    if gen.device.type != "cpu":
        raise ValueError("the compiled train_scan draws from a CPU "
                         "torch.Generator (train_scan_eager takes others)")
    n, x_shape = int(ds_z.shape[0]), (batch,) + tuple(ds_x.shape[1:])
    rows = window_steps(n_steps, batch, ds_x.shape[1:], augment)
    values = torch.empty((rows, 1 + len(PARTS)), device="meta")
    out = []
    for start in range(0, n_steps, rows):
        k = min(rows, n_steps - start)
        draws = _draw_window(gen, k, rows, n, batch, x_shape, augment,
                             pin=dev.type == "cuda")
        state, vals = _scan_step(state, ds_z, ds_x, ds_gt, draws, values, k,
                                 cfg, opt, batch, use_kernel, ema_decay,
                                 augment, dev)
        out.append(vals[:k])
    cols = torch.cat(out).t().contiguous()
    return state, gen, cols[0], dict(zip(PARTS, cols[1:]))
