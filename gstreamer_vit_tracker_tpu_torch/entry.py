"""Entry points: one flagship tracking update, and the multi-rank dry run.

Counterparts of ``__graft_entry__.py::entry`` and ``dryrun_multichip`` at
the root of the repo.  ``entry()`` returns ``(fn, args)``: ``fn(*args)``
runs one ``tracker.core.update`` of the flagship ``vittrack-t`` model
(D=192, depth 12, bf16, grouped conv head) with its shipped weights, on
the card unless ``device="cpu"``.  Run as a program it takes that step
through the compiled update with the state donated (``core.update_jit``,
as ``__graft_entry__.py`` jits ``fn`` with ``donate_argnums=(1,)``) and
prints ``entry OK:`` with the shapes of the box and the score:

    python -m gstreamer_vit_tracker_tpu_torch.entry [--cpu]

``dryrun_multichip(n)`` runs JAX's dry run over ``n`` ranks of one host
(``parallel/launch.py``): a (data x model) mesh of ``factor_mesh(n)``, the
flagship-width float32 train step sharded dp x tp, a mesh-backed
``SlotEngine`` tick on a pure-data mesh, and (tp > 1) the Megatron serving
forward, each held to one process.  On the card every rank shares card 0
unless there are n cards (``parallel/mesh.py::backend_for``).
"""

from __future__ import annotations

import argparse
import functools
import sys
from typing import Any, Dict

import numpy as np
import torch

from .config import PRESETS, ModelConfig
from .device import resolve_device, true_float32
from .models import vittrack, weights
from .tracker import core

FRAME_H, FRAME_W = 1080, 1920
INIT_BBOX = (900.0, 500.0, 120.0, 90.0)


def entry(device="cuda"):
    """Returns (fn, example_args) for one NV12 1080p update step."""
    dev = resolve_device(device)
    cfg = PRESETS["vittrack-t"]
    params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("vittrack-t"), cfg, device=dev))
    rng = np.random.default_rng(0)
    y_plane = rng.integers(0, 256, (FRAME_H, FRAME_W), dtype=np.uint8)
    uv_plane = rng.integers(0, 256, (FRAME_H // 2, FRAME_W // 2, 2),
                            dtype=np.uint8)
    frame = core._frame_on((y_plane, uv_plane), "nv12", dev)
    state = core.init(params, frame, INIT_BBOX, cfg, frame_format="nv12",
                      device=dev)
    fn = functools.partial(core.update, cfg=cfg, frame_format="nv12",
                           device=dev)
    return fn, (params, state, frame)


# -- the multi-rank dry run -------------------------------------------------

# JAX's dry-run configurations (__graft_entry__.py): the flagship's width
# and depth in float32 with crops cut for speed, and a small serving model.
DRYRUN_CFG = ModelConfig(template_size=32, search_size=64, patch_size=16,
                         embed_dim=192, depth=12, num_heads=3,
                         dtype="float32")
DRYRUN_SERVE_CFG = ModelConfig(template_size=32, search_size=64,
                               patch_size=16, embed_dim=32, depth=2,
                               num_heads=2, dtype="float32")
DRYRUN_FRAME_HW = (64, 96)
# The train loss against one process, relative (JAX's bound).
DRYRUN_LOSS_RTOL = 1e-4
# Packed rows against one engine, float32: JAX's rtol / atol for the
# pure-data tick.  The tensor-parallel forward sums each row-parallel
# product over the model ranks in another order than one device does
# (JAX reads 0 there); float32 rounding of that order stays far inside the
# same 1e-4, which the port holds it to.
DRYRUN_SERVE_TOL = 1e-4
DRYRUN_TP_TOL = 1e-4


def launch_counts() -> Dict[str, int]:
    """The kernel-launch counters of this process (after a sync)."""
    from .ops import attention, vit_block
    from .ops import fused_prep_embed as fpe

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return {"vit_encoder": vit_block.LAUNCHES,
            "vit_block": vit_block.BLOCK_LAUNCHES,
            "attention_single": attention.SINGLE_LAUNCHES,
            "attention_flash": attention.FLASH_LAUNCHES,
            "fused_prep_embed": fpe.LAUNCHES}


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def train_steps(params, batch, cfg: ModelConfig, steps: int = 1,
                mesh=None, device="cuda") -> Dict[str, Any]:
    """``steps`` eager ``train_step`` s from ``params`` (a host tree) on
    ``batch`` (numpy z, x, gt): in one process, or under ``mesh`` on this
    rank's shards and data slice (the mesh runs the eager step).  Returns the losses, the full params
    and first moments after the first step (flat numpy, gathered on a
    mesh) and the kernel launches of the steps."""
    from .parallel import sharding
    from .parallel.mesh import use_mesh
    from .train.step import create_train_state, train_step_eager

    dev = resolve_device(device)
    true_float32(dev)
    p = weights.tree_to(params, dev, copy=True)
    if mesh is not None:
        p = sharding.shard_params(p, mesh)
        batch = sharding.shard_batch(tuple(batch), mesh)
    z, x, gt = (torch.as_tensor(np.asarray(t), device=dev) for t in batch)
    state = create_train_state(p)
    losses, first = [], None
    before = launch_counts()
    with use_mesh(mesh):
        for _ in range(steps):
            state, loss, _ = train_step_eager(state, z, x, gt, cfg,
                                              device=dev)
            losses.append(float(loss))
            first = first or (state.params, state.opt_state.mu)
    launches = _launches_since(before)

    def whole(tree):
        if mesh is not None:
            tree = sharding.gather_params(tree, mesh)
        return weights.flatten(weights.tree_to_numpy(tree))

    return {"losses": losses, "launches": launches,
            "params": whole(first[0]), "mu": whole(first[1])}


def serve_tick(params, cfg: ModelConfig, frames0, frames1, bboxes,
               mesh=None, device="cuda") -> Dict[str, Any]:
    """A ``SlotEngine`` of len(bboxes) NV12 slots (on ``mesh`` if given):
    every slot initialised on ``frames0`` at its box, then one tick on
    ``frames1``.  Returns the packed (S, 5) rows, whether the engine's qkv
    kernel is a shard, and the tick's kernel launches."""
    from .serve import SlotEngine

    dev = resolve_device(device)
    true_float32(dev)
    s = len(bboxes)
    eng = SlotEngine(params, cfg, slots=s, frame_format="nv12", device=dev,
                     mesh=mesh)
    for i in range(s):
        eng.init_slot(eng.alloc(), (frames0[0][i], frames0[1][i]), bboxes[i])
    before = launch_counts()
    packed = eng.step(frames1, np.ones(s, bool))
    qkv = eng.params["backbone"]["blocks"][0]["qkv"]["kernel"]
    return {"packed": packed, "launches": _launches_since(before),
            "qkv_split": qkv.shape[1] != 3 * cfg.embed_dim}


def _dryrun_inputs(n: int, dp: int, seed: int = 0):
    cfg = DRYRUN_CFG
    params = weights.tree_to(vittrack.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"), "cpu")
    from .train import data

    rng = np.random.default_rng(seed)
    batch = data.make_batch(rng, max(dp * 2, 4), cfg)
    sparams = vittrack.init_params(torch.Generator().manual_seed(1),
                                   DRYRUN_SERVE_CFG, device="cpu")
    h, w = DRYRUN_FRAME_HW

    def nv12():
        return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
                rng.integers(0, 256, (n, h // 2, w // 2, 2), dtype=np.uint8))

    frames0, frames1 = nv12(), nv12()
    bboxes = [[20.0 + 2.0 * i, 16.0 + 1.0 * i, 24.0, 20.0] for i in range(n)]
    return params, batch, sparams, frames0, frames1, bboxes


def dryrun_rank(rank: int, n: int, device="cuda") -> Dict[str, Any]:
    """One rank of :func:`dryrun_multichip`.  Rank 0 also runs the
    one-process references and checks each part against them."""
    from .parallel import factor_mesh, make_mesh

    dp, tp = factor_mesh(n)
    params, batch, sparams, frames0, frames1, bboxes = _dryrun_inputs(n, dp)
    lines = []
    out: Dict[str, Any] = {"mesh": [dp, tp]}

    # -- (a) flagship-width train step, dp over the batch, tp over blocks.
    mesh = make_mesh((dp, tp), device=device)
    got = train_steps(params, batch, DRYRUN_CFG, mesh=mesh, device=device)
    out["train_launches"] = got["launches"]
    lossm = got["losses"][0]
    if not np.isfinite(lossm):
        raise AssertionError(f"non-finite mesh loss {lossm}")

    # -- (b) the serving tick: slots over a pure-data mesh.
    pure = make_mesh((n, 1), device=device)
    served = serve_tick(sparams, DRYRUN_SERVE_CFG, frames0, frames1, bboxes,
                        mesh=pure, device=device)
    out["serve_launches"] = served["launches"]
    # -- (d) the Megatron serving forward on the dp x tp mesh.
    tp_served = None
    if tp > 1:
        tp_served = serve_tick(sparams, DRYRUN_SERVE_CFG, frames0, frames1,
                               bboxes, mesh=mesh, device=device)
        out["tp_serve_launches"] = tp_served["launches"]
        if not tp_served["qkv_split"]:
            raise AssertionError("tp qkv kernel is whole: model axis unused")
    if rank != 0:
        return out

    loss1 = train_steps(params, batch, DRYRUN_CFG, device=device)["losses"][0]
    dl = abs(lossm - loss1)
    bound = DRYRUN_LOSS_RTOL * max(1.0, abs(loss1))
    if not dl <= bound:
        raise AssertionError(f"mesh/single-process loss diverge: {lossm} vs "
                             f"{loss1} (|d|={dl:.3e} > {bound:.1e})")
    lines.append(f"dryrun flagship train OK: mesh {dp}x{tp}, D=192 depth=12, "
                 f"loss {lossm:.6f}, |mesh-single| {dl:.2e} "
                 f"(bound {bound:.1e})")
    one = serve_tick(sparams, DRYRUN_SERVE_CFG, frames0, frames1, bboxes,
                     device=device)["packed"]
    packed = served["packed"]
    if packed.shape != (n, 5) or not np.isfinite(packed).all():
        raise AssertionError("non-finite or misshapen serve outputs")
    lines.append(f"dryrun serve mesh OK: {n} slots / {n} devices, nv12, "
                 f"packed {packed.shape}")
    np.testing.assert_allclose(packed, one, rtol=DRYRUN_SERVE_TOL,
                               atol=DRYRUN_SERVE_TOL)
    d_serve = float(np.abs(packed - one).max())
    lines.append(f"dryrun equivalence OK: serve |mesh-single| {d_serve:.2e}"
                 f", train |mesh-single| {dl:.2e} (bounds rtol/atol "
                 f"{DRYRUN_SERVE_TOL:.0e}, {bound:.1e})")
    out.update(loss=lossm, loss_single=loss1, d_loss=dl, d_serve=d_serve)
    if tp_served is not None:
        np.testing.assert_allclose(tp_served["packed"], one,
                                   rtol=DRYRUN_TP_TOL, atol=DRYRUN_TP_TOL)
        d_tp = float(np.abs(tp_served["packed"] - one).max())
        lines.append(f"dryrun tp-serving OK: mesh {dp}x{tp} Megatron "
                     f"forward, |tp-single| {d_tp:.2e} (bound rtol/atol "
                     f"{DRYRUN_TP_TOL:.0e})")
        out["d_tp"] = d_tp
    lines.append(f"dryrun_multichip OK: mesh {dp}x{tp}, loss {lossm:.4f}")
    out["lines"] = lines
    return out


def dryrun_multichip(n_ranks: int, device="cuda",
                     timeout: float = 900.0) -> Dict[str, Any]:
    """JAX's dry run over ``n_ranks`` ranks of this host (module
    docstring); prints its lines and returns rank 0's report with every
    rank's kernel launches (``launches``).  Raises if a part disagrees with
    one process beyond its bound."""
    from .parallel.launch import run_ranks

    dev = resolve_device(device)
    reports = run_ranks(dryrun_rank, n_ranks, str(dev), device=dev,
                        timeout=timeout)
    for line in reports[0]["lines"]:
        print(line, flush=True)
    out = dict(reports[0])
    out["launches"] = [{k: r[k] for k in r if k.endswith("_launches")}
                       for r in reports]
    return out


def main(argv=None) -> int:
    """``entry()``'s step through the compiled update, the state donated;
    prints ``entry OK:`` and the output shapes (``__graft_entry__.py``'s
    ``__main__``).  On the card unless ``--cpu``."""
    ap = argparse.ArgumentParser(description="One compiled flagship update.")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    fn, example = entry(device="cpu" if args.cpu else "cuda")
    out = core.update_jit(*example, **fn.keywords)
    print("entry OK:", tuple(tuple(t.shape) for t in out[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
