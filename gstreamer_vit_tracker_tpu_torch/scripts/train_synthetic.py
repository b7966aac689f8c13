"""Train the conv-head VitTrack model on synthetic data and save weights.

Port of ``scripts/train_synthetic.py``, with the same flags, defaults,
prints and exit codes.  Usage:

    python -m gstreamer_vit_tracker_tpu_torch.scripts.train_synthetic \
        --steps 2000 --batch 32 --out weights_synthetic.npz [--preset small]

It runs on the card; ``--cpu`` runs the port's plain versions on the CPU.
Without ``--cpu`` and without a card it exits 1 with a message.

``--mesh DPxTP`` (or ``auto``: ``factor_mesh`` of the ranks) trains over a
(data x model) mesh of ranks, one process a rank as ``torchrun`` starts
them (``parallel/mesh.py::init_group``; a process already in a group uses
it):

    torchrun --nproc-per-node 4 -m \
        gstreamer_vit_tracker_tpu_torch.scripts.train_synthetic --mesh auto

Params take the Megatron layout of ``parallel/sharding.py``, every rank
draws the whole batch and steps its data slice (``train_scan``), and rank
0 alone prints and saves the gathered checkpoint.

The host pre-generates a uint8 crop dataset once (``train/data.py``),
moves it to the device, and ``train.step.train_scan`` samples, augments and
steps there, ``--log-every`` steps a chunk, with nothing read back inside a
chunk: compiled (one captured step replayed a step, JAX's jitted scan),
under ``--mesh`` too (the collectives inside the replay on NCCL ranks;
``train_scan_eager`` by name where ranks share a card over gloo,
``utils/graph.py::compiles_under``).  A refreshed dataset
(``--refresh-every``) has the same shapes and replays the same capture.
Its draws come from a CPU ``torch.Generator`` seeded with ``--seed + 1``,
so the card and the CPU draw the same indices and augmentations.  Training is in float32 whatever the preset.  The optimizer
(warmup + cosine AdamW with global-norm clipping) reads its step count from
its state.

The checkpoint is the flat npz both packages load:
    python -m gstreamer_vit_tracker_tpu_torch.app.main --model <preset> \
        --checkpoint weights_synthetic.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..config import PRESETS as _CONFIG_PRESETS
from ..device import resolve_device, true_float32
from ..models import vittrack, weights
from ..parallel import sharding
from ..parallel.mesh import use_mesh
from ..train import data
from ..train.step import (Optimizer, TrainState, create_train_state,
                          make_optimizer, train_scan, train_scan_eager)
from ..utils import graph

__all__ = ["PRESETS", "TrainReport", "build_argparser", "main", "run"]

PRESETS = {name: _CONFIG_PRESETS[name] for name in ("small", "vittrack-t")}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=-1,
                    help="warmup steps (-1: steps/20)")
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA decay for a parallel averaged checkpoint "
                         "(0 disables)")
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--init-from", default="",
                    help="warm-start from an existing checkpoint (fine-tune "
                         "on a shifted data distribution without paying for "
                         "from-scratch convergence; pair with a lower --lr)")
    ap.add_argument("--out", default="weights_synthetic.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset-size", type=int, default=8192)
    ap.add_argument("--border-frac", type=float, default=0.4,
                    help="fraction of samples with the target pinned to a "
                         "frame border (long-horizon robustness)")
    ap.add_argument("--full-occ-frac", type=float, default=0.12,
                    help="fraction of fully-occluded visible=0 negatives "
                         "(anchors the hidden-confidence collapse the Lost "
                         "machine's 0.25 threshold depends on)")
    ap.add_argument("--rotation-frac", type=float, default=0.0,
                    help="fraction of samples with an in-plane-rotated "
                         "target and a template/search angle MISMATCH "
                         "(rotation robustness, eval --scenario rotation); "
                         "keep modest — large-mismatch matching rests on "
                         "rotation-invariant cues only")
    ap.add_argument("--fade-frac", type=float, default=0.0,
                    help="fraction of samples with the search-side target "
                         "darkened to 30-100%% brightness vs the template "
                         "(deep-fade robustness, eval --scenario drift; "
                         "keeps visible=1 so fade stops reading as "
                         "occlusion)")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="regenerate the dataset every N steps (0: never)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (the port's plain versions; "
                         "slow, short fine-tunes only)")
    ap.add_argument("--mesh", default="",
                    help="train over a DPxTP mesh of ranks, e.g. '2x4' "
                         "(parallel/mesh.py): params laid out by "
                         "param_pspec, batches split over the data axis. "
                         "'auto' factors all ranks. One process when "
                         "empty.")
    ap.add_argument("--log-every", type=int, default=100,
                    help="steps per chunk / log line")
    ap.add_argument("--save-every", type=int, default=1000,
                    help="checkpoint cadence (crash insurance)")
    ap.add_argument("--data-diversity", default="v1",
                    choices=("v1", "v2", "v3"),
                    help="v2: adds rotated harmonic-blob silhouettes and "
                         "moving-background blobs to ~1/3 of scenes, plus "
                         "the search-frame time shift that makes them move "
                         "between template and search (train/data.py) — "
                         "the independent-world generalisation recipe")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--save-fp16", action="store_true",
                    help="save the checkpoint as float16 (half size)")
    return ap


@dataclasses.dataclass
class TrainReport:
    """What a run ends with: its exit code, the loss of every step (host
    floats, read back once a chunk), the host seconds spent generating
    data, the samples/s of the last log line, the final state, and what
    the run was made of (the first dataset as uint8 numpy stacks, the
    config, the optimizer, and under ``--mesh`` the mesh, whose ranks hold
    shards of the state) so a caller can repeat its steps."""

    rc: int
    losses: List[float] = dataclasses.field(default_factory=list)
    data_seconds: float = 0.0
    samples_per_s: float = 0.0
    state: Optional[TrainState] = None
    dataset: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    cfg: Any = None
    opt: Optional[Optimizer] = None
    mesh: Any = None


def main(argv=None) -> int:
    return run(argv).rc


def run(argv=None) -> TrainReport:
    """The script: parse ``argv``, train, save, and report."""
    args = build_argparser().parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to train on "
              "the CPU", file=sys.stderr)
        return TrainReport(rc=1)
    true_float32(dev)
    warmup = args.steps // 20 if args.warmup < 0 else args.warmup

    # Train in f32 regardless of the serving dtype: bf16 training of these
    # small models from scratch converges measurably worse, while bf16
    # *inference* of f32-trained weights is loss-free.
    cfg = dataclasses.replace(PRESETS[args.preset], dtype="float32")
    mesh = None
    if args.mesh:
        from ..parallel import factor_mesh, make_mesh
        from ..parallel.mesh import init_group

        init_group(dev)
        world = torch.distributed.get_world_size()
        if args.mesh == "auto":
            dp, tp = factor_mesh(world)
        else:
            dp, tp = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_mesh((dp, tp), device=dev)
    lead = mesh is None or torch.distributed.get_rank() == 0

    def say(*a, **k):
        if lead:
            print(*a, **k)

    params = vittrack.init_params(torch.Generator().manual_seed(args.seed),
                                  cfg, device=dev)
    if args.init_from:
        params = weights.load_npz(args.init_from, cfg, device=dev)
        say(f"warm-start from {args.init_from}", flush=True)
    say(f"preset {args.preset}: {vittrack.count_params(params):,} params, "
        f"backend {dev.type}", flush=True)
    if mesh is not None:
        params = sharding.shard_params(params, mesh)
        say(f"mesh: dp={dp} x tp={tp} over {dp * tp} devices", flush=True)

    opt = make_optimizer(args.lr, total_steps=args.steps,
                         warmup_steps=warmup, clip_norm=args.clip)
    state = create_train_state(params, opt=opt, ema_decay=args.ema)
    gen = torch.Generator().manual_seed(args.seed + 1)

    data.set_diversity(args.data_diversity)
    report = TrainReport(rc=0, cfg=cfg, opt=opt, mesh=mesh)

    def gen_dataset(seed):
        t = time.perf_counter()
        ds = data.make_dataset(seed, args.dataset_size, cfg,
                               border_frac=args.border_frac,
                               full_occ_frac=args.full_occ_frac,
                               rotation_frac=args.rotation_frac,
                               fade_frac=args.fade_frac)
        seconds = time.perf_counter() - t
        report.data_seconds += seconds
        say(f"dataset: {args.dataset_size} samples "
            f"({seconds:.0f}s host gen)", flush=True)
        if report.dataset is None:
            report.dataset = ds
        return tuple(torch.as_tensor(a, device=dev) for a in ds)

    ds = gen_dataset(args.seed)

    def whole(tree):
        return tree if mesh is None else sharding.gather_params(tree, mesh)

    def save():
        dt = np.float16 if args.save_fp16 else None
        trees = [(args.out, whole(state.params))]
        if state.ema_params is not None:
            trees = [(args.out, whole(state.ema_params)),
                     (args.out + ".raw.npz", trees[0][1])]
        if lead:
            for path, tree in trees:
                weights.save_npz(path, tree, dtype=dt)

    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        if (args.refresh_every and done
                and done % args.refresh_every == 0):
            ds = gen_dataset(args.seed + 1 + done)
        n = min(args.log_every, args.steps - done)
        scan = (train_scan if graph.compiles_under(mesh, dev)
                else train_scan_eager)
        with use_mesh(mesh):
            state, gen, ls, parts = scan(
                state, *ds, gen, cfg, opt, n_steps=n, batch=args.batch,
                ema_decay=args.ema, augment=not args.no_augment, device=dev)
        done += n
        ls = ls.cpu().numpy()
        report.losses.extend(float(v) for v in ls)
        loss = float(ls[-10:].mean())
        p = {k: float(v[-10:].mean()) for k, v in parts.items()}
        rate = done * args.batch / (time.perf_counter() - t0)
        report.samples_per_s = rate
        say(f"step {done:6d}  loss {loss:.4f}  "
            f"focal {p['focal']:.3f} l1o {p['l1_offset']:.3f} "
            f"l1s {p['l1_size']:.3f} giou {p['giou']:.3f}  "
            f"({rate:.0f} samples/s)", flush=True)
        if not np.isfinite(loss):
            raise FloatingPointError("training diverged")
        if args.save_every and done % args.save_every == 0:
            save()
    save()
    say(f"saved {args.out}")
    report.state = state
    return report


if __name__ == "__main__":
    sys.exit(main())
