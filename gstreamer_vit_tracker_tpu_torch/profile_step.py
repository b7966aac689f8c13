"""Where the time of the flagship update step and of the serving tick goes
on the card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_step [--steps 30]
                                                           [--slots 16]

Traces ``--steps`` flagship ``core.update_packed`` calls on a 1080p NV12
frame (after warm-up) with ``torch.profiler`` (CPU + CUDA activity) and
prints, as one JSON object: the host wall time per step, the device time
per step summed over kernels (one stream, so kernels do not overlap), the
device's idle share of the window, and the device time per step of each
kernel name, largest first; the same for one encoder kernel call alone,
for ``--steps`` ticks of a ``SlotEngine`` with ``--slots`` live slots fed
from pinned 1080p NV12 buffers (``--slots 0`` leaves the tick out), for the
NV12-to-tokens call ``nv12_search_tokens`` beside the unfused chain
``preprocess_nv12`` -> ``embed_search`` on the same frame and window, and
for 3 float32 training steps of the flagship's width and depth at
``--train-batch`` (0 leaves them out).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _kernel_table(prof, per: int):
    """({kernel name: device us per repetition}, largest first; total
    device us per repetition; device activities per repetition) from the
    profiler's CUDA events."""
    rows, count = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows[ev.name] = rows.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            count += 1
    rows = {k: v / per for k, v in sorted(rows.items(), key=lambda kv: -kv[1])}
    return rows, sum(rows.values()), count / per


def _traced(fn, reps: int, top: int) -> dict:
    """``reps`` calls of ``fn`` traced after a warm-up: host wall ms a call
    (synchronised at the end), device ms a call summed over kernels, the
    device's idle share, device activities a call, the largest kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows, us, launches = _kernel_table(prof, reps)
    return {"wall_ms": wall_ms, "device_ms": us / 1e3,
            "device_idle_share": max(0.0, 1.0 - us / 1e3 / wall_ms),
            "device_activities": launches,
            "top_us": {k: round(v, 3) for k, v in list(rows.items())[:top]}}


def _profile_prep(params, cfg, frame, state, args) -> dict:
    """The fused NV12-to-tokens call and the unfused chain, traced."""
    from .models import vit
    from .ops import fused_prep_embed as fpe
    from .ops import preprocess as pp

    y, uv = frame
    window = pp.crop_window(state.bbox, cfg.search_factor)
    ops = fpe.kernel_operands(params, y, uv, window, cfg)

    def chain():
        x_img = pp.preprocess_nv12(y, uv, window, cfg.search_size,
                                   cfg.norm_mean, cfg.norm_std,
                                   dtype=torch.bfloat16,
                                   band=cfg.preprocess_band)
        return vit.embed_search(params["backbone"], x_img[None], cfg)

    return {
        "nv12_search_tokens": _traced(
            lambda: fpe.nv12_search_tokens(params, y, uv, window, cfg),
            args.steps, args.top),
        "launch_on_ready_operands": _traced(lambda: fpe.launch(*ops, cfg),
                                            args.steps, args.top),
        "unfused_chain": _traced(chain, args.steps, args.top)}


def _profile_train(args, dev) -> dict:
    """3 float32 training steps at the flagship's width and depth on a
    seeded random batch, traced (the state advances between them)."""
    import dataclasses

    from .config import PRESETS
    from .models import weights
    from .train import step as train

    cfg = dataclasses.replace(PRESETS["vittrack-t"], dtype="float32")
    gen = torch.Generator().manual_seed(0)
    b = args.train_batch
    z = torch.randn((b, cfg.template_size, cfg.template_size, 3),
                    generator=gen).to(dev)
    x = torch.randn((b, cfg.search_size, cfg.search_size, 3),
                    generator=gen).to(dev)
    gt = (0.3 + 0.2 * torch.rand((b, 4), generator=gen)).to(dev)
    opt = train.make_optimizer(1e-4)
    box = [train.create_train_state(weights.load_npz(
        weights.checkpoint_path("vittrack-t"), cfg, device=dev), opt=opt)]

    def step():
        box[0] = train.train_step(box[0], z, x, gt, cfg, opt=opt,
                                  device=dev)[0]

    return dict(_traced(step, 3, args.top), batch=b)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--train-batch", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA GPU")

    from .entry import entry
    from .models import vit
    from .ops import preprocess as pp
    from .ops import vit_block
    from .tracker import core

    dev = torch.device("cuda", 0)
    fn, (params, state, frame) = entry(device=dev)
    cfg = fn.keywords["cfg"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]

    for _ in range(5):
        state, packed = core.update_packed(params, state, frame, cfg, "nv12",
                                           device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, packed = core.update_packed(params, state, frame, cfg, "nv12",
                                           device=dev)
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, packed = core.update_packed(params, state, frame, cfg,
                                               "nv12", device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    step_rows, step_us, step_launches = _kernel_table(prof, args.steps)

    window = pp.crop_window(state.bbox, cfg.search_factor)
    x_tok = vit.embed_search(params["backbone"], core._prep_nv12(
        frame, window, cfg.search_size, cfg)[None], cfg)
    x = torch.cat([state.z_tok[None], x_tok], dim=1).contiguous()
    blocks = [vit.cast_params(bp, torch.bfloat16)
              for bp in params["backbone"]["blocks"]]
    for _ in range(5):
        vit_block.encoder(x, blocks, cfg.num_heads)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            vit_block.encoder(x, blocks, cfg.num_heads)
        torch.cuda.synchronize()
        enc_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    enc_rows, enc_us, enc_launches = _kernel_table(prof, args.steps)

    top = args.top
    tick = _profile_tick(params, cfg, frame, args, dev) if args.slots else None
    prep = _profile_prep(params, cfg, frame, state, args)
    training = _profile_train(args, dev) if args.train_batch else None
    print(json.dumps({
        "card": card,
        "torch": torch.__version__,
        "steps": args.steps,
        "step": {
            "wall_ms_unprofiled": bare_ms,
            "wall_ms": wall_ms,
            "device_ms": step_us / 1e3,
            "device_idle_share": max(0.0, 1.0 - step_us / 1e3 / wall_ms),
            "kernels": len(step_rows),
            "device_activities": step_launches,
            "top_us": {k: round(v, 3) for k, v in list(step_rows.items())[:top]},
            "packed": np.asarray(packed.cpu()).tolist(),
        },
        "encoder_call": {
            "wall_ms": enc_wall_ms,
            "device_ms": enc_us / 1e3,
            "device_idle_share": max(0.0, 1.0 - enc_us / 1e3 / enc_wall_ms),
            "device_activities": enc_launches,
            "top_us": {k: round(v, 3) for k, v in list(enc_rows.items())[:top]},
        },
        "tick": tick,
        "fused_prep": prep,
        "train_step": training,
    }, indent=1))


def _profile_tick(params, cfg, frame, args, dev):
    """``args.steps`` ticks of an engine whose ``args.slots`` slots all
    track the example frame's box, traced like the step."""
    from .entry import INIT_BBOX
    from .serve import SlotEngine

    engine = SlotEngine(params, cfg, slots=args.slots, snapshot_every=0,
                        device=dev)
    for _ in range(args.slots):
        engine.init_slot(engine.alloc(), frame, INIT_BBOX)
    buf = tuple(p.cpu()[None].repeat(args.slots, *([1] * p.dim())).pin_memory()
                for p in frame)
    active = np.ones(args.slots, bool)
    for _ in range(3):
        engine.step(buf, active)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        packed = engine.step(buf, active)
    bare_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            packed = engine.step(buf, active)
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    rows, us, launches = _kernel_table(prof, args.steps)
    return {
        "slots": args.slots,
        "wall_ms_unprofiled": bare_ms,
        "wall_ms": wall_ms,
        "device_ms": us / 1e3,
        "device_idle_share": max(0.0, 1.0 - us / 1e3 / wall_ms),
        "device_idle_share_unprofiled": max(0.0, 1.0 - us / 1e3 / bare_ms),
        "kernels": len(rows),
        "device_activities": launches,
        "top_us": {k: round(v, 3) for k, v in list(rows.items())[:args.top]},
        "packed_slot0": packed[0].tolist(),
    }


if __name__ == "__main__":
    main()
