"""The encoder kernels on the card: the ``mma`` product tiles A/B, and
flagship trajectories against the CPU's.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_encoder [tiles] [lottery N] [arith N] [f32] [wide] [cut]

``tiles``: one launch on ready operands (``ops/vit_block.py::prepared``) of
kernel 1 at (1, 320, 192) and of kernel 2 at (1, 320, 192) and
(16, 320, 192), bf16, the flagship's shipped weights: the planned tiles,
every product at N 32, every product at N 64, and the plan again, in turns,
as device microseconds of a launch (20 launches captured into a CUDA graph
and replayed, mean of 20 replays); then ``tf32x3`` the same way in float32
at those shapes and at the ``small`` preset's (1, 80, 96) x 4 and (16, 80,
96), with every product at N 16 too and with 1 and 2 warpgroups a
CTA.

``lottery``: N seeded 1080p NV12 clips of 4 frames (the first is
``chip_smoke.py``'s clip), 3 unbatched flagship steps each, run free on the
card from the card's own ``init`` and step by step from the CPU's states,
with kernel 1 and with the plain twin on the card in its place, against the
same steps on the CPU: how many clips stay within ``chip_smoke.py``'s 2 px /
0.02, and each clip's largest distances.

``arith``: the same count on N clips for eight builds of kernel 1 that
differ in the arithmetic of the LayerNorm prologue alone
(``csrc/encoder_mma.cuh::layer_norm_tile``, rewritten in a copy of the
sources under ``build/``): the mean and the variance as sums divided by K
(``div``, as shipped) or multiplied by 1/K (``mul``); 1/sqrt correctly
rounded (``rn``, as shipped) or ``rsqrtf`` (``approx``); compiled with
``nvcc``'s default ``-fmad=true`` (``c``, as shipped) or ``-fmad=false``
(``nc``).  ``div-rn-c`` is the shipped kernel.

``f32``: where a float32 launch's device time goes, by stage: kernel 1 at
the flagship (1, 320, 192) x 12 and the ``small`` preset (1, 80, 96) x 4,
kernel 2 at (16, 320, 192) and (16, 80, 96), the shipped weights in
float32, ``tf32x3`` and ``simt`` by name on the same operands; one launch
on ready operands repeated under ``torch.profiler``, each device kernel
named by its place in the block (five launches a block for ``tf32x3``,
seven for ``simt``), mean device us a launch by stage.

``wide``: the same by stage for bf16 and then float32 at ViT-L's width (D
1024, 16 heads, MLP 4096, seeded weights) and for Model A (the same
weights in 4 heads of 256: chip_smoke.py's HEADS_A, whose attention stage
is the panel kernel): kernel 1 at (1, 320, 1024) x 24 and kernel 2 at (16,
320, 1024), seven launches a block (the two LN launches, qkv, attention,
proj, mlp1, mlp2), the launch's device us (a replayed CUDA graph), Model A
also at the panels of o a CTA the plan did not take (``Plan.group`` 1 and
2, float32 also 4), and beside each product ``torch.matmul``'s device us on
the same shapes (float32 without TF32).

``cut``: ``wide``'s two launches at the plan (device us a launch, a
replayed CUDA graph) for the shipped build and for builds that leave out
of the ring products their ``wgmma``, their f32 adds, or both
(``csrc/encoder_mma.cuh`` rewritten in a copy under ``build/``; the
outputs are wrong, the times say what the copies, the tensor-core steps
and the sums each cost).

Prints the card's name and power limit, then one JSON object a section.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from .ops import cuda_build, vit_block

GRAPH_LAUNCHES = 20


def _graph_us(launch) -> float:
    launch()
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for _ in range(GRAPH_LAUNCHES):
                launch()
    torch.cuda.synchronize()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 20 / GRAPH_LAUNCHES * 1e3


def tiles(dev) -> dict:
    from .config import PRESETS
    from .models import vit, weights

    cfg = PRESETS["vittrack-t"]
    params = weights.load_npz(weights.checkpoint_path("vittrack-t"), cfg,
                              device=dev)
    blocks = [vit.cast_params(bp, torch.bfloat16)
              for bp in params["backbone"]["blocks"]]
    flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
    stacked = vit_block._stack(flat, len(blocks))
    one = [t.contiguous() for t in flat[:len(vit_block._FIELDS)]]
    gen = torch.Generator().manual_seed(0)
    out = {}
    for label, batch, weights_, is_stacked in (
            ("encoder B=1", 1, stacked, True), ("block B=1", 1, one, False),
            ("block B=16", 16, one, False)):
        x = (2 * torch.randn((batch, cfg.num_tokens, cfg.embed_dim),
                             generator=gen)).to(dev, torch.bfloat16)
        base = vit_block._plan_for(x, cfg.num_heads, 4 * cfg.embed_dim)

        def time(chosen):
            _, launch = vit_block.prepared(x, weights_, cfg.num_heads,
                                           is_stacked, chosen=chosen)
            return _graph_us(launch)

        out[label] = {"plan_tiles": list(base.tiles), "plan_us": time(base),
                      "all_n32_us": time(base._replace(tiles=(32,) * 4)),
                      "all_n64_us": time(base._replace(tiles=(64,) * 4)),
                      "plan_again_us": time(base)}
    for preset in ("vittrack-t", "small"):
        pcfg = PRESETS[preset]
        pparams = weights.load_npz(weights.checkpoint_path(preset), pcfg,
                                   device=dev)
        fblocks = [vit.cast_params(bp, torch.float32)
                   for bp in pparams["backbone"]["blocks"]]
        fflat = [p[m][f] for p in fblocks for m, f in vit_block._FIELDS]
        fstacked = vit_block._stack(fflat, len(fblocks))
        fone = fflat[:len(vit_block._FIELDS)]
        hidden = fblocks[0]["mlp1"]["kernel"].shape[1]
        for batch, weights_, is_stacked in ((1, fstacked, True),
                                            (16, fone, False)):
            x = torch.randn((batch, pcfg.num_tokens, pcfg.embed_dim),
                            generator=gen).to(dev)
            base = vit_block._plan_for(x, pcfg.num_heads, hidden)

            def time(chosen):
                _, launch = vit_block.prepared(x, weights_, pcfg.num_heads,
                                               is_stacked, chosen=chosen)
                return _graph_us(launch)

            label = (f"{'encoder' if is_stacked else 'block'} f32 "
                     f"{tuple(x.shape)}")
            row = {"plan_tiles": list(base.tiles),
                   "plan_warpgroups": base.warpgroups, "plan_us": time(base)}
            for n in (16, 32, 64):
                row[f"all_n{n}_us"] = time(base._replace(tiles=(n,) * 4))
            other = 3 - base.warpgroups
            row[f"warpgroups_{other}_us"] = time(
                base._replace(warpgroups=other))
            row["plan_again_us"] = time(base)
            out[label] = row
    return out


F32_REPS = 20
# The launches of one block, in order, by variant.
F32_STAGES = {"tf32x3": ("ln1+qkv", "attention", "proj+residual",
                         "ln2+mlp1+gelu", "mlp2+residual"),
              "simt": ("ln1", "qkv", "attention", "proj+residual", "ln2",
                       "mlp1+gelu", "mlp2+residual")}


def _by_stage(label: str, launch, stages, depth: int,
              reps: int = F32_REPS) -> dict:
    """Mean device us a ``launch()`` by stage: ``reps`` launches under
    ``torch.profiler``, each device kernel named by its place in the block
    (``stages``, in launch order, ``depth`` blocks a launch; copies and
    memsets left out).  One launch more runs first under the profiler and
    is not counted: a trace can lose its first kernel."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    want = reps * depth * len(stages)
    for _ in range(3):     # a trace that lost activities is taken again
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps + 1):
                launch()
            torch.cuda.synchronize()
        kernels = sorted(
            (ev for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in ev.name.lower()
             and "memset" not in ev.name.lower()),
            key=lambda ev: ev.time_range.start)
        if want < len(kernels) <= want + depth * len(stages):
            kernels = kernels[len(kernels) - want:]
            break
    else:
        # Where the kernels stop following the block's order: the first
        # place a stage's kernel name differs from the first block's.
        names = [ev.name[:48] for ev in kernels]
        first = next((i for i in range(len(stages), len(names))
                      if names[i] != names[i % len(stages)]), None)
        near = names[max(0, (first or 0) - 3):(first or 0) + 3]
        raise RuntimeError(f"{label}: {len(kernels)} device kernels in "
                           f"{reps + 1} launches, not {want} and up to one "
                           f"launch's more; the first block "
                           f"{names[:len(stages)]}, out of order from kernel "
                           f"{first}: {near}")
    us = dict.fromkeys(stages, 0.0)
    for i, ev in enumerate(kernels):
        us[stages[i % len(stages)]] += ev.time_range.elapsed_us() / reps
    return {"total_us": sum(us.values()), **us}


def f32_stages(dev) -> dict:
    """Device us a launch by stage of the float32 cases (module
    docstring), ``tf32x3`` and ``simt``."""
    from .config import PRESETS
    from .models import vit, weights

    out = {}
    gen = torch.Generator().manual_seed(0)
    for preset in ("vittrack-t", "small"):
        cfg = PRESETS[preset]
        params = weights.load_npz(weights.checkpoint_path(preset), cfg,
                                  device=dev)
        blocks = [vit.cast_params(bp, torch.float32)
                  for bp in params["backbone"]["blocks"]]
        flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
        one = flat[:len(vit_block._FIELDS)]
        for batch, stacked in ((1, True), (16, False)):
            x = torch.randn((batch, cfg.num_tokens, cfg.embed_dim),
                            generator=gen).to(dev)
            w = vit_block._stack(flat, len(blocks)) if stacked else one
            depth = len(blocks) if stacked else 1
            label = (f"{'encoder' if stacked else 'block'} "
                     f"{tuple(x.shape)} x {depth}")
            out[label] = {}
            for variant, stages in F32_STAGES.items():
                _, launch = vit_block.prepared(
                    x, w, cfg.num_heads, stacked,
                    chosen=vit_block.Plan(variant))
                out[label][variant] = _by_stage(f"{label} {variant}", launch,
                                                stages, depth)
    return out


# ViT-L/16's width, heads, MLP and depth (Dosovitskiy et al. 2021, Table 1),
# and the heads of Model A (chip_smoke.py's HEADS_A: ViT-L's width in 4 heads
# of 256).
WIDE = dict(dim=1024, heads=16, hidden=4096, depth=24)
WIDE_HEADS = {"ViT-L": 16, "Model A": 4}
WIDE_REPS = 5
# Besides the plan, the prenormed products timed at these (warpgroups, N
# tiles) by batch.
WIDE_NAMED = {1: ((1, (64, 32, 64, 32)), (2, (128,) * 4)),
              16: ((2, (64,) * 4), (1, (64,) * 4))}
# The seven launches of a bf16 block at ViT-L's width, in order, by the
# plan's LN form: the streamed products (a statistics launch, then
# each chunk normalised as it lands) and the prenormed ones (the LN rows
# written once, then plain products).
WIDE_STAGES = {
    "streamed": ("ln1 stats", "ln1+qkv", "attention", "proj+residual",
                 "ln2 stats", "ln2+mlp1+gelu", "mlp2+residual"),
    "prenormed": ("ln1 rows", "qkv", "attention", "proj+residual",
                  "ln2 rows", "mlp1+gelu", "mlp2+residual")}


def _wide_cases(dev, dtype=torch.bfloat16) -> list:
    """(label, x, weights, stacked) of kernel 1 at ViT-L's (1, 320, 1024) x
    24 and kernel 2 at (16, 320, 1024) on seeded weights (every block the
    same) in ``dtype``."""
    d, hidden, depth = WIDE["dim"], WIDE["hidden"], WIDE["depth"]
    gen = torch.Generator().manual_seed(1024)
    name = str(dtype)[6:]

    def w(*shape, std, base=0.0):
        return (base + std * torch.randn(shape, generator=gen)).to(dev, dtype)

    block = {"ln1": {"scale": w(d, std=0.1, base=1.0), "bias": w(d, std=0.1)},
             "ln2": {"scale": w(d, std=0.1, base=1.0), "bias": w(d, std=0.1)},
             "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5),
                     "bias": w(3 * d, std=0.1)},
             "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d, std=0.1)},
             "mlp1": {"kernel": w(d, hidden, std=d ** -0.5),
                      "bias": w(hidden, std=0.1)},
             "mlp2": {"kernel": w(hidden, d, std=hidden ** -0.5),
                      "bias": w(d, std=0.1)}}
    one = [block[m][f] for m, f in vit_block._FIELDS]
    cases = []
    for batch, stacked in ((1, True), (16, False)):
        x = w(batch, 320, d, std=1.0)
        blocks = depth if stacked else 1
        weights_ = vit_block._stack(one * blocks, blocks) if stacked else one
        cases.append((f"{'encoder' if stacked else 'block'} {tuple(x.shape)} "
                      f"x {blocks} {name}", x, weights_, stacked))
    return cases


def wide_stages(dev, dtype=torch.bfloat16) -> dict:
    """Device us a launch by stage of kernel 1 at ViT-L's (1, 320, 1024) x
    24 and kernel 2 at (16, 320, 1024) in ``dtype``, seeded weights, the
    plan's form and tiles and (prenormed) the WIDE_NAMED alternatives, then
    the same launches in Model A's heads, at the plan and at the other
    panel groups; beside each product ``torch.matmul``'s device us on the
    same (M, K) x (K, N) (a CUDA graph of GRAPH_LAUNCHES replayed): the
    library's time for the product alone, without its LN, bias or
    epilogue."""
    d, hidden = WIDE["dim"], WIDE["hidden"]
    gen = torch.Generator().manual_seed(1)

    def w(*shape, std):
        return (std * torch.randn(shape, generator=gen)).to(dev, dtype)

    products = {"qkv": (d, 3 * d), "proj": (d, d), "mlp1": (d, hidden),
                "mlp2": (hidden, d)}
    out = {}
    for (label, x, weights_, stacked), (model, heads) in (
            (case, model) for model in WIDE_HEADS.items()
            for case in _wide_cases(dev, dtype)):
        batch, blocks = x.shape[0], weights_[0].shape[0] if stacked else 1
        chosen = vit_block._plan_for(x, heads, hidden)
        if chosen.group:      # the panel attention: the other groups
            groups = (1, 2) if dtype == torch.bfloat16 else (1, 2, 4)
            plans = [chosen] + [chosen._replace(group=g) for g in groups
                                if g != chosen.group]
        else:
            plans = [chosen] + ([chosen._replace(warpgroups=g, tiles=t)
                                 for g, t in WIDE_NAMED[batch]]
                                if chosen.ln == "prenormed" else [])
        label = f"{model} {label}"
        row = {"plan": list(chosen)}
        for i, p in enumerate(plans):
            _, launch = vit_block.prepared(x, weights_, heads, stacked, p)
            got = {"launch_us": _graph_us(launch)}
            got.update(_by_stage(label, launch, WIDE_STAGES[p.ln], blocks,
                                 WIDE_REPS))
            if i == 0:
                row.update(got)
            elif chosen.group:
                row[f"group {p.group}"] = got
            else:
                row[f"warpgroups {p.warpgroups} tiles {p.tiles}"] = got
        for name, (k, n) in products.items():
            a, b = w(batch * 320, k, std=1.0), w(k, n, std=k ** -0.5)
            c = torch.empty((batch * 320, n), dtype=dtype, device=dev)
            row[f"matmul {name} ({batch * 320}, {k}) x ({k}, {n}) us"] = \
                _graph_us(lambda a=a, b=b, c=c: torch.matmul(a, b, out=c))
        out[label] = row
    return out


# What the cut builds take out of csrc/encoder_mma.cuh's ring products: the
# wgmma of every step, or the f32 adds of the steps' and chunks' sums.
_CUT = {
    "wgmma": ("  if constexpr (BN == 32) wgmma_ss_t_n32(d, da, db, 0);\n"
              "  else wgmma_ss_t_n64(d, da, db, 0);", "  (void)da;\n  (void)db;"),
    "adds": ("  for (int i = 0; i < N; ++i) to[i] += from[i];",
             "  for (int i = 0; i < N; ++i) asm volatile(\"\" :: \"f\"(to[i]), \"f\"(from[i]));")}


def _rewritten_builds(builds: dict) -> dict:
    """``vit_encoder`` built from copies of the sources under ``build/``,
    ``builds`` = {name: ([(encoder_mma.cuh's statement, its replacement),
    ...], extra nvcc flags)}, every build compiled at once: {name: loaded
    library}.  Raises if a statement is no longer in the source once."""
    with open(os.path.join(cuda_build.CSRC, "encoder_mma.cuh")) as f:
        shipped = f.read()
    procs = {}
    for name, (edits, flags) in builds.items():
        src = shipped
        for old, new in edits:
            if shipped.count(old) != 1:
                raise RuntimeError(f"encoder_mma.cuh no longer has {old!r} once")
            src = src.replace(old, new)
        where = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "rewritten",
                             name)
        os.makedirs(where, exist_ok=True)
        for fn in os.listdir(cuda_build.CSRC):
            if fn.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(cuda_build.CSRC, fn), where)
        with open(os.path.join(where, "encoder_mma.cuh"), "w") as f:
            f.write(src)
        out = os.path.join(where, "libvit_encoder.so")
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", out,
               os.path.join(where, "vit_encoder.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        libs[name] = vit_block.bind(ctypes.CDLL(out))
    return libs


def cut_launches(dev) -> dict:
    """Device us of one launch (a replayed CUDA graph) of ``wide_stages``'s
    two cases at the plan, with the shipped kernel and with builds whose
    ring products leave out their wgmma, their f32 adds, or both (wrong
    outputs: for the time alone): what the products' copies, tensor-core
    steps and sums each cost."""
    builds = {"shipped": ([], []), "no wgmma": ([_CUT["wgmma"]], []),
              "no adds": ([_CUT["adds"]], []),
              "no wgmma, no adds": ([_CUT["wgmma"], _CUT["adds"]], [])}
    cases = _wide_cases(dev)
    out = {}
    for name, lib in _rewritten_builds(builds).items():
        with _library(lib):
            out[name] = {label: _graph_us(vit_block.prepared(
                x, weights_, WIDE["heads"], stacked)[1])
                for label, x, weights_, stacked in cases}
    return out


def nv12_clip(n: int, seed: int = 0, box=(880, 480, 96, 72), step=(3, 2)):
    """``chip_smoke.py``'s clip: a bright textured target moving ``step`` px
    a frame over a dim textured 1080p background; NV12 frames and boxes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:1080, 0:1920]
    bg_y = (70 + 25 * np.sin(xx / 97.0) * np.cos(yy / 61.0)
            + rng.normal(0, 6, (1080, 1920))).clip(0, 255).astype(np.uint8)
    bg_uv = (128 + rng.normal(0, 3, (540, 960, 2))).clip(0, 255).astype(np.uint8)
    bw, bh = box[2], box[3]
    ty, tx = np.mgrid[0:bh, 0:bw]
    tex = (185 + 60 * (((tx // 8) + (ty // 8)) % 2)
           + rng.normal(0, 5, (bh, bw))).clip(0, 255).astype(np.uint8)
    frames, boxes = [], []
    for t in range(n):
        x0, y0 = box[0] + step[0] * t, box[1] + step[1] * t
        x0, y0 = x0 - x0 % 2, y0 - y0 % 2
        y, uv = bg_y.copy(), bg_uv.copy()
        y[y0:y0 + bh, x0:x0 + bw] = tex
        uv[y0 // 2:(y0 + bh) // 2, x0 // 2:(x0 + bw) // 2] = (90, 200)
        frames.append((y, uv))
        boxes.append((float(x0), float(y0), float(bw), float(bh)))
    return frames, boxes


@contextlib.contextmanager
def _plain_twin():
    """Kernel 1's plain twin on the card in the kernel's place."""
    from .models import vit

    def twin(x, blocks, heads):
        return vit_block.encoder_reference(
            x, [vit.cast_params(b, x.dtype) for b in blocks], heads)

    shipped = vit_block.encoder
    vit_block.encoder = twin
    try:
        yield
    finally:
        vit_block.encoder = shipped


@contextlib.contextmanager
def _library(lib: ctypes.CDLL):
    """Kernel 1 launched from ``lib`` (a build of ``vit_encoder``)."""
    shipped = list(vit_block._LIB)
    vit_block._LIB[:] = [lib]
    try:
        yield
    finally:
        vit_block._LIB[:] = shipped


# The LayerNorm prologue's statements that the arith builds rewrite.
_MEAN = "__fdiv_rn(group8_sum(sum), k)"
_VAR = "__fdiv_rn(group8_sum(var), k)"
_RSQRT = "rsqrt_rn(__fadd_rn("


def arith_builds() -> dict:
    """The eight LayerNorm-arithmetic builds of ``vit_encoder``, compiled
    at once: {name: loaded library}."""
    builds = {}
    for div in ("div", "mul"):
        for rn in ("rn", "approx"):
            edits = []
            if div == "mul":
                edits += [(_MEAN, "__fmul_rn(group8_sum(sum), 1.0f / k)"),
                          (_VAR, "__fmul_rn(group8_sum(var), 1.0f / k)")]
            if rn == "approx":
                edits.append((_RSQRT, "rsqrtf(__fadd_rn("))
            for fmad in ("c", "nc"):
                builds[f"{div}-{rn}-{fmad}"] = (
                    edits, ["-fmad=false"] if fmad == "nc" else [])
    return _rewritten_builds(builds)


def lottery(dev, n_clips: int, routes: dict) -> dict:
    """Each route (a name and a context in which kernel 1's place is taken)
    on ``n_clips`` clips, free-running and from the CPU's states, against
    the CPU."""
    from .config import PRESETS
    from .models import vittrack, weights
    from .tracker import core

    cfg = PRESETS["vittrack-t"]
    cpu = torch.device("cpu")
    path = weights.checkpoint_path("vittrack-t")
    gp = vittrack.with_grouped_head(weights.load_npz(path, cfg, device=dev))
    cp = vittrack.with_grouped_head(weights.load_npz(path, cfg, device=cpu))

    def steps(params, d, frames, box, states=None):
        st = core.init(params, frames[0], box, cfg, device=d, frame_format="nv12")
        rows, seen = [], [st]
        for i, f in enumerate(frames[1:]):
            if states is not None:
                st = type(st)(*(t.to(d) for t in states[i]))
            st, out = core.update_packed(params, st, f, cfg, device=d,
                                         frame_format="nv12")
            rows.append(out.cpu().numpy())
            seen.append(st)
        return np.stack(rows), seen

    out = {name: {"free": 0, "from_cpu_state": 0, "clips": []} for name in routes}
    for c in range(n_clips):
        frames, boxes = nv12_clip(4) if c == 0 else nv12_clip(
            4, seed=c, box=(300 + 70 * c, 200 + 45 * (c % 9),
                            96 - 4 * (c % 3), 72 + 6 * (c % 4)),
            step=((3, 2), (-2, 2), (2, -1), (-3, -2))[c % 4])
        ref, cpu_states = steps(cp, cpu, frames, boxes[0])
        for name, route in routes.items():
            with route():
                free, _ = steps(gp, dev, frames, boxes[0])
                held, _ = steps(gp, dev, frames, boxes[0], cpu_states)
            row = {}
            for label, got in (("free", free), ("from_cpu_state", held)):
                d_box = float(np.abs(got[:, :4] - ref[:, :4]).max())
                d_score = float(np.abs(got[:, 4] - ref[:, 4]).max())
                out[name][label] += d_box <= 2.0 and d_score <= 0.02
                row[label] = [round(d_box, 4), round(d_score, 5)]
            out[name]["clips"].append(row)
    return {"clips": n_clips, **out}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_encoder needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    args = sys.argv[1:] or ["tiles"]
    if "tiles" in args:
        print(json.dumps({"tiles": tiles(dev)}), flush=True)
    if "f32" in args:
        print(json.dumps({"f32": f32_stages(dev)}), flush=True)
    if "wide" in args:
        print(json.dumps({"wide": wide_stages(dev)}), flush=True)
        print(json.dumps({"wide_float32": wide_stages(dev, torch.float32)}),
              flush=True)
    if "cut" in args:
        print(json.dumps({"cut": cut_launches(dev)}), flush=True)
    for section in ("lottery", "arith"):
        if section not in args:
            continue
        i = args.index(section)
        n = int(args[i + 1]) if i + 1 < len(args) and args[i + 1].isdigit() else 20
        if section == "lottery":
            routes = {"mma": contextlib.nullcontext, "plain twin": _plain_twin}
        else:
            routes = {name: (lambda lib=lib: _library(lib))
                      for name, lib in arith_builds().items()}
        print(json.dumps({section: lottery(dev, n, routes)}), flush=True)


if __name__ == "__main__":
    main()
