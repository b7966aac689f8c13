"""The NV12-to-tokens kernel (kernel 5) on the card: where its time goes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_prep

On a banded 1080p NV12 frame it prints the device microseconds of one
launch (20 launches captured into a CUDA graph and replayed, mean of 20
replays) of the shipped ``csrc/fused_prep_embed.cu`` and of builds of it
rewritten in a copy under ``build/``, each section at its shapes:

``f32``: float32 at the flagship's shape (search 256, patch 16, D 192, the
shipped weights cast), the ``small`` preset's (search 128, D 96, its
shipped weights) and corr-tiny's (patch 8, K 192, D 64, its seeded
weights): ``tf32x3`` on 8, 16, 24 and 32 columns a CTA and ``simt`` (by
name) in turns; the same tilings built for two CTAs an SM (at most 128
registers a thread); the plan with its pixel phase or its product cut out.

``wide``: bf16 at D 384 and 768 (seeded weights, search 256 and 128): the
two tilings of a token tile wider than one cluster of 32-column tiles, 32
columns a CTA in clusters of up to 8 (each cluster making the tile's
pixels again) and 64 columns a CTA, in turns.

``phases`` (bf16, the flagship's shape and shipped weights): the shipped
source; with the pixel phase cut out (the A tile zero-filled instead); with
the product cut out (its chunk loop never runs); with both cut out; each
in clusters of 6 (the plan) and with the cluster off (a plan of clusters of
1: every CTA makes all its tile's pixels).  What a phase costs is read as
a difference of two of them.

``tilings``: the plan (16 tokens x 32 columns a CTA, clusters of 6 at D
192) beside 64 columns a CTA (clusters of 3) and the plan with the cluster
off, in turns.

``builds``: the shipped source with 3 or 4 weight k-chunks in flight
instead of 2 ("mma"), and with 512 threads a CTA instead of 256, in turns
with the shipped build.

Every build is first held to the plain version (float32 1e-4, bf16 one ulp
at the largest plain value) where it computes the whole function.  Prints
the card's name and power limit, then one JSON object a section.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import subprocess

import numpy as np
import torch

from .ops import cuda_build
from .ops import fused_prep_embed as fpe
from .profile_encoder import _graph_us

# The statements the builds rewrite: the pixels and the product loop of
# "mma" and of "tf32x3", the ring's depth, the threads a CTA.
_PIXELS = re.compile(r"  make_pixels<bf16>\([^;]*\);\n")
_TF32_PIXELS = re.compile(
    r"  make_pixels<float>\(a\.frame, w, a\.norm, n0, kTileTokens[^;]*\);\n")
_LOOP = "  for (int c = 0; c < chunks; ++c) {\n"
_TF32_LOOP = "  for (int c = warp; c < chunks; c += 2 * kWarps) {\n"
_STAGES = "constexpr int kStages = 2;"
_THREADS = "constexpr int kThreads = 256;"
_TF32_BOUNDS = "__launch_bounds__(kThreads) embed_tf32_kernel("
_CUTS = ("no pixels", "no product", "neither")


def sources() -> dict:
    """{name: source} of every build: the shipped source and its rewrites;
    raises if the shipped source no longer has a statement they rewrite."""
    with open(os.path.join(cuda_build.CSRC, "fused_prep_embed.cu")) as f:
        shipped = f.read()
    if any(len(p.findall(shipped)) != 1 for p in (_PIXELS, _TF32_PIXELS)) \
            or any(shipped.count(t) != 1
                   for t in (_LOOP, _TF32_LOOP, _STAGES, _THREADS,
                             _TF32_BOUNDS)):
        raise RuntimeError("csrc/fused_prep_embed.cu no longer has the "
                           "statements the builds rewrite")
    no_pixels = _TF32_PIXELS.sub(
        "  for (int i = threadIdx.x; i < TM * lda; i += kThreads) A[i] = 0.0f;\n",
        _PIXELS.sub(
            "  for (int i = threadIdx.x; i < TM * lda; i += kThreads) "
            "A[i] = __float2bfloat16_rn(0.0f);\n", shipped))

    def no_product(text):
        return text.replace(_LOOP, _LOOP.replace("c = 0", "c = chunks")).replace(
            _TF32_LOOP, _TF32_LOOP.replace("c = warp", "c = chunks"))

    return {"shipped": shipped, "no pixels": no_pixels,
            "no product": no_product(shipped),
            "neither": no_product(no_pixels),
            "3 stages": shipped.replace(_STAGES, "constexpr int kStages = 3;"),
            "4 stages": shipped.replace(_STAGES, "constexpr int kStages = 4;"),
            "512 threads": shipped.replace(_THREADS,
                                           "constexpr int kThreads = 512;"),
            "2 CTAs an SM": shipped.replace(
                _TF32_BOUNDS,
                "__launch_bounds__(kThreads, 2) embed_tf32_kernel(")}


def builds() -> dict:
    """{name: C entry} of every build of :func:`sources`, compiled at once."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "profile_prep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        stem = os.path.join(out_dir, re.sub(r"\W+", "_", name))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC,
             "-o", stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), stem + ".so")
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name!r} build:\n{log}")
        entries[name] = fpe.bind(ctypes.CDLL(lib))
    return entries


def seeded_params(cfg, dev, seed: int):
    """Seeded patch embed and search pos embed: all kernel 5 reads."""
    rng = np.random.default_rng(seed)
    k, d = cfg.patch_size ** 2 * 3, cfg.embed_dim

    def t(*shape, std):
        return torch.as_tensor(std * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    return {"backbone": {"patch_embed": {"kernel": t(k, d, std=0.05),
                                         "bias": t(d, std=0.1)},
                         "pos_embed_x": t(cfg.num_search_tokens, d, std=0.1)}}


def main() -> None:
    from .config import PRESETS, ModelConfig
    from .models import vittrack, weights
    from .ops import preprocess as pp

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    entries = builds()
    rng = np.random.default_rng(11)
    y = torch.as_tensor(rng.integers(0, 256, (1080, 1920), dtype=np.uint8),
                        device=dev)
    uv = torch.as_tensor(rng.integers(0, 256, (540, 960, 2), dtype=np.uint8),
                         device=dev)
    box = torch.tensor((1500.0, 700.0, 64.0, 64.0), device=dev)

    def timed(name, params, cfg, chosen=None) -> float:
        """Device us a launch of build ``name`` on ``chosen`` (default: the
        plan), first held to the plain version unless a phase is cut."""
        fn = entries[name]
        win = pp.crop_window(box, cfg.search_factor)
        ops = fpe.kernel_operands(params, y, uv, win, cfg, chosen)
        chosen, out, args = fpe._arguments(*ops, cfg, chosen)

        def launch():
            if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError(f"the {name!r} build failed to launch "
                                   f"{chosen}")

        launch()
        torch.cuda.synchronize()
        if name not in _CUTS:
            plain = fpe.nv12_search_tokens_reference(params, y, uv, win, cfg)
            tol = (1e-4 if cfg.dtype == "float32"
                   else 2.0 ** -7 * plain.float().abs().max().item())
            err = (out.float() - plain.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"the {name!r} build disagrees on "
                                     f"{chosen}: {err} > {tol}")
        return round(_graph_us(launch), 3)

    flagship = PRESETS["vittrack-t"]
    f32 = {}
    for preset in ("vittrack-t", "small", "corr-tiny"):
        cfg = dataclasses.replace(PRESETS[preset], dtype="float32")
        params = (vittrack.init_params(torch.Generator().manual_seed(0), cfg,
                                       dev) if preset == "corr-tiny"
                  else weights.load_npz(weights.checkpoint_path(preset), cfg,
                                        device=dev))
        plans = [fpe.plan(cfg.embed_dim, torch.float32, cols=c)
                 for c in fpe._TF32_COLS]
        plans.append(fpe.plan(cfg.embed_dim, torch.float32, "simt"))
        f32[preset] = {
            "turns": [[str(p), timed("shipped", params, cfg, p)]
                      for p in plans * 2],
            "2 CTAs an SM": [[str(p), timed("2 CTAs an SM", params, cfg, p)]
                             for p in plans[:-1]],
            "tf32x3_phases": {name: timed(name, params, cfg)
                              for name in ("shipped",) + _CUTS}}
    print(json.dumps({"f32_device_us": f32}), flush=True)

    wide = {}
    for d in (384, 768):
        for search in (256, 128):
            cfg = ModelConfig(search_size=search, embed_dim=d,
                              num_heads=d // 64)
            params = seeded_params(cfg, dev, d)
            wide[f"D {d}, search {search}"] = [
                [str(p), timed("shipped", params, cfg, p)]
                for p in [fpe.plan(d, torch.bfloat16, cols=c)
                          for c in (32, 64)] * 2]
    print(json.dumps({"wide_device_us": wide}), flush=True)

    params = weights.load_npz(weights.checkpoint_path("vittrack-t"), flagship,
                              device=dev)
    chosen = fpe.plan(flagship.embed_dim, torch.bfloat16)
    off = chosen._replace(cluster=1)
    phases = {label: {name: timed(name, params, flagship, p) for name in
                      ("shipped",) + _CUTS}
              for label, p in (("clusters of 6", chosen), ("no cluster", off))}
    print(json.dumps({"phases_device_us": phases}), flush=True)
    tilings = [[str(p), timed("shipped", params, flagship, p)] for p in (
        chosen, fpe.plan(flagship.embed_dim, torch.bfloat16, cols=64), off,
        chosen)]
    print(json.dumps({"tilings_device_us": tilings}), flush=True)
    rows = [[name, timed(name, params, flagship)] for name in
            ("shipped", "3 stages", "4 stages", "512 threads", "shipped")]
    print(json.dumps({"builds_device_us": rows}), flush=True)


if __name__ == "__main__":
    main()
