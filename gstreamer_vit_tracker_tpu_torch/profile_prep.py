"""The NV12-to-tokens kernel (kernel 5) on the card: where its time goes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_prep

At the flagship's shape (a banded 1080p NV12 frame, search 256, patch 16,
D 192, bf16, the shipped weights) it prints the device microseconds of one
launch (20 launches captured into a CUDA graph and replayed, mean of 20
replays) of builds of ``csrc/fused_prep_embed.cu`` rewritten in a copy under
``build/``:

``phases``: the shipped source; with the pixel phase cut out (the A tile
zero-filled instead); with the product cut out (its chunk loop never runs);
with both cut out; each as shipped (the D / 32 CTAs of a token tile one
cluster) and with the cluster off (every CTA makes all its tile's pixels).
What a phase costs is read as a difference of two of them.

``tilings``: the shipped source (16 tokens x 32 columns a CTA, clusters of
6 at D 192) beside builds of 24, 48 and 64 columns a CTA (clusters of 8, 4
and 3), and the shipped tiling with the cluster off, in turns.

``builds``: the shipped source with 3 or 4 weight k-chunks in flight
instead of 2, and with 512 threads a CTA instead of 256, in turns with the
shipped build.

Every build is first held to the plain version (one bf16 ulp at the largest
plain value) where it computes the whole function.  Prints the card's name
and power limit, then one JSON object a section.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from .ops import cuda_build
from .ops import fused_prep_embed as fpe
from .profile_encoder import _graph_us

_PIXELS = re.compile(r"  make_pixels<bf16>\([^;]*\);\n")
_LOOP = "  for (int c = 0; c < chunks; ++c) {\n"
_STAGES = "constexpr int kStages = 2;"
_THREADS = "constexpr int kThreads = 256;"
_COLS = "constexpr int kTileCols = 32;"
_CLUSTER = "attr[0].val.clusterDim.y = cluster;"


def builds() -> dict:
    """{name: C entry} of every rewritten build, compiled at once."""
    with open(os.path.join(cuda_build.CSRC, "fused_prep_embed.cu")) as f:
        shipped = f.read()
    if len(_PIXELS.findall(shipped)) != 1 or any(
            shipped.count(t) != 1
            for t in (_LOOP, _STAGES, _THREADS, _COLS, _CLUSTER)):
        raise RuntimeError("csrc/fused_prep_embed.cu no longer has the "
                           "statements the builds rewrite")
    no_pixels = _PIXELS.sub(
        "  for (int i = threadIdx.x; i < TM * lda; i += kThreads) "
        "A[i] = __float2bfloat16_rn(0.0f);\n", shipped)
    no_product = _LOOP.replace("c = 0", "c = chunks")
    phases = {"shipped": shipped, "no pixels": no_pixels,
              "no product": shipped.replace(_LOOP, no_product),
              "neither": no_pixels.replace(_LOOP, no_product)}
    sources = dict(phases)
    for name, text in phases.items():
        sources[f"{name}, no cluster"] = text.replace(
            _CLUSTER, "attr[0].val.clusterDim.y = 1;")
    for cols in (24, 48, 64):
        sources[f"{cols} columns"] = shipped.replace(
            _COLS, f"constexpr int kTileCols = {cols};")
    sources.update({
        "3 stages": shipped.replace(_STAGES, "constexpr int kStages = 3;"),
        "4 stages": shipped.replace(_STAGES, "constexpr int kStages = 4;"),
        "512 threads": shipped.replace(_THREADS, "constexpr int kThreads = 512;")})
    out_dir = os.path.join(cuda_build.BUILD_DIR, "profile_prep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
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


def main() -> None:
    from .config import PRESETS
    from .models import weights
    from .ops import preprocess as pp

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    entries = builds()
    cfg = PRESETS["vittrack-t"]
    params = weights.load_npz(weights.checkpoint_path("vittrack-t"), cfg,
                              device=dev)
    rng = np.random.default_rng(11)
    y = torch.as_tensor(rng.integers(0, 256, (1080, 1920), dtype=np.uint8),
                        device=dev)
    uv = torch.as_tensor(rng.integers(0, 256, (540, 960, 2), dtype=np.uint8),
                         device=dev)
    win = pp.crop_window(torch.tensor((1500.0, 700.0, 64.0, 64.0), device=dev),
                         cfg.search_factor)
    ops = fpe.kernel_operands(params, y, uv, win, cfg)
    plain = fpe.nv12_search_tokens_reference(params, y, uv, win, cfg)
    tol = 2.0 ** -7 * plain.float().abs().max().item()
    _, out, args = fpe._arguments(*ops, cfg)

    def timed(name) -> float:
        fn = entries[name]

        def launch():
            if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError(f"the {name!r} build failed to launch")

        launch()
        torch.cuda.synchronize()
        if not any(cut in name for cut in ("no pixels", "no product",
                                           "neither")):
            err = (out.float() - plain.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"the {name!r} build disagrees: "
                                     f"{err} > {tol}")
        return round(_graph_us(launch), 3)

    phases = {label: {name: timed(name + suffix) for name in
                      ("shipped", "no pixels", "no product", "neither")}
              for label, suffix in (("clusters of 6", ""),
                                    ("no cluster", ", no cluster"))}
    print(json.dumps({"phases_device_us": phases}), flush=True)
    tilings = [[name, timed(name)] for name in
               ("shipped", "24 columns", "48 columns", "64 columns",
                "shipped, no cluster", "shipped")]
    print(json.dumps({"tilings_device_us": tilings}), flush=True)
    rows = [[name, timed(name)] for name in
            ("shipped", "3 stages", "4 stages", "512 threads", "shipped")]
    print(json.dumps({"builds_device_us": rows}), flush=True)


if __name__ == "__main__":
    main()
