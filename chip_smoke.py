#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device: needs ``torch.cuda.is_available()``; prints nvidia-smi's name
   and power limit of card 0;
2. build: compiles every CUDA source of the port (one ``nvcc`` per source,
   all at once) and prints the build time;
3. kernels against their plain twins: the encoder kernel at the flagship
   shape (B=1, S=320, D=192, 12 blocks, shipped weights in bf16, real
   template + search tokens) and at the f32 ``small`` shape, each held to
   ``ops/vit_block.py::encoder_reference`` on the same inputs; then timed
   with CUDA events beside the twin and a library yardstick (the same
   encoder written with ``torch.matmul`` and
   ``F.scaled_dot_product_attention``, used nowhere in the port);
4. main path: ``entry()`` on the flagship, ``init`` on a 1080p NV12 frame,
   then ``update_packed`` steps over a moving-target clip; every output
   finite, the encoder launch count equal to the number of steps, the
   median step time from CUDA events; the first steps checked against the
   same steps run by the port on the CPU, and the f32 ``small`` preset
   checked against the CPU over the whole clip;
5. prints the card line, then one ``{"kernels": [...]}`` line, then the
   result line ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package.  Float32 products and
convolutions run without TF32 on the card (both switches set below).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_HBM_BYTES_S = 3.35e12    # HBM3 bandwidth, H100 SXM
MAIN_STEPS = 60
CPU_CHECK_STEPS = 3
TIMING_ITERS = 100

# Kernel against twin, flagship bf16.  The residual stream of the trained
# flagship reaches |x| ~ 200, where one bf16 ulp is 1.0, so another
# summation order alone moves the encoder output by an ulp or more there:
# it is held to 1% of its largest value (two ulps at the top), and the
# output of the final LN to an absolute 0.05.
ENC_REL_TOL = 0.01            # max|kernel - twin| / max|twin|
LN_ATOL = 0.05
F32_ATOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nv12_clip(n: int, seed: int = 0, h: int = 1080, w: int = 1920,
              box=(880, 480, 96, 72), step=(3, 2)):
    """A bright textured target moving ``step`` px per frame over a dim
    textured background: ``n`` NV12 frames (Y, UV) and their boxes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg_y = (70 + 25 * np.sin(xx / 97.0) * np.cos(yy / 61.0)
            + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.uint8)
    bg_uv = (128 + rng.normal(0, 3, (h // 2, w // 2, 2))).clip(
        0, 255).astype(np.uint8)
    bw, bh = box[2], box[3]
    ty, tx = np.mgrid[0:bh, 0:bw]
    tex = (185 + 60 * (((tx // 8) + (ty // 8)) % 2)
           + rng.normal(0, 5, (bh, bw))).clip(0, 255).astype(np.uint8)
    frames, boxes = [], []
    for t in range(n):
        x0, y0 = box[0] + step[0] * t, box[1] + step[1] * t
        x0, y0 = x0 - x0 % 2, y0 - y0 % 2
        y = bg_y.copy()
        y[y0:y0 + bh, x0:x0 + bw] = tex
        uv = bg_uv.copy()
        uv[y0 // 2:(y0 + bh) // 2, x0 // 2:(x0 + bw) // 2] = (90, 200)
        frames.append((y, uv))
        boxes.append((float(x0), float(y0), float(bw), float(bh)))
    return frames, boxes


def library_encoder(x, blocks, num_heads):
    """The encoder written with PyTorch's library calls, timed as a
    yardstick only."""
    b, s, d = x.shape
    dh = d // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, dh).transpose(1, 2)

    for p in blocks:
        h = F.layer_norm(x, (d,), p["ln1"]["scale"], p["ln1"]["bias"], 1e-6)
        q, k, v = torch.chunk(torch.matmul(h, p["qkv"]["kernel"])
                              + p["qkv"]["bias"], 3, dim=-1)
        a = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
        a = a.transpose(1, 2).reshape(b, s, d)
        x = x + torch.matmul(a, p["proj"]["kernel"]) + p["proj"]["bias"]
        h = F.layer_norm(x, (d,), p["ln2"]["scale"], p["ln2"]["bias"], 1e-6)
        g = F.gelu(torch.matmul(h, p["mlp1"]["kernel"]) + p["mlp1"]["bias"],
                   approximate="tanh")
        x = x + torch.matmul(g, p["mlp2"]["kernel"]) + p["mlp2"]["bias"]
    return x


def encoder_cost(x, blocks, num_heads):
    """(FLOPs, bytes) the encoder must do and move on these inputs: the
    products' 2*M*N*K (scores and values included), x read and written
    once, every weight read once."""
    b, s, d = x.shape
    hidden = blocks[0]["mlp1"]["kernel"].shape[1]
    m = b * s
    per_block = (2 * m * d * 3 * d + 4 * b * s * s * d + 2 * m * d * d
                 + 4 * m * d * hidden)
    nbytes = 2 * x.numel() * x.element_size() + sum(
        t.numel() * t.element_size()
        for p in blocks for mod in p.values() for t in mod.values())
    return per_block * len(blocks), nbytes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2

    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.entry import entry
    from gstreamer_vit_tracker_tpu_torch.models import vit, vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import cuda_build, vit_block
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device -------------------------------------------------------
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
          f"total {time.perf_counter() - t0:.2f} s", flush=True)
    for name in cuda_build.SOURCES:
        with open(cuda_build.library_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    # -- 3. kernel against its plain twin ---------------------------------
    cfg = PRESETS["vittrack-t"]
    fn, (params, state, frame) = entry(device=dev)
    window = pp.crop_window(state.bbox, cfg.search_factor)
    x_img = core._prep_nv12(frame, window, cfg.search_size, cfg)
    x_tok = vit.embed_search(params["backbone"], x_img[None], cfg)
    x = torch.cat([state.z_tok[None], x_tok], dim=1).contiguous()
    blocks = [vit.cast_params(bp, torch.bfloat16)
              for bp in params["backbone"]["blocks"]]
    assert x.shape == (1, 320, 192) and x.dtype == torch.bfloat16

    out_k = vit_block.encoder(x, blocks, cfg.num_heads)
    out_p = vit_block.encoder_reference(x, blocks, cfg.num_heads)
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs()
    enc_err, enc_scale = err.max().item(), out_p.float().abs().max().item()
    ln_k = vit.layer_norm(out_k, params["backbone"]["norm"]).float()
    ln_p = vit.layer_norm(out_p, params["backbone"]["norm"]).float()
    ln_err = (ln_k - ln_p).abs()
    print(f"kernel vs twin, flagship bf16: encoder max|d| {enc_err} "
          f"(max|twin| {enc_scale}, mean|d| {err.mean().item():.3e}); "
          f"after LN max|d| {ln_err.max().item()} "
          f"(mean {ln_err.mean().item():.3e})", flush=True)
    if not torch.isfinite(out_k.float()).all():
        raise AssertionError("encoder kernel produced non-finite values")
    if enc_err > ENC_REL_TOL * enc_scale:
        raise AssertionError(f"encoder kernel disagrees with its twin: max|d| "
                             f"{enc_err} > {ENC_REL_TOL} x {enc_scale}")
    if not ln_err.max().item() <= LN_ATOL:
        raise AssertionError(f"encoder kernel after the final LN: max|d| "
                             f"{ln_err.max().item()} > {LN_ATOL}")

    small = PRESETS["small"]
    sparams = weights.load_npz(weights.checkpoint_path("small"), small,
                               device=dev)
    sblocks = sparams["backbone"]["blocks"]
    gen = torch.Generator(device="cpu").manual_seed(0)
    xs = torch.randn((1, small.num_tokens, small.embed_dim),
                     generator=gen).to(dev)
    f32_err = (vit_block.encoder(xs, sblocks, small.num_heads)
               - vit_block.encoder_reference(xs, sblocks, small.num_heads)
               ).abs().max().item()
    print(f"kernel vs twin, small f32 (S={small.num_tokens}, "
          f"D={small.embed_dim}, dh={small.embed_dim // small.num_heads}): "
          f"max|d| {f32_err}", flush=True)
    if not f32_err <= F32_ATOL:
        raise AssertionError(f"f32 encoder kernel: max|d| {f32_err} > {F32_ATOL}")

    kernel_ms = cuda_ms(lambda: vit_block.encoder(x, blocks, cfg.num_heads))
    plain_ms = cuda_ms(lambda: vit_block.encoder_reference(x, blocks,
                                                           cfg.num_heads))
    library_ms = cuda_ms(lambda: library_encoder(x, blocks, cfg.num_heads))
    kernel_ms2 = cuda_ms(lambda: vit_block.encoder(x, blocks, cfg.num_heads))
    flops, nbytes = encoder_cost(x, blocks, cfg.num_heads)
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"encoder ms (CUDA events, mean of {TIMING_ITERS}): kernel "
          f"{kernel_ms:.4f} / {kernel_ms2:.4f} (before / after the others), "
          f"plain {plain_ms:.4f}, library {library_ms:.4f}; bound "
          f"{bound_ms * 1e3:.2f} us ({flops / 1e9:.3f} GFLOP -> "
          f"{t_ops * 1e3:.2f} us, {nbytes / 1e6:.2f} MB -> "
          f"{t_bytes * 1e3:.2f} us)", flush=True)

    # -- 4. main path ------------------------------------------------------
    frames, boxes = nv12_clip(MAIN_STEPS + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    for _ in range(3):                                 # warm-up, uncounted
        fn(params, core.init(params, clip[0], boxes[0], cfg, device=dev),
           clip[1])
    state = core.init(params, clip[0], boxes[0], cfg, device=dev)
    torch.cuda.synchronize()
    vit_block.LAUNCHES = 0
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(MAIN_STEPS)]
    packed = []
    t0 = time.perf_counter()
    for i in range(MAIN_STEPS):
        events[i][0].record()
        state, out = core.update_packed(params, state, clip[i + 1], cfg,
                                        device=dev)
        events[i][1].record()
        packed.append(out)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / MAIN_STEPS
    launches = vit_block.LAUNCHES
    step_ms = [a.elapsed_time(b) for a, b in events]
    packed = torch.stack(packed).cpu().numpy()
    if launches != MAIN_STEPS:
        raise AssertionError(f"encoder kernel launched {launches} times in "
                             f"{MAIN_STEPS} steps")
    if packed.shape != (MAIN_STEPS, 5) or not np.isfinite(packed).all():
        raise AssertionError("main path produced non-finite or misshapen output")
    iou = [_iou(p[:4], boxes[i + 1]) for i, p in enumerate(packed)]
    print(f"main path: {MAIN_STEPS} flagship NV12 1080p update_packed steps, "
          f"encoder launches {launches}; step ms median "
          f"{statistics.median(step_ms):.4f} (CUDA events; min "
          f"{min(step_ms):.4f}, max {max(step_ms):.4f}), host wall "
          f"{wall_ms:.4f} ms/step; score first/last {packed[0, 4]:.4f}/"
          f"{packed[-1, 4]:.4f}, mean IoU vs drawn box {np.mean(iou):.3f}",
          flush=True)

    # The first steps against the same steps run by the port on the CPU.
    cpu = torch.device("cpu")
    cparams = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("vittrack-t"), cfg, device=cpu))
    cstate = core.init(cparams, frames[0], boxes[0], cfg, device=cpu)
    for i in range(CPU_CHECK_STEPS):
        cstate, cout = core.update_packed(cparams, cstate, frames[i + 1], cfg,
                                          device=cpu)
        d_box = np.abs(cout[:4].numpy() - packed[i, :4]).max()
        d_score = abs(float(cout[4]) - packed[i, 4])
        print(f"flagship step {i + 1} card vs CPU: max|d bbox| {d_box:.4f} px, "
              f"|d score| {d_score:.5f}")
        if d_box > 2.0 or d_score > 0.02:
            raise AssertionError("flagship card step disagrees with the CPU")

    # The f32 small preset, every step, against the CPU.
    sparams = vittrack.with_grouped_head(sparams)
    cs_params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("small"), small, device=cpu))
    gs = core.init(sparams, clip[0], boxes[0], small, device=dev)
    cs = core.init(cs_params, frames[0], boxes[0], small, device=cpu)
    worst_box = worst_score = 0.0
    for i in range(MAIN_STEPS):
        gs, gout = core.update_packed(sparams, gs, clip[i + 1], small,
                                      device=dev)
        cs, cout = core.update_packed(cs_params, cs, frames[i + 1], small,
                                      device=cpu)
        gout = gout.cpu().numpy()
        worst_box = max(worst_box, np.abs(gout[:4] - cout[:4].numpy()).max())
        worst_score = max(worst_score, abs(gout[4] - float(cout[4])))
    print(f"small f32, {MAIN_STEPS} steps card vs CPU: max|d bbox| "
          f"{worst_box:.2e} px, max|d score| {worst_score:.2e}")
    if worst_box > 1e-2 or worst_score > 1e-4:
        raise AssertionError("small f32 card trajectory disagrees with the CPU")

    # -- 5. result lines ---------------------------------------------------
    kernels = [{
        "name": "vit_encoder",
        "route": "cuda",
        "source": "gstreamer_vit_tracker_tpu_torch/csrc/vit_encoder.cu",
        "replaces": "gstreamer_vit_tracker_tpu/ops/vit_block.py:110",
        "tpu_kernel": "ops/vit_block.py::_encoder_kernel",
        "launches": launches,
        "launches_per_step": launches / MAIN_STEPS,
        "max_abs_err": enc_err,
        "max_abs_err_after_ln": ln_err.max().item(),
        "max_abs_err_f32_small": f32_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "step_ms_median": statistics.median(step_ms),
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _iou(a, b) -> float:
    ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


if __name__ == "__main__":
    sys.exit(main())
