#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device: needs ``torch.cuda.is_available()``; prints nvidia-smi's name
   and power limit of card 0;
2. build: compiles every CUDA source of the port (one ``nvcc`` per source,
   all at once) and prints the build time;
3. kernels against their plain versions, then timed with CUDA events beside
   the plain version, a library yardstick used nowhere in the port, and
   the card's bound for the same work:
   * the encoder kernel at the flagship shape (B=1, S=320, D=192, 12
     blocks, shipped weights in bf16, real template + search tokens): the
     wrapper, which must launch the ``mma`` variant, held to
     ``ops/vit_block.py::encoder_reference``, timed through the wrapper, on
     ready operands and by CUDA-graph replay; after the model's final LN,
     against ``float64_chain`` on 16 search crops of the main-path clip; at
     the f32 ``small`` shape (``tf32x3``); in float32 (``tf32x3``) at the
     flagship (the shipped weights cast, 12 blocks, the real tokens) and at
     ``small`` (4 blocks), each held to the twin at ``F32_ATOL`` and timed
     the same ways beside ``simt`` by name (its max|d| too), the library
     with TF32 off, and three bounds (f32 FMA, split TF32, bytes);
   * the two attention kernels through ``ops/attention.py::flash_attention``
     (its choice of kernel and variant is printed and asserted):
     ``attention_single`` at the serving shape (48, 320, 64) bf16 (``mma``)
     and at the ``small`` preset's f32 shape (``tf32x3``), ``attention_flash``
     at (3, 1088, 64) bf16 (``mma``) and f32 (``tf32x3``) and at lengths
     that are no multiple of its key block, the dry run's 20 f32 tokens,
     held to ``attention_reference``; at the two bf16 shapes and the
     ``small`` f32 one also one launch on ready operands, the kernel's
     device time from a CUDA-graph replay, and the ``simt`` variant the same
     way, beside the bound (f32: both the FMA one and the split-TF32 one);
     ``multihead_attention`` on the chunks of a (16, 320, 576) qkv buffer
     beside the copy-then-launch path it replaced;
   * the NV12-to-tokens kernel (``ops/fused_prep_embed.py``, phase 3c)
     for a window inside the frame, one hanging off its edge, a banded
     1080p frame, and the geometry the kernel works out itself (a
     half-to-even tie of the band origin, a frame smaller than the band, a
     window larger than it, the band's corner), against both modes of its
     plain version (float32 1e-4 absolute; bf16 one ulp at the largest
     plain value) at every shape: the flagship in bf16 (``mma``, its tokens
     bit-equal by sha256 to the build before the float32 redesign) and in
     float32, the ``small`` and corr-tiny presets in float32 (``tf32x3``,
     and ``simt`` by name), the bf16 widths 48, 96, 160, 384 and 768
     (zero-padded, several clusters a token tile above 256); one call on
     ready parameters must be one device activity in both dtypes
     (``torch.profiler``); each shape timed by CUDA-graph replay (``tf32x3``
     and ``simt`` in turns) beside the plain version, the unfused chain
     ``preprocess_nv12`` -> ``embed_search`` (no single library call
     computes it) and the bound (float32 at split TF32's rate);
   * head dims no kernel takes as they are, zero-padded: attention at 4,
     12, 48 and 96 in bf16 and float32, the encoder and block kernels at D
     192 with dh 48 and 96 (bf16) and 24 and 12 (float32, ``tf32x3``: 24
     as it is, 12 padded to 16), against the plain twins at the tolerances
     of the phases above;
   * the one-block kernel (``ops/vit_block.py::block``) at (1, 320, 192) and
     (16, 320, 192) bf16 (``mma``, timed as the encoder is) and the
     ``small`` float32 shape against ``block_reference`` (which must launch
     nothing), in float32 (``tf32x3``) at (16, 320, 192) and (16, 80, 96)
     timed as kernel 1's float32 cases are, its gradients against the
     twin's, and its path: the
     flagship's 12 blocks chained through ``models/vit.py::_block(fused=True)``
     at B=16 (``mma``), forward and under a gradient;
4. unbatched path: ``entry()`` on the flagship, ``init`` on a 1080p NV12
   frame, then ``update_packed`` steps over a moving-target clip; every
   output finite, the encoder launch count equal to the number of steps,
   every one of them ``mma``; the first steps run free against the same
   steps run by the port on the CPU, and beside that each of them again on
   the card from the CPU's state before it; the f32 ``small`` preset
   against the CPU over the whole clip, then compiled (``small_jit``:
   ``update_packed_jit``, what the app's ``--model small`` runs, 30 steps
   each from the CPU's state, kernel 1 ``tf32x3`` once a step inside the
   replays, the device ms a step); the ``small`` architecture in JAX's
   default dtype (``small_bf16_phase``: D 96, head dim 48, bf16, the
   shipped weights cast), where the kernels run zero-padded (``mma`` at D
   128, head dim 64): kernels 1 and 2 at (1, 80, 96) x 4 and (16, 80, 96)
   on real tokens and 3 and 4 at (32, 80, 48) and (2, 1088, 48), each
   against its plain version and timed beside the library and the bound
   (``simt`` by name beside 3 and 4), kernel 1 after the final LN against
   the float64 chain on 128 crops, kernel 5 at D 96 (clusters of 3); then
   its path with the counts zeroed before each part: 30 compiled steps from
   the CPU's state, 5 ticks of a 16-slot engine (slots 0-2 against the CPU
   engine from the card's state), the 4 blocks through
   ``_block(fused=True)`` at B=16, 5 ``update_packed(fused_prep=True)``
   steps beside the plain route, 2 ticks of a 1-slot engine at a 512-pixel
   search (kernel 4); ``python -c "import chip_smoke as c;
   c.small_bf16_alone()"`` runs it alone;
   then the same clip through ``update_packed(fused_prep=True)`` (every
   step beside the plain-route step from the same state and the first
   steps beside the port's CPU run; launches of the fused kernel = steps),
   and a few steps on the clip converted to RGB and to YUY2 beside the
   NV12 ones; then kernel 5's paths (``prep_paths_phase``): the ``small``
   preset as shipped through ``scan.update_scan_pool(fused_prep=True)``
   (compiled) and ``update_packed(fused_prep=True)``, corr-tiny eagerly, a
   D-768 bf16 model (12 heads, depth 2, seeded weights) compiled, every
   step from the CPU's state, held to the CPU and to the plain route,
   kernels 1 and 5 counted by variant; ``python -c "import chip_smoke as
   c; c.prep_alone()"`` runs phase 3c and these paths alone; then the
   widths past the resident LN products (``wide_phase``, alone: ``python
   -c "import chip_smoke as c; c.wide_alone()"``): the wide LN form named
   where the rule keeps the resident one (bf16 D 768 prenormed, with one
   and two warpgroups and every N tile the ring builds; float32 D 512 and
   192 streamed; batch 1 and 16) bit-equal to it; the flagship's and
   ``small``'s kernel 1 / 2 / 5 outputs bit-equal by sha256 to the build
   before the streamed form (``FLAGSHIP_SHA256``), and bf16 kernels 1 and
   2 at ViT-L's and ViT-H's widths to the build before the prenormed form
   (``WIDE_SHA256``); a ViT-L-width model (D 1024, 24
   blocks, 16 heads, seeded weights) with kernel 1 at (1, 320, 1024) x 24
   in bf16 (``mma``, prenormed, after the final LN against the float64
   chain) and float32 (``tf32x3``, streamed, beside ``simt`` by name over a
   few launches) and kernel 2 at (16, 320, 1024) in both, each timed beside
   the plain twin, the library and the bound; a ViT-H-width model (D 1280,
   16 heads of 80, depth 4) with kernel 1 against its twin and kernel 5 at
   D 1280 in both dtypes timed; then their paths, the counts set to 0
   before each part: ViT-L ``init`` and 3 compiled ``update_packed_jit``
   steps in bf16 and float32 from the CPU's state (kernel 1 once a step, no
   ``simt``), a 16-stream ``multi.update_streams`` tick (kernel 3, streams
   0-1 against the CPU), the 24 blocks through ``_block(fused=True)`` at
   B=16 (kernel 2, equal to kernel 1), ViT-H through
   ``update_packed(fused_prep=True)`` in both dtypes (kernels 5 and 1);
   then head dims above 128 and patches above 32 (``heads_patch_phase``,
   alone: ``python -c "import chip_smoke as c; c.heads_patch_alone()"``):
   kernels 3 and 4 at head dims 136, 192 and 256 in both dtypes (the
   panel kernels; the plan's route and the other by name, float32 also at
   every other G, timed beside ``scaled_dot_product_attention`` and the
   bound), Model A's kernel 1 and 2 outputs in both dtypes bit-equal by
   sha256 to the recorded builds' (``WIDE_SHA256``; float32: the build
   before the float32 panel attention's redesign), kernels 1 and 2 at
   head dim 192 (D 768, 4 heads) and on Model A (ViT-L's width and depth
   in 4 heads of 256, seeded: kernel 1 at (1, 320, 1024) x 24, bf16 after
   the final LN against the float64 chain, kernel 2 at (16, 320, 1024),
   timed), kernel 5 at patch 48 and 64 (K in pieces of patch rows; both
   modes, timed); then their paths, the counts set to 0 before each part:
   Model A's compiled steps in both dtypes, its blocks through
   ``_block(fused=True)``, 3 ticks of a 16-slot engine (kernel 4) and 3
   float32 train steps at depth 2 (kernel 4), each against the CPU, and
   Model B (the flagship at patch 64) through compiled and eager
   fused-prep steps in both dtypes (kernels 5 and 1);
5. serving path, full width: the flagship behind a 16-slot ``SlotEngine``
   and a ``TrackServer`` on loopback; 4 ``TrackClient`` threads ``init``
   and ``update`` 10 frames each of seeded 1080p NV12 clips; an injected
   device fault must surface at its client and be recovered from; then 30
   engine ticks with all 16 slots live, timed.  Checks: results finite,
   IoU to the drawn boxes, the attention kernel launched exactly depth x
   ticks times, ``recover()`` restoring the snapshotted state, and against
   the port's CPU engine: the first served frame of clients 0-2, then
   slots 0-2 of the first 3 engine ticks with the CPU engine given the
   card's state before each tick.
   Timed only: the upload of one tick's frames, and the encoder at B=16 by
   both routes;
6. long-sequence paths: the flagship width with a 512-pixel search crop
   (S = 1088, seeded random weights) behind a 1-slot ``SlotEngine``, whose
   attention goes through ``attention_flash``, and unbatched through the
   encoder kernel, each step against the CPU's from the card's state;
7. training: the flagship's width and depth in float32, batch 16, 5
   (compiled) ``train_step`` s from the shipped weights on seeded crops (a bright
   textured square on noise) beside the port's CPU run of the same steps;
   the loss must fall; attention-kernel launches counted;
8. the tracker app, end to end, in this process through
   ``app/main.py::run`` (each run's fps, track p50 and draw ms from the
   app's own telemetry printed beside the card line):
   a. the flagship, 60 headless frames of 1080p NV12 on the card, every row
      TRACKING and kernel 1 launched once per update the app made (its
      auto-init update and one a frame); the same argv with ``--cpu`` for 20
      frames: the first 3 rows free-running within 2 px / 0.02, the card's
      mean IoU with the drawn boxes at most 0.05 below the CPU's; then
      ``--model small`` for 30 frames: kernel 1 launched once an update, all
      ``tf32x3``;
   b. corr-tiny, the default argv (rgb 640x512, 60 frames), on the card and
      with ``--cpu`` on the same seeded weights: every row's state equal,
      the first rows within 1e-2 px / 1e-4; and every one of the 60 steps
      again on the card from the CPU's state before it, within 1e-2 px /
      1e-4 (run free, two float32 trajectories of this tracker part: its
      sub-cell offsets double a difference about every frame, PERF.md §6);
   c. ``--objects 3 --exclusive`` (corr-tiny) ends ``TRACKING 3 OF 3``; with
      ``small`` the attention kernel launched depth x updates times;
      ``--pipelined`` rows, shifted by one, equal (b)'s card rows;
   d. the HUD on the card: ``render_hud``, ``yuy2_to_rgb`` +
      ``render_hud`` and ``render_hud_luma`` on 1080p frames for three
      HudParams, uint8-equal to the CPU's; ``resize_static`` within 1 level;
   e. a fault soak (corr-tiny nv12, transport and device faults) ends
      TRACKING, its multi-object twin re-creates the backend and ends
      ``TRACKING 3 OF 3``; a 10-frame ``--record`` y4m with
      ``--display-scale`` reads back at the display size (no cv2);
9. train and score, through the two scripts' ``run(argv)`` (the body of
   their ``main``, which returns its report beside the exit code):
   a. ``scripts/train_synthetic`` (the compiled ``train_scan``): the
      flagship at full width and depth in float32 (TF32 off) from the
      shipped weights, batch 16, a 128-sample dataset (seed 0, v1), 20
      steps; every loss finite, attention kernel
      4 launched 12 times a step and nothing else, the saved npz equal to
      the final parameters through ``load_npz``; the first 5 steps again on
      the CPU from the same dataset and CPU generator, the losses within
      phase 7's relative bound; the host's data seconds and samples/s;
   b. ``scripts/eval_tracking`` (its compiled per-frame update): the
      shipped flagship (bf16) on the
      independent world, ``basic`` and ``occlusion``, 2 sequences of 150
      frames at 640x512; kernel 1 launched once an update and nothing else;
      mean / min IoU, mean confidence, updates/s; the first 20 frames of
      each sequence on the CPU: the first 3 free-running and all 20 from
      the CPU's state within 2 px / 0.02; ``--objects 2`` (30 frames):
      attention kernel 3 launched 12 times a batched update; ``--preset
      small`` for 20 frames: kernel 1 once an update, all ``tf32x3``; a
      20-frame eval of the checkpoint just trained;
   c. the GFLOP of one flagship 1080p NV12 update (``utils/flops.py``) and
      its MFU at phase 4's median step time against the H100's dense bf16
      peak;
10. BASELINE config 5 and the host runtime, scripts and checkpoints:
   a. ``tracker/scan.py::update_scan_hud_pool``: the shipped flagship on a
      pool of 4 synthetic 3840x2160 NV12 frames, 200 updates, the luma HUD
      composited on the device after each; uhd fps; kernel 1 (``mma``)
      launched exactly once a frame and nothing else; the whole call under
      ``torch.cuda.set_sync_debug_mode("error")`` (nothing read back); the
      pool byte-equal before and after; the display byte-equal to the CPU's
      composite of the last frame with the card's final box and
      confidence, and differing from that frame in a small share of its
      pixels; 10 pool frames stepped from the CPU's state within 2 px /
      0.02;
   b. ``runtime/``: built from the checkout's own ``framering.cpp`` by
      g++ (its build time); ``nv12_to_rgb`` / ``yuy2_to_rgb`` bit-equal to
      the port's op at 1080p, 4K and an odd size, their ms with 8 threads;
      the ring's drop-oldest semantics over 10,000 pushes; ``synth_nv12``
      frames/s at 1080p;
   c. the scripts through ``main(argv)``, each exiting 0 with its JSON
      line: ``profile_scan --reps 5``, ``profile_streams --reps 5`` (each
      variant one compiled program, ``scan.scanned``; each
      with the device's ms from ``torch.profiler``; every marginal ms a
      step, a slope of device time, positive and within MARGINAL_SETUP /
      MARGINAL_NOISE of its device ms a step), ``bench_serve`` (4
      streams x 30 frames, corr-tiny), ``soak`` (1500 corr-tiny frames,
      faults every 397 / 601 / 251 frames, every check holding),
      ``export_vittrack_onnx`` (the graph holds every shipped tensor) and
      ``import_vittrack_onnx`` (a PyTorch-layout file of the shipped
      flagship gives the same tensors back);
   d. ``save_tree`` / ``load_tree`` of the card's final TrackState and a
      flagship AdamW state, bit-equal after loading onto the card;
11. ``parallel/`` over ranks that share this card (one process a rank,
   ``parallel/launch.py``; gloo for more than one rank, as NCCL refuses two
   ranks on one device; the backend printed), and the last four scripts:
   a. ``entry.dryrun_multichip(8)``: JAX's dry run at its 4x2 mesh, JAX's
      bounds and the port's tp bound; attention launched 12 times a train
      step and twice a serving tick on every rank;
   b. the shipped flagship (bf16) behind a 16-slot ``SlotEngine`` on phase
      5's 1080p NV12 clips, on a 1x1 NCCL mesh (bit-equal to one engine),
      2x1 and 1x2 (tick by tick from one engine's state, phase 5's bounds,
      MESH_TIE_FLIPS); kernel 3 launched depth x ticks times on every rank;
      ``SlotEngine.recover()`` and ``ShardedStreamTracker.recover()``
      restore their snapshots;
   c. ``train_synthetic --mesh 2x2`` (the eager scan, by name): the
      flagship in float32, 5 steps,
      batch 16, phase 9a's 128 samples; losses within phase 7's bound of
      one process, kernel 4 launched 12 times a step on every rank, the
      saved npz equal to the gathered params;
   d. ``ab_fused_prep``, ``ab_grouped_head``, ``probe_int8`` and
      ``probe_relay_fetch`` through ``main(argv)`` with short arguments
      (their timed loops compiled programs),
      each exiting 0 with its JSON line (kernel 5 launched by the first,
      the int8 product exact in the third);
12. the port's bench, ``gstreamer_vit_tracker_tpu_torch/bench.py``, through
   ``run(argv)`` in this process with every config on and the counts cut
   (``BENCH_ARGV``): exit 0, no ``*_error`` key, every key of its line
   present, every number finite and positive; each config's kernel
   launches exactly ``bench_launches`` (kernel 1 once a tracked frame of
   the headline, loop, uhd, rgb, yuy2 and ingest configs, kernel 3 depth
   times a batched step of the stream, object and serve configs, warm-up
   runs included, nothing else), and the process's counters equal to
   their sum; its line and seconds;
13. the compiled entry points (``utils/graph.py``, CUDA graphs) against
   the eager functions on the same inputs, each equal bit for bit, each
   wrapper capturing once a key at most, the kernels launched exactly once a step, no
   host sync inside the replays (sync debug mode "error"):
   ``init_jit`` + ``update_packed_jit`` on the flagship, 1080p NV12, 30
   steps (a result held from a call unchanged by the next); 16 engine slot
   writes and 20 ticks at 16 slots; ``update_scan_pool`` on the 16-frame
   pool (48 steps); ``update_scan_hud_pool`` at 4K (12 frames, state,
   display and scores); ``init_objects_jit`` + 20 ``update_objects_jit``
   steps (8 targets, exclusive, template update on); then for each, eager
   against compiled: host wall ms a step, device busy ms a step
   (``torch.profiler``) and the idle share, with the card line;
14. compiled training (``train/step.py`` on ``utils/graph.py``): the
   flagship in float32 at phase 7's batch of 16 from the shipped weights,
   20 compiled ``train_step`` s and one 20-step compiled ``train_scan``
   (augmentation on, a seeded CPU generator, phase 9a's dataset), each
   against two eager runs with cuDNN's deterministic algorithms: bit for
   bit where the eager runs are (else within their spread,
   ``TRAIN_JIT_SPREAD``), the generator left as the eager scan leaves it,
   one capture a key, kernel 4 launched 12 times a step and nothing else,
   no host sync inside the replays; then, with the default algorithms,
   eager against compiled: host wall ms, device busy ms, the idle share
   and samples/s a step, with the card line; kernel 4 at the training
   shape (48, 320, 64) float32 (``tf32x3``) against its plain version,
   timed beside the ``simt`` design it replaced and
   ``scaled_dot_product_attention``, and its device time inside the
   replayed step;
15. the programs under a mesh compiled (``utils/graph.py``: CUDA graphs
   with the NCCL collectives inside the replay): on a 1x1 NCCL mesh in this
   process, the shipped flagship behind a ShardedStreamTracker and a mesh
   SlotEngine at 16 slots (16 slot writes, 20 ticks each) and 5 flagship
   float32 ``train_step`` s at phase 7's batch, each compiled against its
   eager mesh body called by name: bit for bit, one capture a key, kernel
   3 launched 12 times a tick and kernel 4 12 times a step and nothing
   else, no host sync inside the replays; eager against compiled host
   wall, device busy ms and idle share a tick and a step; a body holding
   one ``dist.all_reduce`` on the one-rank NCCL group captured and
   replayed 20 times, equal to eager; a mesh of gloo groups with CUDA
   tensors raising before any launch; the app's compiled HUD draws
   byte-equal to the eager ones; the two capture modes tried on one NCCL
   rank.  With two or more cards visible (not on one card): the same on
   NCCL ranks with a card each (four cards: the tracker at 4x1, the
   engine and the train step at 2x2) and ``entry.dryrun_multichip``
   compiled within JAX's bounds.  It prints which part it ran;
16. prints the card line, then one ``{"kernels": [...]}`` line, then the
   result line ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package.  Float32 products and
convolutions run without TF32 on the card (both switches set below).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from gstreamer_vit_tracker_tpu_torch.utils.flops import (H100_BF16_FLOPS,
                                                         H100_F32_FLOPS,
                                                         H100_HBM_BYTES_S,
                                                         H100_TF32_FLOPS)

MAIN_STEPS = 30
CPU_CHECK_STEPS = 3
TIMING_ITERS = 100

SERVE_SLOTS = 16
SERVE_CLIENTS = 4
CLIENT_FRAMES = 10
ENGINE_TICKS = 30
LONG_SEARCH = 512             # S = 64 + 1024 = 1088: past attention_single
LONG_TICKS = 3
FRAME_H, FRAME_W = 1080, 1920

# Kernel against twin, flagship bf16.  The residual stream of the trained
# flagship reaches |x| ~ 200, where one bf16 ulp is 1.0, so another
# summation order alone moves the encoder output by an ulp or more there:
# it is held to 1% of its largest value (two ulps at the top).
ENC_REL_TOL = 0.01            # max|kernel - twin| / max|twin|
# After the final LN (|y| up to 16, where one bf16 ulp is 0.0625) the twin
# itself is 0.047-0.078 from exact arithmetic (ops/vit_block.py::
# float64_chain, its own rounding points), so the kernel is held to exact
# arithmetic as the twin is, on LN_CROPS search crops of the main-path clip
# (frames 1-16 around their drawn boxes): on each, its largest distance
# from the float64 chain at most the twin's plus LN_MARGIN (one bf16 ulp in
# [4, 8)); over all of them, its mean distance at most LN_MEAN_RATIO x the
# twin's.  The old single-crop bound, 0.05 from the twin (LN_ATOL_OLD, under
# one ulp at the output's magnitude), is printed beside, not asserted.
LN_CROPS = 16
LN_MARGIN = 0.03125
LN_MEAN_RATIO = 1.10
LN_ATOL_OLD = 0.05
F32_ATOL = 1e-3
# Attention kernels against attention_reference: float32 1e-5 absolute;
# bf16 one output ulp at the largest plain value (both sides round an f32
# result to bf16 once, so they differ by at most one step there).
ATT_F32_ATOL = 1e-5
ATT_BF16_REL = 2.0 ** -7      # max|kernel - plain| / max|plain|
# The card against the port's CPU run, flagship bf16 (as in the unbatched
# phase): bbox within 2 px, score within 0.02.
CPU_BOX_TOL, CPU_SCORE_TOL = 2.0, 0.02
# The NV12-to-tokens kernel against its plain version: float32 1e-4
# absolute; bf16 one output ulp at the largest plain value (the pixels are
# bit-equal, the embed sum runs in another order and is rounded once).
PREP_F32_ATOL = 1e-4
PREP_BF16_REL = 2.0 ** -7
# Kernel 5's float32 shapes (tf32x3, and simt by name) and its bf16 widths
# (seeded weights at the small preset's crop geometry: search 128, patch
# 16), each held on the seven window cases of phase 3c and timed.
PREP_F32_PRESETS = ("vittrack-t", "small", "corr-tiny")
PREP_BF16_WIDTHS = (48, 96, 160, 384, 768)
# The flagship's bf16 tokens on the banded 1080p case of phase 3c (the
# frame of default_rng(11), the window (1500, 700, 64, 64), the shipped
# weights) as the build of commit a85bea4 (before the float32 route's
# redesign) made them on an H100: sha256 of their bf16 bits.  The bf16
# route's tiling at D 192 did not change, so they stay bit-equal.
PREP_BF16_FLAGSHIP_SHA256 = (
    "6b7a4bce31b550a6fb789288ea9839528ad0bf2b989d42aae8a3bbed45f0c34b")
# An RGB frame is the NV12 frame converted and rounded to uint8, so its crop
# differs in the last bits of every pixel (0.028 in score on the CPU): held
# to 4 px and 0.06.  YUY2 carries the NV12 bytes (chroma rows repeated).
RGB_BOX_TOL, RGB_SCORE_TOL = 4.0, 0.06
# The fused route against the plain route, flagship bf16, step by step from
# the same state: the fused kernel keeps the colour mix and the normalise in
# float32 where the plain chain rounds every stage to bf16, so the tokens
# differ by one or two bf16 ulps (0.19 at |token| 20) and the bf16 heads'
# score by a few hundredths (0.028 in 30 steps, first run on the card).
ROUTE_BOX_TOL, ROUTE_SCORE_TOL = 2.0, 0.05
FORMAT_STEPS = 4
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 16, 5, 1e-4
TRAIN_LOSS_RTOL = 1e-3        # card vs CPU loss, float32, TF32 off


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def print_ptxas(source: str, log_path: str) -> None:
    """One line a kernel from ``nvcc -Xptxas -v``'s log: its (mangled) name,
    registers, and stack frame and spills."""
    kernel, spills = "?", ""
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "spill" in line:
                spills = line
            elif "registers" in line:
                print(f"ptxas {source}: {kernel}: "
                      f"{line.split(':', 1)[1].strip()}; {spills}")


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


def nv12_clip(n: int, seed: int = 0, h: int = FRAME_H, w: int = FRAME_W,
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


def _iou(a, b) -> float:
    ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


GRAPH_LAUNCHES = 20
# What timed_kernel measures, as rows 1 and 2 of the kernels line give it.
TIMED_KEYS = ("variant", "max_abs_err", "ms", "ms_again", "launch_ms",
              "device_us", "device_us_again", "plain_ms", "library_ms",
              "library_device_us", "bound_ms", "bound_by")
# ... and of a float32 case, with simt beside it and the three bounds.
TIMED_F32_KEYS = TIMED_KEYS + ("simt_max_abs_err", "simt_launch_ms",
                               "simt_device_us", "bound_fma_ms",
                               "bound_split_tf32_ms")


def only(variant: str, n: int) -> dict:
    """``vit_block.VARIANT_LAUNCHES`` as it reads when ``variant`` was
    launched ``n`` times and no other variant was (every key of the dict,
    whichever variants the checkout has)."""
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    return {v: n if v == variant else 0 for v in vit_block.VARIANT_LAUNCHES}


def zero_variants() -> None:
    """Every variant's launch count set to 0."""
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    vit_block.VARIANT_LAUNCHES.update(
        dict.fromkeys(vit_block.VARIANT_LAUNCHES, 0))


def graph_us(launch, n: int = GRAPH_LAUNCHES) -> float:
    """Device time of one ``launch()`` in microseconds: ``n`` of them
    captured into a CUDA graph and replayed, so that no host time to enqueue
    them is read as the kernel's (the gaps between graph nodes stay in)."""
    launch()
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                launch()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, iters=20, warmup=3) / n * 1e3


# ---------------------------------------------------------------------------
# Phase 3a: the encoder kernel (kernel 1) and its yardsticks
# ---------------------------------------------------------------------------

def check_kernel(what: str, got, twin, dtype, held: bool = True) -> float:
    """``got`` against its plain twin: float32 ``F32_ATOL``; bf16
    ``ENC_REL_TOL`` of max|twin|.  Returns max|d|.  ``held=False``: bf16
    printed only, where the caller holds the kernel to exact arithmetic
    instead (``final_ln_check``)."""
    torch.cuda.synchronize()
    if got.dtype != dtype or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: wrong type or non-finite values")
    err = (got.float() - twin.float()).abs()
    scale = twin.float().abs().max().item()
    tol = F32_ATOL if dtype == torch.float32 else ENC_REL_TOL * scale
    held = held or dtype == torch.float32
    print(f"{what} vs twin: max|d| {err.max().item()} (max|twin| {scale}, "
          f"mean|d| {err.mean().item():.3e}, tolerance {tol:.4g}"
          f"{'' if held else ', not asserted: final_ln_check holds it'})",
          flush=True)
    if held and not err.max().item() <= tol:
        raise AssertionError(f"{what} disagrees with its twin: "
                             f"{err.max().item()} > {tol}")
    return err.max().item()


def timed_kernel(what, x, blocks, heads, stacked, wrapper,
                 simt_iters: int = TIMING_ITERS, held: bool = True) -> dict:
    """Kernel 1 (``stacked``) or kernel 2 on (x, blocks): the wrapper,
    which must launch the plan's variant once (bf16 ``mma``, float32
    ``tf32x3``), held to the plain twin; then, in turns, the time through
    the wrapper, of one launch on ready operands, of the plain twin and of
    the library yardstick (CUDA events), the kernel's and the library's
    device time a launch (CUDA-graph replay), and the bound.  In float32
    also ``simt``, the design ``tf32x3`` replaced, by name (its max|d| and
    its times the same way), the library with TF32 off, and three bounds:
    the products as f32 FMA, as three TF32 products a product (the bound
    of ``tf32x3``, whose operations these are), and the bytes.
    ``simt_iters``: the launches ``simt`` is timed over (a few where it
    takes a tenth of a second a launch; 0: none, where ``simt`` does not
    take the shape, a head dim above 128); ``held``: ``check_kernel``'s."""
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    f32 = x.dtype == torch.float32
    hidden = blocks[0]["mlp1"]["kernel"].shape[1]
    variant = vit_block._plan_for(x, heads, hidden).variant
    flat = [blk[m][f] for blk in blocks for m, f in vit_block._FIELDS]
    weights = (vit_block._stack(flat, len(blocks)) if stacked
               else [t.contiguous() for t in flat])
    twin = vit_block.encoder_reference(x, blocks, heads)
    before = dict(vit_block.VARIANT_LAUNCHES)
    got = wrapper()
    if vit_block.VARIANT_LAUNCHES != dict(before,
                                          **{variant: before[variant] + 1}):
        raise AssertionError(f"{what}: the wrapper did not launch {variant} "
                             f"once")
    res = {"variant": variant, "max_abs_err": check_kernel(
        f"{what} {variant}", got, twin, x.dtype, held)}
    out_m, launch = vit_block.prepared(x, weights, heads, stacked)
    launch()
    torch.cuda.synchronize()
    if not torch.equal(out_m, got):
        raise AssertionError(f"{what}: prepared() and the wrapper differ")
    simt = f32 and variant != "simt" and simt_iters > 0
    if simt:
        out_s, launch_simt = vit_block.prepared(
            x, weights, heads, stacked, chosen=vit_block.Plan("simt"))
        launch_simt()
        res["simt_max_abs_err"] = check_kernel(f"{what} simt (by name)",
                                               out_s, twin, x.dtype)

    def library():
        return library_encoder(x, blocks, heads)

    if f32 and (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
        raise AssertionError("float32 timings need TF32 off")
    res["ms"] = cuda_ms(wrapper)
    res["launch_ms"] = cuda_ms(launch)
    if simt:
        res["simt_launch_ms"] = cuda_ms(launch_simt, iters=simt_iters,
                                        warmup=min(10, simt_iters))
    res["plain_ms"] = cuda_ms(lambda: vit_block.encoder_reference(
        x, blocks, heads), iters=20, warmup=3)
    res["library_ms"] = cuda_ms(library)
    res["ms_again"] = cuda_ms(wrapper)
    res["device_us"] = graph_us(launch)
    if simt:
        res["simt_device_us"] = graph_us(launch_simt,
                                         min(GRAPH_LAUNCHES, simt_iters))
    res["device_us_again"] = graph_us(launch)
    res["library_device_us"] = graph_us(library)
    flops, nbytes = encoder_cost(x, blocks, heads)
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    bound_note = ""
    if f32:
        t_fma = flops / H100_F32_FLOPS * 1e3
        t_split = 3 * flops / H100_TF32_FLOPS * 1e3
        res["bound_fma_ms"] = max(t_fma, t_bytes)
        res["bound_split_tf32_ms"] = max(t_split, t_bytes)
        t_ops = t_fma if variant == "simt" else t_split
        bound_note = (f"; f32 FMA {t_fma * 1e3:.2f} us, split TF32 (3 x "
                      f"{flops / 1e9:.4f} GFLOP at "
                      f"{H100_TF32_FLOPS / 1e12:.0f} TFLOP/s) "
                      f"{t_split * 1e3:.2f} us")
    else:
        t_ops = flops / H100_BF16_FLOPS * 1e3
    res["bound_ms"] = max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    simt_note = (f", simt {res['simt_launch_ms']:.4f}" if simt else "")
    simt_dev = (f", simt {res['simt_device_us']:.2f}" if simt else "")
    lib_name = ("matmul + scaled_dot_product_attention, TF32 off" if f32
                else "matmul + scaled_dot_product_attention")
    print(f"{what} ms (CUDA events, mean of {TIMING_ITERS}): through the "
          f"wrapper {res['ms']:.4f} / {res['ms_again']:.4f} (before / after "
          f"the others), one launch on ready operands {variant} "
          f"{res['launch_ms']:.4f}{simt_note}, plain "
          f"{res['plain_ms']:.4f}, library ({lib_name}) "
          f"{res['library_ms']:.4f}; device us a launch (CUDA graph of "
          f"{GRAPH_LAUNCHES}): {variant} {res['device_us']:.2f} / "
          f"{res['device_us_again']:.2f}{simt_dev}, library "
          f"{res['library_device_us']:.2f}; bound "
          f"{res['bound_ms'] * 1e3:.2f} us by {res['bound_by']} "
          f"({flops / 1e9:.4f} GFLOP -> {t_ops * 1e3:.2f} us, "
          f"{nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us{bound_note}) "
          f"| {card_line()}", flush=True)
    return res


def f32_cases(dev, cfg, params, x, small, sparams):
    """The float32 cases of kernels 1 and 2 that ``timed_kernel`` times:
    (what, x, blocks, heads, stacked) for kernel 1 at the flagship (the
    shipped weights cast to float32, 12 blocks, the real tokens ``x``) and
    at the ``small`` preset (its shipped float32 weights, 4 blocks, seeded
    tokens), and for kernel 2 at batch 16 on block 5 of the flagship and
    block 1 of ``small`` (seeded tokens)."""
    from gstreamer_vit_tracker_tpu_torch.models import vit

    f32 = torch.float32
    gen = torch.Generator(device="cpu").manual_seed(0)
    fblocks = [vit.cast_params(bp, f32) for bp in params["backbone"]["blocks"]]
    sblocks = [vit.cast_params(bp, f32) for bp in sparams["backbone"]["blocks"]]
    xs = torch.randn((1, small.num_tokens, small.embed_dim),
                     generator=gen).to(dev)
    heads, sheads = cfg.num_heads, small.num_heads
    xb = (2.0 * torch.randn((SERVE_SLOTS,) + tuple(x.shape[1:]),
                            generator=gen)).to(dev)
    xsb = (2.0 * torch.randn((SERVE_SLOTS, small.num_tokens, small.embed_dim),
                             generator=gen)).to(dev)
    return {
        "encoder_flagship": (f"encoder {tuple(x.shape)} f32", x.float(),
                             fblocks, heads, True),
        "encoder_small": (f"encoder small {tuple(xs.shape)} f32", xs, sblocks,
                          sheads, True),
        "block_flagship": (f"block {tuple(xb.shape)} f32", xb, [fblocks[5]],
                           heads, False),
        "block_small": (f"block small {tuple(xsb.shape)} f32", xsb,
                        [sblocks[1]], sheads, False)}


def timed_f32(case) -> dict:
    """``timed_kernel`` on one of :func:`f32_cases` through its wrapper
    (``encoder`` or ``block``)."""
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    what, x, blocks, heads, stacked = case
    if stacked:
        def wrapper():
            return vit_block.encoder(x, blocks, heads)
    else:
        def wrapper():
            return vit_block.block(x, blocks[0], heads)
    return timed_kernel(what, x, blocks, heads, stacked, wrapper)


def entry_tokens(dev):
    """``entry()`` on the flagship and its encoder input: (the entry's
    step function, params, (state, frame), x (1, 320, 192) bf16, the
    template and search tokens of the entry frame)."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.entry import entry
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    cfg = PRESETS["vittrack-t"]
    fn, (params, state, frame) = entry(device=dev)
    window = pp.crop_window(state.bbox, cfg.search_factor)
    x_img = core._prep_nv12(frame, window, cfg.search_size, cfg)
    x_tok = vit.embed_search(params["backbone"], x_img[None], cfg)
    x = torch.cat([state.z_tok[None], x_tok], dim=1).contiguous()
    return fn, params, (state, frame), x


SMALL_JIT_STEPS = 30
SMALL_BOX_TOL, SMALL_SCORE_TOL = 1e-2, 1e-4   # as phase 4's eager small run


def small_jit(dev, card: str, dtype: str = "float32") -> dict:
    """The ``small`` preset's single-object path compiled, what the app's
    ``--model small`` runs: ``core.update_packed_jit`` on its shipped
    (float32) weights over the main path's 1080p NV12 clip, SMALL_JIT_STEPS
    steps, each on the card from the state the port's CPU run had before
    it (as phase 8's corr-tiny check) and held to the CPU's step; kernel 1
    launched once a step (the replays' launches counted), every launch the
    plan's variant, nothing else; then the device busy ms a step of the
    compiled step run free (``torch.profiler``).  ``dtype="bfloat16"``: the
    same architecture in JAX's default dtype (its weights cast at use),
    held to the CPU as the flagship's bf16 steps are (CPU_BOX_TOL,
    CPU_SCORE_TOL)."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    cfg = dataclasses.replace(PRESETS["small"], dtype=dtype)
    cpu = torch.device("cpu")
    box_tol, score_tol = ((SMALL_BOX_TOL, SMALL_SCORE_TOL) if dtype == "float32"
                          else (CPU_BOX_TOL, CPU_SCORE_TOL))
    path = weights.checkpoint_path("small")
    params = vittrack.with_grouped_head(weights.load_npz(path, cfg, device=dev))
    cparams = vittrack.with_grouped_head(weights.load_npz(path, cfg,
                                                          device=cpu))
    variant = vit_block.plan(1, cfg.num_tokens, cfg.embed_dim, cfg.num_heads,
                             int(cfg.embed_dim * cfg.mlp_ratio),
                             getattr(torch, dtype),
                             attention.card(dev)[1]).variant
    frames, boxes = nv12_clip(SMALL_JIT_STEPS + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    cst = core.init(cparams, frames[0], boxes[0], cfg, "nv12", cpu)
    zero_counts()
    worst_box = worst_score = 0.0
    for i in range(SMALL_JIT_STEPS):
        held = type(cst)(*(t.to(dev) for t in cst))
        _, gout = core.update_packed_jit(params, held, clip[i + 1], cfg,
                                         "nv12", dev)
        cst, cout = core.update_packed(cparams, cst, frames[i + 1], cfg,
                                       "nv12", cpu)
        gout, cout = gout.cpu().numpy(), cout.numpy()
        if not np.isfinite(gout).all():
            raise AssertionError("small compiled step: non-finite output")
        worst_box = max(worst_box, float(np.abs(gout[:4] - cout[:4]).max()))
        worst_score = max(worst_score, float(abs(gout[4] - cout[4])))
    counts = read_counts()
    by_variant = dict(vit_block.VARIANT_LAUNCHES)
    st = [core.init_jit(params, clip[0], boxes[0], cfg, "nv12", dev)]

    def step():
        st[0], _ = core.update_packed_jit(params, st[0], clip[1], cfg, "nv12",
                                          dev)

    t = traced_ms(step, JIT_TIMED, 1)
    print(f"small compiled (update_packed_jit, {dtype}, 1080p NV12): "
          f"{SMALL_JIT_STEPS} steps each from the CPU's state: max|d bbox| "
          f"{worst_box:.3e} px, max|d score| {worst_score:.3e} (tolerance "
          f"{box_tol} px, {score_tol}); launches {counts} "
          f"({by_variant}); run free: device busy ms a step (torch.profiler) "
          f"{t['device_ms']:.4f}, host wall {t['host_ms']:.4f}, activities "
          f"{t['activities']:.1f}, idle share {t['idle_share']:.3f} | {card}",
          flush=True)
    if counts != dict(counts, vit_encoder=SMALL_JIT_STEPS, vit_block=0,
                      attention_single=0, attention_flash=0,
                      fused_prep_embed=0) \
            or by_variant != only(variant, SMALL_JIT_STEPS):
        raise AssertionError(f"small compiled: launches {counts} "
                             f"{by_variant}, expected kernel 1 ({variant}) "
                             f"once a step")
    if worst_box > box_tol or worst_score > score_tol:
        raise AssertionError(f"small compiled step ({dtype}) disagrees with "
                             f"the CPU")
    return {"steps": SMALL_JIT_STEPS, "variant": variant, "launches": counts,
            "launches_by_variant": by_variant, "max_d_bbox_px": worst_box,
            "max_d_score": worst_score, **t}


def f32_alone() -> dict:
    """The four float32 cases of :func:`f32_cases`, timed, and
    :func:`small_jit`, on card 0 and nothing else: what the design in a
    checkout reads at these shapes.  Run from the root of a checkout:
    ``python -c "import chip_smoke as c; c.f32_alone()"``."""
    from gstreamer_vit_tracker_tpu_torch import device
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import weights

    dev = torch.device("cuda", 0)
    device.true_float32(dev)
    cfg, small = PRESETS["vittrack-t"], PRESETS["small"]
    sparams = weights.load_npz(weights.checkpoint_path("small"), small,
                               device=dev)
    _, params, _, x = entry_tokens(dev)
    card = card_line()
    print(f"f32 cases alone | {card}", flush=True)
    got = {k: timed_f32(c) for k, c in
           f32_cases(dev, cfg, params, x, small, sparams).items()}
    got["small_jit"] = small_jit(dev, card)
    print(json.dumps(got), flush=True)
    return got


SMALL_BF16_TICKS = 5          # 16-slot engine ticks of the small bf16 path
# Kernel 1 after the final LN at small bf16, held to LN_MEAN_RATIO and
# LN_MARGIN on SMALL_BF16_LN_FRAMES frames x the windows of
# SMALL_BF16_LN_SHIFTS (px) = 128 crops, the largest distance pooled over
# the crops.  At 4 blocks of D 96 a crop's distance from the float64 chain
# is a few one-ulp flips or none, so a mean ratio over 16 crops moves by a
# tenth with one flip, and one flip at |y| in [8, 16) is 0.0625 above a crop
# the twin gets exact, which the twin shows over the kernel as the kernel
# does over the twin; the phase prints both spreads (PERF.md, section 6).
SMALL_BF16_LN_FRAMES = 32
SMALL_BF16_LN_SHIFTS = ((0, 0), (30, 20), (-30, 20), (30, -20))
SMALL_BF16_PREP_STEPS = 5     # update_packed(fused_prep=True) steps
SMALL_BF16_LONG_TICKS = 2     # 1-slot ticks at a 512-pixel search (kernel 4)


def small_bf16_phase(dev, card: str) -> dict:
    """The ``small`` architecture in JAX's default dtype,
    ``dataclasses.replace(PRESETS["small"], dtype="bfloat16")`` (D 96, 2
    heads of 48, MLP 384, depth 4; the shipped weights cast at use): the
    shapes at which the kernels run zero-padded ("mma": D 96 -> 128, head
    dim 48 -> 64).

    Kernels against their plain versions, timed (``timed_kernel``,
    ``attention_case``: device us a launch in a replayed CUDA graph beside
    the plain version, the library and the bound): kernel 1 at (1, 80, 96)
    x 4 and kernel 2 at (16, 80, 96) on the real tokens of search crops of
    the main-path clip, each launched once as ``mma`` and held to the twin
    (``ENC_REL_TOL``), kernel 1 after the model's final LN against the
    float64 chain on 128 crops (``final_ln_check``'s bounds, the largest
    distance pooled over the crops; SMALL_BF16_LN_FRAMES says why); kernel 3
    at (32, 80, 48) and kernel 4 at (2, 1088, 48), ``mma`` padded to 64,
    against ``attention_reference`` beside ``simt`` by name; kernel 5
    (clusters of D / 32 = 3) against both modes of its plain version.

    The path, the counts set to 0 just before each part and read just
    after: ``core.update_packed_jit`` SMALL_JIT_STEPS times, each from the
    CPU's state (``small_jit``: kernel 1 once a step); a 16-slot
    ``SlotEngine`` (compiled tick) over SMALL_BF16_TICKS ticks of 1080p NV12,
    slots 0-2 of each held to the port's CPU engine given the card's state
    before the tick (kernel 3 depth times a tick); the 4 blocks chained
    through ``models/vit.py::_block(fused=True)`` at B=16 (kernel 2 4
    times, equal to kernel 1 bit for bit); SMALL_BF16_PREP_STEPS
    ``update_packed(fused_prep=True)`` steps, each beside the plain-route
    step from the same state (kernel 5 and kernel 1 once a step); a 1-slot
    engine at a 512-pixel search (seeded weights, S = 1040) for
    SMALL_BF16_LONG_TICKS ticks (kernel 4 depth times a tick), its head
    maps by the kernel route against the plain route.  Nothing falls back
    to a plain version or the CPU."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import vit, vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import attention
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block
    from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine
    from gstreamer_vit_tracker_tpu_torch.tracker import core, multi

    t_phase = time.perf_counter()
    bf16, cpu = torch.bfloat16, torch.device("cpu")
    cfg = dataclasses.replace(PRESETS["small"], dtype="bfloat16")
    d, heads, dh = cfg.embed_dim, cfg.num_heads, cfg.embed_dim // cfg.num_heads
    hidden = int(d * cfg.mlp_ratio)
    path = weights.checkpoint_path("small")
    params = vittrack.with_grouped_head(weights.load_npz(path, cfg, device=dev))
    cparams = vittrack.with_grouped_head(weights.load_npz(path, cfg, device=cpu))
    blocks = [vit.cast_params(p, bf16) for p in params["backbone"]["blocks"]]
    sms = attention.card(dev)[1]
    for b in (1, SERVE_SLOTS):
        chosen = vit_block.plan(b, cfg.num_tokens, d, heads, hidden, bf16, sms)
        print(f"small bf16 plan at batch {b}: {chosen}", flush=True)
        if (chosen.variant, chosen.pad, chosen.width) != ("mma", 64, 128):
            raise AssertionError(f"small bf16: expected mma padded to D 128 "
                                 f"and head dim 64, the plan is {chosen}")

    # Real tokens: the template of the clip's first frame and the search
    # crops of frames 1-32, each around its drawn box and three shifted
    # ones (the first 16 unshifted: kernel 2's batch).
    frames, boxes = nv12_clip(SMALL_BF16_LN_FRAMES + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    z0 = core.init(params, clip[0], boxes[0], cfg, "nv12", dev).z_tok
    crops = []
    for dx, dy in SMALL_BF16_LN_SHIFTS:
        for i in range(1, SMALL_BF16_LN_FRAMES + 1):
            box = torch.tensor(boxes[i], device=dev) + torch.tensor(
                [dx, dy, 0.0, 0.0], device=dev)
            win = pp.crop_window(box, cfg.search_factor)
            tok = vit.embed_search(params["backbone"], core._prep_nv12(
                clip[i], win, cfg.search_size, cfg)[None], cfg)
            crops.append(torch.cat([z0[None], tok], dim=1).contiguous())
    x1, x16 = crops[0], torch.cat(crops[:SERVE_SLOTS], 0)
    res = {"kernel1": timed_kernel(
        f"encoder small bf16 {tuple(x1.shape)} x {cfg.depth}", x1, blocks,
        heads, True, lambda: vit_block.encoder(x1, blocks, heads))}
    res["kernel1"]["final_ln"] = final_ln_check(cfg, params, blocks, crops, x1,
                                                pooled=True)
    res["kernel2"] = timed_kernel(
        f"block small bf16 {tuple(x16.shape)}", x16, [blocks[1]], heads, False,
        lambda: vit_block.block(x16, blocks[1], heads))
    res["kernel3"] = attention_case(
        SERVE_SLOTS * heads, cfg.num_tokens, dh, bf16, dev, "single", "mma",
        timed=True, lib_shape=(SERVE_SLOTS, heads, cfg.num_tokens, dh))
    res["kernel4"] = attention_case(heads, 1088, dh, bf16, dev, "flash", "mma",
                                    timed=True, lib_shape=(1, heads, 1088, dh))

    # Kernel 5 at D 96: clusters of 3 (D / 32), against both plain modes.
    chosen = fpe.plan(d, bf16)
    win = pp.crop_window(torch.tensor(boxes[1], device=dev), cfg.search_factor)
    del crops
    before = fpe.LAUNCHES
    got = fpe.nv12_search_tokens(params, *clip[1], win, cfg)
    torch.cuda.synchronize()
    if fpe.LAUNCHES != before + 1:
        raise AssertionError("small bf16: nv12_search_tokens did not launch")
    errs = []
    for mode in fpe.MODES:
        plain = fpe.nv12_search_tokens_reference(params, *clip[1], win, cfg,
                                                 mode)
        err = (got.float() - plain.float()).abs().max().item()
        tol = PREP_BF16_REL * plain.float().abs().max().item()
        errs.append(err)
        print(f"fused_prep_embed small bf16 (D {d}, {chosen}) vs plain mode "
              f"{mode!r}: max|d| {err:.3e} (tolerance {tol:.3e})", flush=True)
        if got.shape != plain.shape or not torch.isfinite(got.float()).all() \
                or not err <= tol:
            raise AssertionError(f"fused_prep_embed at D {d} disagrees with "
                                 f"its plain version ({mode})")
    res["kernel5"] = {"plan": list(chosen), "max_abs_err": max(errs)}

    # -- the path ----------------------------------------------------------
    res["step"] = small_jit(dev, card, "bfloat16")

    engine = SlotEngine(params, cfg, slots=SERVE_SLOTS, snapshot_every=0,
                        device=dev)
    cpu_engine = SlotEngine(cparams, cfg, slots=3, snapshot_every=0,
                            device=cpu)
    cpu_engine.occupied[:] = True
    clips = stream_clips(SERVE_SLOTS, SMALL_BF16_TICKS + 1)
    for k in range(SERVE_SLOTS):
        engine.init_slot(engine.alloc(), clips[k][0][0], clips[k][1][0])
    active = np.ones(SERVE_SLOTS, bool)
    zero_counts()
    worst_box = worst_score = 0.0
    for t in range(1, SMALL_BF16_TICKS + 1):
        ys = np.stack([clips[k][0][t][0] for k in range(SERVE_SLOTS)])
        uvs = np.stack([clips[k][0][t][1] for k in range(SERVE_SLOTS)])
        cpu_engine.state = type(engine.state)(
            *(leaf[:3].to(cpu, copy=True) for leaf in engine.state))
        packed = engine.step((ys, uvs), active)
        want = cpu_engine.step((ys[:3], uvs[:3]), np.ones(3, bool))
        if packed.shape != (SERVE_SLOTS, 5) or not np.isfinite(packed).all():
            raise AssertionError("small bf16 tick: non-finite or misshapen")
        worst_box = max(worst_box, float(np.abs(packed[:3, :4]
                                                - want[:, :4]).max()))
        worst_score = max(worst_score, float(np.abs(packed[:3, 4]
                                                    - want[:, 4]).max()))
    tick_counts = read_counts()
    print(f"small bf16 engine: {SMALL_BF16_TICKS} compiled ticks x "
          f"{SERVE_SLOTS} slots, 1080p NV12; slots 0-2 against the CPU engine "
          f"from the card's state: max|d bbox| {worst_box:.4f} px, max|d "
          f"score| {worst_score:.5f} (tolerance {CPU_BOX_TOL} px, "
          f"{CPU_SCORE_TOL}); launches {tick_counts}", flush=True)
    if tick_counts != dict(tick_counts, vit_encoder=0, vit_block=0,
                           attention_single=cfg.depth * SMALL_BF16_TICKS,
                           attention_flash=0, fused_prep_embed=0):
        raise AssertionError(f"small bf16 engine: launches {tick_counts}, "
                             f"expected kernel 3 depth times a tick")
    if worst_box > CPU_BOX_TOL or worst_score > CPU_SCORE_TOL:
        raise AssertionError("small bf16 engine tick disagrees with the CPU")
    res["tick"] = {"ticks": SMALL_BF16_TICKS, "launches": tick_counts,
                   "max_d_bbox_px": worst_box, "max_d_score": worst_score}

    zero_counts()
    x = x16
    for bp in blocks:
        x = vit._block(x, bp, heads, fused=True)
    block_counts = read_counts()
    by_variant = dict(vit_block.VARIANT_LAUNCHES)
    same = torch.equal(x, vit_block.encoder(x16, blocks, heads))
    print(f"small bf16 block path: {cfg.depth} blocks through "
          f"_block(fused=True) at B={SERVE_SLOTS}: launches {block_counts} "
          f"({by_variant}); equal to the encoder kernel bit for bit: {same}",
          flush=True)
    if block_counts != dict(block_counts, vit_encoder=0, vit_block=cfg.depth,
                            attention_single=0, attention_flash=0,
                            fused_prep_embed=0) \
            or by_variant != only("mma", cfg.depth) or not same:
        raise AssertionError("small bf16 block path: wrong launches or output")
    res["block_path"] = {"launches": block_counts}

    state = core.init(params, clip[0], boxes[0], cfg, "nv12", dev)
    zero_counts()
    states, rows = [state], []
    for i in range(SMALL_BF16_PREP_STEPS):
        state, out = core.update_packed(params, state, clip[i + 1], cfg,
                                        "nv12", dev, fused_prep=True)
        states.append(state)
        rows.append(out)
    prep_counts = read_counts()
    rows = torch.stack(rows).cpu().numpy()
    want = torch.stack([core.update_packed(params, states[i], clip[i + 1], cfg,
                                           "nv12", dev)[1]
                        for i in range(SMALL_BF16_PREP_STEPS)]).cpu().numpy()
    d_box = float(np.abs(want[:, :4] - rows[:, :4]).max())
    d_score = float(np.abs(want[:, 4] - rows[:, 4]).max())
    print(f"small bf16 fused route: {SMALL_BF16_PREP_STEPS} "
          f"update_packed(fused_prep=True) steps, launches {prep_counts}; vs "
          f"the plain-route step from the same state max|d bbox| {d_box:.4f} "
          f"px, max|d score| {d_score:.5f} (tolerance {ROUTE_BOX_TOL} px, "
          f"{ROUTE_SCORE_TOL})", flush=True)
    if prep_counts != dict(prep_counts, vit_encoder=SMALL_BF16_PREP_STEPS,
                           vit_block=0, attention_single=0, attention_flash=0,
                           fused_prep_embed=SMALL_BF16_PREP_STEPS) \
            or not np.isfinite(rows).all() or d_box > ROUTE_BOX_TOL \
            or d_score > ROUTE_SCORE_TOL:
        raise AssertionError("small bf16 fused route: wrong launches or "
                             "disagrees with the plain route")
    res["fused_prep"] = {"launches": prep_counts, "max_d_bbox_px": d_box,
                         "max_d_score": d_score}

    long_cfg = dataclasses.replace(cfg, search_size=LONG_SEARCH)
    lparams = weights.params_from_flat(random_flat(long_cfg, seed=7),
                                       long_cfg, device=dev)
    lframes, lboxes = nv12_clip(SMALL_BF16_LONG_TICKS + 1, seed=3,
                                box=(800, 400, 160, 120))
    lengine = SlotEngine(lparams, long_cfg, slots=1, snapshot_every=0,
                         device=dev)
    lengine.init_slot(lengine.alloc(), lframes[0], lboxes[0])
    window = pp.crop_window(lengine.state.bbox[0, 0], long_cfg.search_factor)
    x_img = core._prep_nv12(core._frame_on(lframes[1], "nv12", dev), window,
                            long_cfg.search_size,
                            multi._batched_cfg(long_cfg))[None]
    z = lengine.state.z_tok[0]
    maps_k = vittrack.forward(lparams, z, x_img, long_cfg, fused=False)
    maps_p = vittrack.forward(lparams, z, x_img, long_cfg, use_kernel=False,
                              fused=False)
    d_maps = max((a - b).abs().max().item() for a, b in zip(maps_k, maps_p))
    zero_counts()
    lrows = np.stack([lengine.step((lframes[t][0][None], lframes[t][1][None]),
                                   np.ones(1, bool))
                      for t in range(1, SMALL_BF16_LONG_TICKS + 1)])
    long_counts = read_counts()
    print(f"small bf16 long path (S = {long_cfg.num_tokens}, seeded "
          f"weights): head maps kernel route vs plain route max|d| "
          f"{d_maps:.4f} (tolerance 0.05); {SMALL_BF16_LONG_TICKS} ticks, "
          f"launches {long_counts}", flush=True)
    if long_counts != dict(long_counts, vit_encoder=0, vit_block=0,
                           attention_single=0,
                           attention_flash=cfg.depth * SMALL_BF16_LONG_TICKS,
                           fused_prep_embed=0) \
            or not np.isfinite(lrows).all() or not d_maps <= 0.05:
        raise AssertionError("small bf16 long path: wrong launches or output")
    res["long"] = {"seq": long_cfg.num_tokens, "launches": long_counts,
                   "maps_max_abs_err": d_maps}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"small bf16 phase: {res['seconds']:.1f} s | {card}", flush=True)
    return res


def small_bf16_alone() -> dict:
    """:func:`small_bf16_phase` on card 0 and nothing else, after the
    build.  Run from the root of a checkout: ``python -c "import chip_smoke
    as c; c.small_bf16_alone()"``."""
    from gstreamer_vit_tracker_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    card = card_line()
    print(f"small bf16 alone | {card}", flush=True)
    got = small_bf16_phase(dev, card)
    print(json.dumps(got), flush=True)
    return got


def final_ln_check(cfg, params, blocks, crops, x_entry,
                   pooled: bool = False) -> dict:
    """Kernel 1 after the model's final LN against the float64 chain on
    ``crops`` (the wrapper, ``mma``, asserted as the header says), and the
    old single-crop reading at ``x_entry`` beside ``LN_ATOL_OLD``.
    ``pooled``: the largest distance is bounded over all the crops (the
    kernel's largest at most the twin's largest plus LN_MARGIN) and not
    crop by crop, which is printed beside, with the spread of the mean
    ratio over these crops: its value on the first LN_CROPS (the
    flagship's count) and the 5 / 50 / 95 % points of 2000 draws of
    LN_CROPS crops and of all of them (SMALL_BF16_LN_FRAMES says why)."""
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    norm, heads = params["backbone"]["norm"], cfg.num_heads

    def after_ln(t):
        return vit.layer_norm(t, norm).float()

    def outputs(x):
        return {"twin": vit_block.encoder_reference(x, blocks, heads),
                "mma": vit_block.encoder(x, blocks, heads)}

    rows = {"twin": [], "mma": []}
    for x in crops:
        exact = after_ln(vit_block.float64_chain(x, blocks, heads))
        for name, out in outputs(x).items():
            d = (after_ln(out) - exact).abs()
            rows[name].append((d.max().item(), d.mean().item()))
    res = {"crops": len(crops)}
    twin = np.asarray(rows["twin"])
    for name in ("twin", "mma"):
        r = np.asarray(rows[name])
        res[name] = {"vs_float64_max_by_crop": r[:, 0].tolist(),
                     "vs_float64_mean": float(r[:, 1].mean()),
                     "mean_ratio_to_twin": float(r[:, 1].mean() / twin[:, 1].mean()),
                     "excess_over_twin_max": float((r[:, 0] - twin[:, 0]).max()),
                     "pooled_excess_over_twin": float(r[:, 0].max()
                                                      - twin[:, 0].max()),
                     "twin_excess_over_it_max": float((twin[:, 0]
                                                       - r[:, 0]).max())}
        excess = ("pooled_excess_over_twin" if pooled
                  else "excess_over_twin_max")
        print(f"final LN, {len(crops)} crops of the main-path clip, {name}: "
              f"max|d| from the float64 chain by crop {r[:, 0].tolist()}; "
              f"largest excess over the twin's by crop "
              f"{res[name]['excess_over_twin_max']}, the twin's over it "
              f"{res[name]['twin_excess_over_it_max']}, over all the crops "
              f"{res[name]['pooled_excess_over_twin']} (tolerance {LN_MARGIN} "
              f"on {excess}); mean {res[name]['vs_float64_mean']:.5f}, "
              f"{res[name]['mean_ratio_to_twin']:.4f} x the twin's (tolerance "
              f"{LN_MEAN_RATIO})", flush=True)
    if pooled:
        r = np.asarray(rows["mma"])
        draws = np.random.default_rng(0).integers(0, len(crops),
                                                  (2000, len(crops)))

        def spread(n):
            ratios = r[draws[:, :n], 1].mean(1) / twin[draws[:, :n], 1].mean(1)
            return np.percentile(ratios, [5, 50, 95]).tolist()

        res["mma"].update(
            ratio_first=float(r[:LN_CROPS, 1].mean()
                              / twin[:LN_CROPS, 1].mean()),
            ratio_spread_first=spread(LN_CROPS), ratio_spread=spread(len(crops)),
            crops_over_margin=int((r[:, 0] - twin[:, 0] > LN_MARGIN).sum()),
            twin_crops_over_margin=int((twin[:, 0] - r[:, 0] > LN_MARGIN).sum()))
        m = res["mma"]
        print(f"final LN spread, mma: mean ratio to the twin on the first "
              f"{LN_CROPS} crops {m['ratio_first']:.4f}; 5 / 50 / 95 % of "
              f"2000 draws of {LN_CROPS} crops {m['ratio_spread_first']}, of "
              f"{len(crops)} {m['ratio_spread']}; crops where the kernel's "
              f"largest distance exceeds the twin's by more than {LN_MARGIN}: "
              f"{m['crops_over_margin']}, the twin's the kernel's: "
              f"{m['twin_crops_over_margin']}", flush=True)
    old = outputs(x_entry)
    mma = res["mma"]
    mma["vs_twin_at_entry_crop"] = (
        after_ln(old["mma"]) - after_ln(old["twin"])).abs().max().item()
    print(f"final LN at the entry crop, mma vs twin: max|d| "
          f"{mma['vs_twin_at_entry_crop']} (the old bound {LN_ATOL_OLD}, not "
          f"asserted)", flush=True)
    excess = "pooled_excess_over_twin" if pooled else "excess_over_twin_max"
    if not (mma[excess] <= LN_MARGIN
            and mma["mean_ratio_to_twin"] <= LN_MEAN_RATIO):
        raise AssertionError(f"encoder kernel after the final LN: {mma}")
    return res


def encoder_phase(dev, cfg, params, x, blocks, crops, small, sparams,
                  cases) -> dict:
    """Kernel 1 at the flagship shape on real tokens, timed; the final-LN
    yardstick; the f32 small preset (tf32x3); the two float32 cases of
    kernel 1 in ``cases`` (:func:`f32_cases`), timed beside simt."""
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block

    before = (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES)
    res = timed_kernel(
        "encoder (1, 320, 192) bf16", x, blocks, cfg.num_heads, True,
        lambda: vit_block.encoder(x, blocks, cfg.num_heads))
    res["final_ln"] = final_ln_check(cfg, params, blocks, crops, x)
    if (attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES) != before:
        raise AssertionError("the encoder or its twin launched an attention "
                             "kernel of ops/attention.py: the twin must stay "
                             "plain")

    sblocks = sparams["backbone"]["blocks"]
    gen = torch.Generator(device="cpu").manual_seed(0)
    xs = torch.randn((1, small.num_tokens, small.embed_dim),
                     generator=gen).to(dev)
    n0 = vit_block.VARIANT_LAUNCHES["tf32x3"]
    res["max_abs_err_f32_small"] = check_kernel(
        f"encoder small f32 (S={small.num_tokens}, D={small.embed_dim})",
        vit_block.encoder(xs, sblocks, small.num_heads),
        vit_block.encoder_reference(xs, sblocks, small.num_heads),
        torch.float32)
    if vit_block.VARIANT_LAUNCHES["tf32x3"] != n0 + 1:
        raise AssertionError("the f32 small preset must take tf32x3")
    res["f32"] = {"flagship": timed_f32(cases["encoder_flagship"]),
                  "small": timed_f32(cases["encoder_small"])}
    return res


# ---------------------------------------------------------------------------
# Phase 3b: the attention kernels
# ---------------------------------------------------------------------------

def attention_case(bh, s, dh, dtype, dev, want_route, want_variant, timed,
                   lib_shape=None):
    """One shape through ``flash_attention`` against ``attention_reference``
    on the same seeded tensors.  Returns a dict of what was measured.
    ``lib_shape``: the (batch, heads, S, dh) view the library call takes
    (default one batch of ``bh`` heads)."""
    from gstreamer_vit_tracker_tpu_torch.ops import attention

    gen = torch.Generator(device="cpu").manual_seed(1000 * s + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=gen).to(dev, dtype)
               for _ in range(3))
    route, variant = attention.kernel_route(q), attention.kernel_variant(q)
    out = attention.flash_attention(q, k, v)
    plain = attention.attention_reference(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    tol = ATT_F32_ATOL if dtype == torch.float32 else ATT_BF16_REL * scale
    name = f"({bh}, {s}, {dh}) {str(dtype).split('.')[-1]}"
    print(f"attention {name}: flash_attention chose {route} / {variant}; "
          f"max|d| {err:.3e} (max|plain| {scale:.3f}, tolerance {tol:.3e})",
          flush=True)
    if (route, variant) != (want_route, want_variant):
        raise AssertionError(
            f"attention {name}: expected attention_{want_route} / "
            f"{want_variant}, flash_attention chose {route} / {variant}")
    if out.dtype != dtype or not torch.isfinite(out.float()).all():
        raise AssertionError(f"attention {name}: wrong type or non-finite")
    if not err <= tol:
        raise AssertionError(f"attention_{route} {name} disagrees with "
                             f"attention_reference: {err} > {tol}")
    res = {"shape": [bh, s, dh], "route": route, "variant": variant,
           "max_abs_err": err}
    if timed:
        # The old design at this shape in this process: the SIMT variant of
        # the kernel that the SIMT rule takes here.
        eb = q.element_size()
        optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        simt = attention.Plan(
            "single" if attention.smem_bytes("single", "simt", s, dh, eb)
            <= optin else "flash", "simt")
        out_m, launch = attention.prepared(q, k, v)
        out_s, launch_simt = attention.prepared(q, k, v, chosen=simt)
        launch()
        launch_simt()
        torch.cuda.synchronize()
        # A padded head dim: prepared() returns the kernel's padded output.
        if not torch.equal(out_m[..., :dh], out):
            raise AssertionError(f"attention {name}: prepared() and "
                                 f"flash_attention differ")
        err_simt = (out_s.float() - plain.float()).abs().max().item()
        if not err_simt <= tol:
            raise AssertionError(f"attention_{simt.route} simt {name} "
                                 f"disagrees: {err_simt} > {tol}")
        q4, k4, v4 = (t.view(lib_shape) if lib_shape else t[None]
                      for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4)

        res["ms"] = cuda_ms(lambda: attention.flash_attention(q, k, v))
        res["launch_ms"] = cuda_ms(launch)
        res["simt_ms"] = cuda_ms(launch_simt)
        res["plain_ms"] = cuda_ms(
            lambda: attention.attention_reference(q, k, v))
        res["library_ms"] = cuda_ms(library)
        res["ms_again"] = cuda_ms(lambda: attention.flash_attention(q, k, v))
        res["device_us"] = graph_us(launch)
        res["simt_device_us"] = graph_us(launch_simt)
        res["library_device_us"] = graph_us(library)
        flops = 4 * s * s * dh * bh
        nbytes = 4 * q.numel() * q.element_size()
        t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
        if dtype == torch.float32:
            # Two bounds: the products as f32 FMA, and as the three TF32
            # products a product that tf32x3 runs on the tensor cores (the
            # row's bound for tf32x3, whose operations these are).
            t_fma = flops / H100_F32_FLOPS * 1e3
            t_split = 3 * flops / H100_TF32_FLOPS * 1e3
            res["bound_fma_ms"] = max(t_fma, t_bytes)
            res["bound_split_tf32_ms"] = max(t_split, t_bytes)
            t_ops = t_split if variant == "tf32x3" else t_fma
            bound_note = (
                f"; f32 FMA {t_fma * 1e3:.2f} us, split TF32 (3 x "
                f"{flops / 1e9:.3f} GFLOP at {H100_TF32_FLOPS / 1e12:.0f} "
                f"TFLOP/s) {t_split * 1e3:.2f} us, the bound is the "
                + ("split TF32 one" if variant == "tf32x3" else "f32 FMA one"))
        else:
            t_ops, bound_note = flops / H100_BF16_FLOPS * 1e3, ""
        res["bound_ms"] = max(t_ops, t_bytes)
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"attention_{route} {name} ms (CUDA events, mean of "
              f"{TIMING_ITERS}): through flash_attention {res['ms']:.4f} / "
              f"{res['ms_again']:.4f} (before / after the others), one launch "
              f"on ready operands {res['launch_ms']:.4f}, the simt variant "
              f"(attention_{simt.route}) the same way {res['simt_ms']:.4f}, "
              f"plain {res['plain_ms']:.4f}, scaled_dot_product_attention "
              f"{res['library_ms']:.4f}; device us a launch (CUDA graph of "
              f"{GRAPH_LAUNCHES}): {variant} {res['device_us']:.2f}, simt "
              f"{res['simt_device_us']:.2f}, scaled_dot_product_attention "
              f"{res['library_device_us']:.2f}; bound "
              f"{res['bound_ms'] * 1e3:.2f} us by {res['bound_by']} "
              f"({flops / 1e9:.3f} GFLOP -> {t_ops * 1e3:.2f} us, "
              f"{nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us{bound_note}) "
              f"| {card_line()}", flush=True)
    return res


# What the kernels line keeps of a timed float32 attention case.
F32_KEYS = ("shape", "variant", "max_abs_err", "device_us", "simt_device_us",
            "library_device_us", "bound_ms", "bound_by", "bound_fma_ms",
            "bound_split_tf32_ms")


def multihead_case(dev, cfg):
    """``multihead_attention`` on the three column blocks of one (16, 320,
    576) bf16 qkv buffer, as a block of the serving tick calls it: one
    launch that reads them in place, beside the path it replaced (a
    contiguous per-head copy of q, k and v, the launch, a copy back)."""
    from gstreamer_vit_tracker_tpu_torch.ops import attention

    b, s, d, heads = SERVE_SLOTS, cfg.num_tokens, cfg.embed_dim, cfg.num_heads
    dh = d // heads
    gen = torch.Generator(device="cpu").manual_seed(17)
    qkv = torch.randn((b, s, 3 * d), generator=gen).to(dev, torch.bfloat16)
    q, k, v = torch.chunk(qkv, 3, dim=-1)

    def copied():
        qh, kh, vh = (x.reshape(b, s, heads, dh).transpose(1, 2)
                      .reshape(b * heads, s, dh) for x in (q, k, v))
        out = attention.flash_attention(qh, kh, vh)
        return out.reshape(b, heads, s, dh).transpose(1, 2).reshape(b, s, d)

    before = attention.SINGLE_LAUNCHES
    got = attention.multihead_attention(q, k, v, heads)
    if attention.SINGLE_LAUNCHES != before + 1:
        raise AssertionError("multihead_attention did not launch exactly once")
    plain = attention.multihead_attention(q, k, v, heads, use_kernel=False)
    torch.cuda.synchronize()
    same = torch.equal(got, copied())
    err = (got.float() - plain.float()).abs().max().item()
    tol = ATT_BF16_REL * plain.float().abs().max().item()
    ms = cuda_ms(lambda: attention.multihead_attention(q, k, v, heads))
    copied_ms = cuda_ms(copied)
    ms_again = cuda_ms(lambda: attention.multihead_attention(q, k, v, heads))
    print(f"multihead_attention ({b}, {s}, {d}) bf16 on the chunks of a "
          f"({b}, {s}, {3 * d}) qkv buffer: equals the copied per-head path "
          f"bit for bit: {same}; vs plain max|d| {err:.3e} (tolerance "
          f"{tol:.3e}); ms (CUDA events, mean of {TIMING_ITERS}) in place "
          f"{ms:.4f} / {ms_again:.4f}, copy-then-launch {copied_ms:.4f}",
          flush=True)
    if not same or not err <= tol:
        raise AssertionError("multihead_attention on strided views disagrees")
    return {"ms": ms, "copied_ms": copied_ms}


def attention_phase(dev, cfg, small):
    from gstreamer_vit_tracker_tpu_torch.ops import attention

    bf16, f32 = torch.bfloat16, torch.float32
    single = attention_case(48, 320, 64, bf16, dev, "single", "mma", timed=True)
    # The f32 small preset's serving tick (16 slots x 2 heads, S = 80, dh
    # 48): tf32x3, timed beside the simt design it replaced.
    single["f32"] = attention_case(
        SERVE_SLOTS * small.num_heads, small.num_tokens,
        small.embed_dim // small.num_heads, f32, dev, "single", "tf32x3",
        timed=True)
    flash = attention_case(3, 1088, 64, bf16, dev, "flash", "mma", timed=True)
    attention_case(3, 1088, 64, f32, dev, "flash", "tf32x3", timed=False)
    attention_case(2, 777, 32, f32, dev, "flash", "tf32x3", timed=False)
    # The dry run's 20 tokens (entry.py): its f32 train step (batch 4 x 3
    # heads, dh 64) and its serving tick (dh 16).
    attention_case(12, 20, 64, f32, dev, "single", "tf32x3", timed=False)
    attention_case(8, 20, 16, f32, dev, "single", "tf32x3", timed=False)
    attention_case(2, 1001, 128, bf16, dev, "flash", "mma", timed=False)
    attention_case(5, 33, 128, bf16, dev, "single", "mma", timed=False)
    attention_case(40, 1088, 64, bf16, dev, "flash", "mma", timed=False)  # one warpgroup
    attention_case(2, 1200, 32, bf16, dev, "flash", "mma", timed=False)
    attention_case(4, 80, 48, bf16, dev, "single", "mma", timed=False)  # dh 48 -> 64
    single["multihead"] = multihead_case(dev, cfg)
    # The shared-memory sizes the rule is decided on are the kernels' own
    # (the panel kernels' at G panels of o a CTA, and their rings).
    lib = attention._library()
    for route, variant, kb, st, wg, g, s, dh, eb in (
            ("single", "mma", 64, 0, 1, 0, 320, 64, 2),
            ("flash", "mma", 128, 2, 2, 0, 1088, 64, 2),
            ("flash", "mma", 64, 3, 1, 0, 1088, 32, 2),
            ("single", "mma", 64, 0, 1, 4, 100, 256, 2),
            ("single", "mma", 64, 0, 1, 1, 320, 192, 2),
            ("flash", "mma", 64, 9, 1, 4, 320, 256, 2),
            ("flash", "mma", 64, 10, 1, 3, 320, 192, 2),
            ("flash", "mma", 64, 12, 1, 4, 320, 1024, 2),
            ("single", "simt", 0, 0, 1, 0, 320, 64, 2),
            ("flash", "simt", 0, 0, 1, 0, 1088, 64, 4),
            ("single", "tf32x3", 64, 0, 1, 0, 80, 48, 4),
            ("single", "tf32x3", 64, 0, 1, 0, 128, 64, 4),
            ("flash", "tf32x3", 64, 2, 1, 0, 320, 64, 4),
            ("flash", "tf32x3", 64, 2, 1, 0, 1088, 128, 4),
            ("flash", "tf32x3", 64, 5, 1, 4, 320, 256, 4),
            ("flash", "tf32x3", 64, 5, 1, 3, 320, 136, 4),
            ("single", "tf32x3", 64, 0, 1, 1, 64, 256, 4),
            ("flash", "tf32x3", 64, 7, 1, 4, 320, 1024, 4)):
        want = lib.attention_smem(route == "single",
                                  attention._VARIANT_CODES[variant], kb, st,
                                  wg, g, s, dh, eb)
        if attention.smem_bytes(route, variant, s, dh, eb, kb, st, wg,
                                g) != want:
            raise AssertionError(f"smem_bytes{(route, variant, kb, st, wg, g, s, dh)}"
                                 f" != the kernel's {want}")
    optin = attention.card(dev)[0]
    for panels, g in ((3, 3), (3, 1), (4, 4), (4, 2), (4, 1), (16, 4), (16, 1)):
        want = lib.attention_ring_stages(panels, g, optin)
        if attention.panel_stages(panels, g, optin) != want:
            raise AssertionError(f"panel_stages({panels}, {g}) != the "
                                 f"kernel's {want}")
    for panels, g in ((3, 3), (3, 1), (4, 4), (4, 1), (8, 2), (16, 4)):
        want = lib.attention_tf32_ring_stages(panels, g, optin)
        if attention.tf32_panel_stages(panels, g, optin) != want:
            raise AssertionError(f"tf32_panel_stages({panels}, {g}) != the "
                                 f"kernel's {want}")
    return single, flash


# ---------------------------------------------------------------------------
# Phase 5: the serving path
# ---------------------------------------------------------------------------

def stream_clips(n_streams: int, n_frames: int):
    """One seeded 1080p NV12 clip per stream: boxes spread over the frame,
    each moving its own way."""
    clips = []
    for s in range(n_streams):
        box = (200 + 380 * (s % 4), 150 + 200 * (s // 4), 96, 72)
        step = ((3, 2), (-2, 2), (2, -1), (-3, -2))[s % 4]
        clips.append(nv12_clip(n_frames, seed=100 + s, box=box, step=step))
    return clips


def compare_with_cpu(what: str, card_rows, cpu_rows) -> None:
    d_box = np.abs(cpu_rows[:, :4] - card_rows[:, :4]).max()
    d_score = np.abs(cpu_rows[:, 4] - card_rows[:, 4]).max()
    print(f"{what}, card vs CPU engine: max|d bbox| {d_box:.4f} px, "
          f"max|d score| {d_score:.5f}", flush=True)
    if d_box > CPU_BOX_TOL or d_score > CPU_SCORE_TOL:
        raise AssertionError(f"{what}: the card disagrees with the CPU")


def serve_phase(dev, preset: str):
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import vit, weights
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block
    from gstreamer_vit_tracker_tpu_torch.serve import (SlotEngine, TrackClient,
                                                       TrackServer,
                                                       TrackServiceError)

    cfg = PRESETS[preset]
    ckpt = weights.checkpoint_path(preset)
    params = weights.load_npz(ckpt, cfg, device=dev)
    engine = SlotEngine(params, cfg, slots=SERVE_SLOTS, snapshot_every=0,
                        device=dev)
    server = TrackServer(engine, FRAME_H, FRAME_W, port=0, batch_window_ms=2.0,
                         pipeline_depth=2, update_timeout_s=120.0)
    server.start()
    n_frames = 1 + CLIENT_FRAMES + 1 + ENGINE_TICKS + 2
    t0 = time.perf_counter()
    clips = stream_clips(SERVE_SLOTS, n_frames)
    print(f"serving: {SERVE_SLOTS} seeded {FRAME_W}x{FRAME_H} NV12 clips of {n_frames} "
          f"frames made in {time.perf_counter() - t0:.1f} s", flush=True)

    # Warm-up through the same entry points, before the counts are zeroed.
    with TrackClient(server.host, server.port, timeout_s=120.0) as c:
        assert c.info["slots"] == SERVE_SLOTS and c.info["format"] == "nv12"
        c.init(clips[0][0][0], clips[0][1][0])
        c.update(clips[0][0][1])
        c.release()
    torch.cuda.synchronize()
    attention.SINGLE_LAUNCHES = attention.FLASH_LAUNCHES = 0
    vit_block.LAUNCHES = 0
    ticks0 = server._ticks

    # -- 4 clients, each its own thread: init, then 10 updates -------------
    clients = [TrackClient(server.host, server.port, timeout_s=120.0)
               for _ in range(SERVE_CLIENTS)]
    served = [None] * SERVE_CLIENTS
    errors = []

    def run(k):
        try:
            frames, boxes = clips[k]
            clients[k].init(frames[0], boxes[0])
            rows = []
            for t in range(1, CLIENT_FRAMES + 1):
                bbox, score = clients[k].update(frames[t])
                rows.append([*bbox, score])
            served[k] = np.asarray(rows, np.float32)
        except Exception as e:       # noqa: BLE001 - re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(k,))
               for k in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    served_s = time.perf_counter() - t0
    if errors or any(r is None for r in served):
        raise AssertionError(f"served clients failed: {errors}")
    served = np.stack(served)                       # (clients, frames, 5)
    if not np.isfinite(served).all():
        raise AssertionError("served results are not finite")
    served_iou = [[_iou(served[k, t - 1, :4], clips[k][1][t])
                   for t in range(1, CLIENT_FRAMES + 1)]
                  for k in range(SERVE_CLIENTS)]
    served_ticks = server._ticks - ticks0
    print(f"serving: {SERVE_CLIENTS} clients x {CLIENT_FRAMES} updates in "
          f"{served_s:.2f} s over {served_ticks} ticks "
          f"({SERVE_CLIENTS * CLIENT_FRAMES / served_s:.1f} updates/s, "
          f"round trips and 3.1 MB frames over loopback included); mean IoU "
          f"vs drawn boxes {np.mean(served_iou):.3f}, scores "
          f"{served[..., 4].min():.3f}-{served[..., 4].max():.3f}", flush=True)
    if not CLIENT_FRAMES <= served_ticks <= SERVE_CLIENTS * CLIENT_FRAMES:
        raise AssertionError(f"{served_ticks} ticks for {SERVE_CLIENTS} x "
                             f"{CLIENT_FRAMES} updates")
    if np.mean(served_iou) < 0.3:
        raise AssertionError(f"served tracks left their targets: mean IoU "
                             f"{np.mean(served_iou):.3f}")

    # -- an injected device fault surfaces and is recovered from -----------
    with engine.lock:
        engine.snapshot()
    real_step = engine.step_async
    fired = []

    def faulty_step(frames, active):
        if not fired:
            fired.append(1)
            raise RuntimeError("injected device fault")
        return real_step(frames, active)

    engine.step_async = faulty_step
    t_next = CLIENT_FRAMES + 1
    try:
        clients[0].update(clips[0][0][t_next])
    except TrackServiceError as e:
        if "device fault" not in str(e) or e.reinit:
            raise AssertionError(f"fault surfaced wrongly: {e!r}") from e
    else:
        raise AssertionError("an injected device fault did not surface")
    engine.step_async = real_step
    bbox, score = clients[0].update(clips[0][0][t_next])
    stats = clients[0].stats()
    if stats["faults"] != 1 or not (np.isfinite(bbox).all()
                                    and np.isfinite(score)):
        raise AssertionError(f"no recovery after the fault: {stats}")
    fault_iou = _iou(bbox, clips[0][1][t_next])
    print(f"serving: injected fault surfaced at its client, recovered; next "
          f"update IoU {fault_iou:.3f}, faults {stats['faults']}", flush=True)

    # -- 30 engine ticks, all 16 slots live ---------------------------------
    # Slots 0-2 of the first CPU_CHECK_STEPS ticks are held to the port's CPU
    # engine given the card's state before the tick and the same frames.
    # (Left to run free, two bf16 trajectories of the flagship drift apart
    # within a few frames: a one-step difference in a bf16 head output moves
    # the box by up to half a pixel, and the next crop follows it.)
    cpu = torch.device("cpu")
    cpu_engine = SlotEngine(weights.load_npz(ckpt, cfg, device=cpu), cfg,
                            slots=3, snapshot_every=0, device=cpu)
    cpu_engine.occupied[:] = True
    with engine.lock:
        slot_of = {k: clients[k].slot for k in range(SERVE_CLIENTS)}
        frame_at = {slot_of[0]: t_next + 1}
        for k in range(1, SERVE_CLIENTS):
            frame_at[slot_of[k]] = CLIENT_FRAMES + 1
        clip_of = dict((s, k) for k, s in slot_of.items())
        for k in range(SERVE_CLIENTS, SERVE_SLOTS):
            slot = engine.alloc()
            engine.init_slot(slot, clips[k][0][0], clips[k][1][0])
            clip_of[slot], frame_at[slot] = k, 1
        if not engine.occupied.all():
            raise AssertionError("not all slots live")
        active = np.ones(SERVE_SLOTS, bool)
        tick_ms, tick_dev_ms, tick_iou = [], [], []
        packed = None
        for i in range(ENGINE_TICKS):
            for slot in range(SERVE_SLOTS):
                server._write_frame(slot,
                                    clips[clip_of[slot]][0][frame_at[slot] + i])
            if i < CPU_CHECK_STEPS:
                cpu_engine.state = type(engine.state)(
                    *(t[:3].to(cpu, copy=True) for t in engine.state))
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            tick = engine.step_async(server._buf, active)
            e1.record()
            packed = np.asarray(tick)
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            e1.synchronize()
            tick_dev_ms.append(e0.elapsed_time(e1))
            if packed.shape != (SERVE_SLOTS, 5) or not np.isfinite(packed).all():
                raise AssertionError("engine tick: non-finite or misshapen")
            tick_iou.append([_iou(packed[s, :4],
                                  clips[clip_of[s]][1][frame_at[s] + i])
                             for s in range(SERVE_SLOTS)])
            if i < CPU_CHECK_STEPS:
                want = cpu_engine.step(tuple(t[:3] for t in server._buf),
                                       np.ones(3, bool))
                compare_with_cpu(f"engine tick {i + 1}, slots 0-2",
                                 packed[:3], want)
        print(f"engine: {ENGINE_TICKS} ticks x {SERVE_SLOTS} live slots, "
              f"{preset} {FRAME_W}x{FRAME_H} NV12; tick ms (host clock, enqueue to result "
              f"read) median {statistics.median(tick_ms):.3f} (min "
              f"{min(tick_ms):.3f}, max {max(tick_ms):.3f}); device span "
              f"(CUDA events) median {statistics.median(tick_dev_ms):.3f}; "
              f"mean IoU vs drawn boxes {np.mean(tick_iou):.3f} (worst slot "
              f"{np.mean(tick_iou, axis=0).min():.3f}), scores "
              f"{packed[:, 4].min():.3f}-{packed[:, 4].max():.3f}", flush=True)
        if np.mean(tick_iou) < 0.3:
            raise AssertionError(f"engine tracks left their targets: mean "
                                 f"IoU {np.mean(tick_iou):.3f}")

        # -- recover() restores a snapshotted state ---------------------------
        engine.snapshot()
        snap = [t.clone() for t in engine.state]
        for slot in range(SERVE_SLOTS):
            server._write_frame(
                slot, clips[clip_of[slot]][0][frame_at[slot] + ENGINE_TICKS])
        first = engine.step(server._buf, active)
        for leaf in engine.state:                    # the "fault"
            leaf.zero_()
        lost = engine.recover()
        same = all(torch.equal(a, b) for a, b in zip(snap, engine.state))
        again = engine.step(server._buf, active)
        d_again = np.abs(again - first).max()
        print(f"engine: recover() lost {lost}, state restored bit for bit: "
              f"{same}; the tick after it repeats the tick before within "
              f"{d_again:.2e}", flush=True)
        if lost or not same or not d_again <= 1e-3:
            raise AssertionError("recover() did not restore the snapshot")
        total_ticks = (server._ticks - ticks0) + ENGINE_TICKS + 2

    torch.cuda.synchronize()
    launches = attention.SINGLE_LAUNCHES
    if (launches != cfg.depth * total_ticks or attention.FLASH_LAUNCHES
            or vit_block.LAUNCHES):
        raise AssertionError(
            f"serving path: attention_single launched {launches} times in "
            f"{total_ticks} ticks of depth {cfg.depth} (attention_flash "
            f"{attention.FLASH_LAUNCHES}, encoder {vit_block.LAUNCHES})")
    print(f"serving path: attention_single launches {launches} = depth "
          f"{cfg.depth} x {total_ticks} ticks", flush=True)

    # -- timed only: one tick's upload, and the encoder at B=16 -------------
    up_ms = cuda_ms(lambda: engine._place_frames(server._buf), iters=20,
                    warmup=3)
    up_mb = sum(t.numel() for t in server._buf) / 1e6
    z = engine.state.z_tok[:, 0]
    gen = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((SERVE_SLOTS, cfg.num_search_tokens, cfg.embed_dim),
                    generator=gen).to(dev, z.dtype)
    bb = params["backbone"]
    enc_block_ms = cuda_ms(lambda: vit.encode(bb, z, x, cfg, fused=False),
                           iters=20, warmup=3)
    enc_fused_ms = cuda_ms(lambda: vit.encode(bb, z, x, cfg, fused=True),
                           iters=20, warmup=3)
    print(f"upload of one tick's frames ({up_mb:.1f} MB pinned, two copies): "
          f"{up_ms:.3f} ms ({up_mb / up_ms:.1f} GB/s); encode at B="
          f"{SERVE_SLOTS} (CUDA events, mean of 20): per-block route "
          f"{enc_block_ms:.3f} ms, encoder kernel {enc_fused_ms:.3f} ms",
          flush=True)

    # -- the first served frame of clients 0-2 against the port's CPU engine -
    for k in range(3):
        cpu_engine.init_slot(k, clips[k][0][0], clips[k][1][0])
    ys = np.stack([clips[k][0][1][0] for k in range(3)])
    uvs = np.stack([clips[k][0][1][1] for k in range(3)])
    compare_with_cpu("served frame 1, clients 0-2", served[:3, 0],
                     cpu_engine.step((ys, uvs), np.ones(3, bool)))

    for c in clients:
        c.release()
        c.close()
    server.stop()
    return {"launches": launches, "ticks": total_ticks,
            "tick_ms_median": statistics.median(tick_ms),
            "tick_ms_min": min(tick_ms), "tick_ms_max": max(tick_ms),
            "tick_device_ms_median": statistics.median(tick_dev_ms),
            "upload_ms": up_ms, "encode_b16_per_block_ms": enc_block_ms,
            "encode_b16_encoder_kernel_ms": enc_fused_ms}


# ---------------------------------------------------------------------------
# Phase 6: the long-sequence serving path (attention_flash)
# ---------------------------------------------------------------------------

def random_flat(cfg, seed: int):
    """Seeded random weights for ``cfg`` as flat npz-style arrays."""
    from gstreamer_vit_tracker_tpu_torch.models import weights

    rng = np.random.default_rng(seed)
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        else:
            key = prefix[:-1]
            if key.endswith("/scale"):
                flat[key] = np.ones(tree, np.float32)
            elif key.endswith("/bias"):
                flat[key] = np.zeros(tree, np.float32)
            else:
                fan_in = int(np.prod(tree[:-1])) or 1
                flat[key] = (rng.standard_normal(tree)
                             * min(0.02, fan_in ** -0.5)).astype(np.float32)

    walk(weights.param_shapes(cfg), "")
    return flat


def long_phase(dev, cfg):
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block
    from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine
    from gstreamer_vit_tracker_tpu_torch.tracker import core, multi

    long_cfg = dataclasses.replace(cfg, search_size=LONG_SEARCH)
    assert long_cfg.num_tokens == 1088
    params = weights.params_from_flat(random_flat(long_cfg, seed=7), long_cfg,
                                      device=dev)
    frames, boxes = nv12_clip(LONG_TICKS + 1, seed=3, box=(800, 400, 160, 120))
    engine = SlotEngine(params, long_cfg, slots=1, snapshot_every=0, device=dev)
    engine.init_slot(engine.alloc(), frames[0], boxes[0])

    # The whole model at this length: the kernel route against the plain
    # route on the card, same inputs (bf16 maps in [0, 1]: 0.05).
    bcfg = multi._batched_cfg(long_cfg)
    window = core.pp.crop_window(engine.state.bbox[0, 0], long_cfg.search_factor)
    x_img = core._prep_nv12(core._frame_on(frames[1], "nv12", dev), window,
                            long_cfg.search_size, bcfg)[None]
    z = engine.state.z_tok[0]
    maps_k = vittrack.forward(params, z, x_img, long_cfg, fused=False)
    maps_p = vittrack.forward(params, z, x_img, long_cfg, use_kernel=False,
                              fused=False)
    d_maps = max((a - b).abs().max().item() for a, b in zip(maps_k, maps_p))
    print(f"long path (S = {long_cfg.num_tokens}): head maps by the kernel "
          f"route vs the plain route max|d| {d_maps:.4f}", flush=True)
    if not d_maps <= 0.05:
        raise AssertionError(f"long path: kernel route vs plain route {d_maps}")

    torch.cuda.synchronize()
    attention.SINGLE_LAUNCHES = attention.FLASH_LAUNCHES = 0
    vit_block.LAUNCHES = 0
    rows, ms = [], []
    for t in range(1, LONG_TICKS + 1):
        fr = (frames[t][0][None], frames[t][1][None])
        t0 = time.perf_counter()
        rows.append(engine.step(fr, np.ones(1, bool)))
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = attention.FLASH_LAUNCHES
    rows = np.stack(rows)
    inside = ((rows[..., :2] >= 0).all()
              and (rows[..., 0] + rows[..., 2] <= FRAME_W + 1e-3).all()
              and (rows[..., 1] + rows[..., 3] <= FRAME_H + 1e-3).all()
              and ((rows[..., 4] >= 0) & (rows[..., 4] <= 1)).all())
    print(f"long path: {LONG_TICKS} engine ticks, 1 slot, search "
          f"{LONG_SEARCH}; attention_flash launches {launches}; tick ms "
          f"{[round(v, 2) for v in ms]}; boxes inside the frame and scores "
          f"in [0, 1]: {bool(inside)}", flush=True)
    if rows.shape != (LONG_TICKS, 1, 5) or not np.isfinite(rows).all() \
            or not inside:
        raise AssertionError("long path: bad output")
    if (launches != long_cfg.depth * LONG_TICKS or attention.SINGLE_LAUNCHES
            or vit_block.LAUNCHES):
        raise AssertionError(
            f"long path: attention_flash launched {launches} times in "
            f"{LONG_TICKS} ticks of depth {long_cfg.depth} (attention_single "
            f"{attention.SINGLE_LAUNCHES}, encoder {vit_block.LAUNCHES})")
    return launches


def long_unbatched_phase(dev, cfg) -> dict:
    """The unbatched step at the flagship's width with a 512-pixel search
    crop (S = 1088, past the old shared-memory limit; seeded random weights):
    init and CPU_CHECK_STEPS update_packed steps on the card through kernel
    1, each against the same step run by the port on the CPU from the same
    state."""
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    cpu = torch.device("cpu")
    long_cfg = dataclasses.replace(cfg, search_size=LONG_SEARCH)
    flat = random_flat(long_cfg, seed=7)
    params = vittrack.with_grouped_head(
        weights.params_from_flat(flat, long_cfg, device=dev))
    cparams = vittrack.with_grouped_head(
        weights.params_from_flat(flat, long_cfg, device=cpu))
    frames, boxes = nv12_clip(CPU_CHECK_STEPS + 1, seed=3, box=(800, 400, 160, 120))
    state = core.init(params, frames[0], boxes[0], long_cfg, device=dev,
                      frame_format="nv12")
    torch.cuda.synchronize()
    vit_block.LAUNCHES = 0
    zero_variants()
    rows, before = [], []
    for i in range(CPU_CHECK_STEPS):
        before.append(state)
        state, out = core.update_packed(params, state, frames[i + 1], long_cfg,
                                        device=dev, frame_format="nv12")
        rows.append(out.cpu().numpy())
    torch.cuda.synchronize()
    by_variant = dict(vit_block.VARIANT_LAUNCHES)
    if vit_block.LAUNCHES != CPU_CHECK_STEPS \
            or by_variant != only("mma", CPU_CHECK_STEPS):
        raise AssertionError(f"long unbatched path: encoder launches "
                             f"{vit_block.LAUNCHES} ({by_variant}) in "
                             f"{CPU_CHECK_STEPS} steps")
    worst_box = worst_score = 0.0
    for i in range(CPU_CHECK_STEPS):
        cstate = type(state)(*(t.to(cpu) for t in before[i]))
        _, cout = core.update_packed(cparams, cstate, frames[i + 1], long_cfg,
                                     device=cpu, frame_format="nv12")
        if not np.isfinite(rows[i]).all():
            raise AssertionError("long unbatched path: non-finite output")
        worst_box = max(worst_box, float(np.abs(cout[:4].numpy() - rows[i][:4]).max()))
        worst_score = max(worst_score, abs(float(cout[4]) - float(rows[i][4])))
    print(f"long unbatched path (S = {long_cfg.num_tokens}, search "
          f"{LONG_SEARCH}, seeded weights): {CPU_CHECK_STEPS} update_packed "
          f"steps, encoder launches {by_variant}; card vs CPU from the card's "
          f"state: max|d bbox| {worst_box:.4f} px, max|d score| "
          f"{worst_score:.5f} (tolerance {CPU_BOX_TOL} px, {CPU_SCORE_TOL})",
          flush=True)
    if worst_box > CPU_BOX_TOL or worst_score > CPU_SCORE_TOL:
        raise AssertionError("long unbatched card steps disagree with the CPU")
    return {"seq": long_cfg.num_tokens, "launches": by_variant,
            "max_d_bbox_px": worst_box, "max_d_score": worst_score}


# ---------------------------------------------------------------------------
# Phase 3c: the NV12-to-tokens kernel
# ---------------------------------------------------------------------------

def prep_cost(window, frame_hw, cfg, elem: int):
    """(FLOPs by rate, bytes) that this window needs: the two-tap work (not
    the dense products of the plain version) and the bytes of the band that
    the taps touch, each counted once, with the embed weight, pos + bias
    and the tokens."""
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe

    h, w = frame_hw
    sy, sx, origin, bh, bw = fpe._band(
        torch.empty((h, w), dtype=torch.uint8, device=window.size.device),
        window, cfg.preprocess_band)
    sy, sx, sc = float(sy), float(sx), float(window.size) / cfg.search_size
    o = np.arange(cfg.search_size, dtype=np.float64)

    def touched(start, limit):
        j0 = np.floor(start + (o + 0.5) * sc - 0.5).astype(np.int64)
        full = np.union1d(j0, j0 + 1)
        half = np.union1d(j0 >> 1, (j0 >> 1) + 1)
        return (int(((full >= 0) & (full < limit)).sum()),
                int(((half >= 0) & (half < limit // 2)).sum()))

    rows, rows2 = touched(sy, bh)
    cols, cols2 = touched(sx, bw)
    n, k, d = cfg.num_search_tokens, cfg.patch_size ** 2 * 3, cfg.embed_dim
    nbytes = (rows * cols + rows2 * cols2 * 2          # Y taps, UV taps
              + (k * d + 2 * n * d) * elem + 20)       # weight, pos+bias, out
    # Per output pixel: three planes x (two row blends + two column
    # multiply-adds) = 30, the BT.601 mix 9, clip and normalise 15.
    f32_flops = 54 * cfg.search_size ** 2
    embed_flops = 2 * n * k * d
    return f32_flops, embed_flops, nbytes, (rows, cols, rows2, cols2)


def tiling_name(p) -> str:
    """A kernel-5 plan as tokens x columns, cluster: "16x32c6"."""
    return f"{p.tokens}x{p.cols}c{p.cluster}"


def prep_bound(win, frame_hw, cfg) -> dict:
    """The least time of kernel 5's function on this window: the bytes it
    must move (``prep_cost``) over HBM's rate, and its operations over the
    card's rate for their type: the two-tap work at float32's, the embed
    at bf16's or, in float32, as split TF32's three products at TF32's
    (the float32 FMA rate printed beside)."""
    f32 = cfg.dtype == "float32"
    f32_flops, embed_flops, nbytes, taps = prep_cost(win, frame_hw, cfg,
                                                     4 if f32 else 2)
    t_pix = f32_flops / H100_F32_FLOPS * 1e3
    t_embed = (3 * embed_flops / H100_TF32_FLOPS if f32
               else embed_flops / H100_BF16_FLOPS) * 1e3
    t_ops, t_bytes = t_pix + t_embed, nbytes / H100_HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes, "mbytes": nbytes / 1e6,
            "embed_mflop": embed_flops / 1e6, "taps": taps,
            "bound_fma_ms": (f32_flops + embed_flops) / H100_F32_FLOPS * 1e3}


def prep_shapes(dev, cfg, params) -> list:
    """(label, config, params, plans) of every shape phase 3c holds: the
    flagship in bf16 (the plan) and float32 (tf32x3 and simt by name), the
    small and corr-tiny presets in float32, the bf16 widths."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.profile_prep import seeded_params

    out = [("flagship bf16", cfg, params, [fpe.plan(cfg.embed_dim,
                                                    torch.bfloat16)])]
    for preset in PREP_F32_PRESETS:
        c = dataclasses.replace(PRESETS[preset], dtype="float32")
        p = (params if preset == "vittrack-t" else
             vittrack.init_params(torch.Generator().manual_seed(0), c, dev)
             if preset == "corr-tiny" else
             weights.load_npz(weights.checkpoint_path(preset), c, device=dev))
        label = "flagship" if preset == "vittrack-t" else preset
        out.append((f"{label} f32", c, p,
                    [fpe.plan(c.embed_dim, torch.float32),
                     fpe.plan(c.embed_dim, torch.float32, "simt")]))
    for d in PREP_BF16_WIDTHS:
        c = ModelConfig(template_size=64, search_size=128, patch_size=16,
                        embed_dim=d, depth=1, num_heads=1)
        out.append((f"bf16 D {d}", c, seeded_params(c, dev, d),
                    [fpe.plan(d, torch.bfloat16)]))
    return out


def prep_phase(dev, cfg, params):
    """Kernel 5 against both modes of its plain version on seven window
    geometries at every shape of ``prep_shapes`` (each plan launched once a
    case, the wrapper counting it by variant), the flagship's bf16 tokens
    bit-equal to the build before the float32 redesign, one call on ready
    parameters as one device activity, then each shape timed: device us a
    launch in a replayed CUDA graph of GRAPH_LAUNCHES (tf32x3 and simt in
    turns), the plain version, the unfused chain ``preprocess_nv12`` ->
    ``embed_search``, and the bound."""
    import hashlib

    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp

    rng = np.random.default_rng(11)

    def planes(h, w):
        return (torch.as_tensor(rng.integers(0, 256, (h, w), dtype=np.uint8),
                                device=dev),
                torch.as_tensor(rng.integers(0, 256, (h // 2, w // 2, 2),
                                             dtype=np.uint8), device=dev))

    frame = planes(FRAME_H, FRAME_W)
    # The last four try the window geometry the kernel works out itself.
    cases = [("inside", planes(512, 640), (300.0, 200.0, 64.0, 64.0)),
             ("off the edge", planes(512, 640), (-20.0, 470.0, 80.0, 80.0)),
             ("1080p banded", frame, (1500.0, 700.0, 64.0, 64.0)),
             # The even snap hides which way a tie rounds (424 either way);
             # tests/test_torch_fused_prep.py holds the rounding itself.
             ("a half-to-even tie (cx - 576 = 424.5)", frame,
              (990.0, 500.0, 21.0, 30.0)),
             ("a frame smaller than the band", planes(1080, 1080),
              (900.0, 100.0, 120.0, 90.0)),
             ("a window larger than the band", frame,
              (100.0, 600.0, 500.0, 380.0)),
             ("the band's corner", frame, (1850.0, 1030.0, 60.0, 44.0))]
    shapes = prep_shapes(dev, cfg, params)
    worst = {}
    for name, (y, uv), box in cases:
        for label, c, p, plans in shapes:
            win = pp.crop_window(torch.tensor(box, device=dev),
                                 c.search_factor)
            plain = [fpe.nv12_search_tokens_reference(p, y, uv, win, c, mode)
                     for mode in fpe.MODES]
            scale = plain[0].float().abs().max().item()
            tol = (PREP_F32_ATOL if c.dtype == "float32"
                   else PREP_BF16_REL * scale)
            for chosen in plans:
                before = dict(fpe.VARIANT_LAUNCHES)
                if chosen == plans[0]:        # the plan, through the wrapper
                    got = fpe.nv12_search_tokens(p, y, uv, win, c)
                else:
                    got = fpe.launch(*fpe.kernel_operands(
                        p, y, uv, win, c, chosen), c, chosen)
                torch.cuda.synchronize()
                if fpe.VARIANT_LAUNCHES != dict(before, **{
                        chosen.variant: before[chosen.variant] + 1}):
                    raise AssertionError(f"kernel 5 {label} {chosen}: the "
                                         f"launch was not counted once")
                errs = [(got.float() - q.float()).abs().max().item()
                        for q in plain]
                print(f"fused_prep_embed {name}, {label} {chosen.variant} "
                      f"{tiling_name(chosen)} W {chosen.width}, vs plain "
                      f"modes {fpe.MODES}: max|d| {errs[0]:.3e} / "
                      f"{errs[1]:.3e} (max|plain| {scale:.3f}, tolerance "
                      f"{tol:.3e})", flush=True)
                if got.shape != plain[0].shape or not torch.isfinite(
                        got.float()).all() or not max(errs) <= tol:
                    raise AssertionError(
                        f"fused_prep_embed {name} {label} {chosen} disagrees "
                        f"with its plain version: {errs} > {tol}")
                key = (label, chosen.variant)
                worst[key] = max(worst.get(key, 0.0), *errs)

    # Timed at the flagship's shape: bf16, the banded 1080p frame.
    _, (y, uv), box = cases[2]
    win = pp.crop_window(torch.tensor(box, device=dev), cfg.search_factor)
    ops = fpe.kernel_operands(params, y, uv, win, cfg)
    got = fpe.launch(*ops, cfg)
    digest = hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes()
                            ).hexdigest()
    print(f"fused_prep_embed flagship bf16 on the banded case: sha256 of the "
          f"tokens {digest}, the build before the float32 redesign "
          f"{PREP_BF16_FLAGSHIP_SHA256}: bit-equal "
          f"{digest == PREP_BF16_FLAGSHIP_SHA256}", flush=True)
    if digest != PREP_BF16_FLAGSHIP_SHA256:
        raise AssertionError("the flagship's bf16 tokens are no longer "
                             "bit-equal to the build before the redesign")

    # One call on ready parameters is one device activity: the kernel.
    from torch.profiler import ProfilerActivity, profile

    f32_flagship = dataclasses.replace(cfg, dtype="float32")
    for c in (cfg, f32_flagship):
        fpe.nv12_search_tokens(params, y, uv, win, c)
        torch.cuda.synchronize()
        # A trace with no device activity at all is the profiler's miss
        # (one run of this phase on the card recorded none), not the
        # call's: the call is traced again, at most three times.
        for attempt in range(1, 4):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fpe.nv12_search_tokens(params, y, uv, win, c)
                torch.cuda.synchronize()
            acts = [e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            if acts:
                break
        print(f"fused_prep_embed {c.dtype}: device activities of one call on "
              f"ready parameters (torch.profiler, trace {attempt}): "
              f"{len(acts)} {acts}", flush=True)
        if len(acts) != 1 or "embed" not in acts[0] or any(
                "memcpy" in a.lower() for a in acts):
            raise AssertionError(f"one nv12_search_tokens call is not one "
                                 f"kernel launch: {acts}")

    # The kernel's device time: one replayed CUDA graph of GRAPH_LAUNCHES
    # (profile_prep.py times other tilings and builds).
    chosen = fpe.plan(cfg.embed_dim, torch.bfloat16)
    _, launch = fpe.prepared(params, y, uv, win, cfg)

    def chain(p, c):
        def run():
            x_img = pp.preprocess_nv12(y, uv, win, c.search_size, c.norm_mean,
                                       c.norm_std, dtype=getattr(torch, c.dtype),
                                       band=c.preprocess_band)
            return vit.embed_search(p["backbone"], x_img[None], c)
        return run

    res = {"max_abs_err": worst[("flagship bf16", "mma")],
           "max_abs_err_f32": worst[("flagship f32", "tf32x3")],
           "variant": chosen.variant, "plan": tiling_name(chosen),
           "device_activities": len(acts), "sha256": digest}
    res["ms"] = cuda_ms(lambda: fpe.nv12_search_tokens(params, y, uv, win, cfg))
    res["launch_ms"] = cuda_ms(lambda: fpe.launch(*ops, cfg))
    res["device_us"] = graph_us(launch)
    res["plain_ms"] = cuda_ms(lambda: fpe.nv12_search_tokens_reference(
        params, y, uv, win, cfg), iters=20, warmup=3)
    res["chain_ms"] = cuda_ms(chain(params, cfg))
    res["ms_again"] = cuda_ms(
        lambda: fpe.nv12_search_tokens(params, y, uv, win, cfg))
    res["device_us_again"] = graph_us(launch)
    b = prep_bound(win, y.shape, cfg)
    res.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    print(f"fused_prep_embed 1080p banded bf16 ms (CUDA events, mean of "
          f"{TIMING_ITERS}): wrapper {res['ms']:.4f} / {res['ms_again']:.4f} "
          f"(before / after the others), one launch on ready operands "
          f"{res['launch_ms']:.4f}; device us a launch (CUDA graph of "
          f"{GRAPH_LAUNCHES}) {res['device_us']:.2f} / "
          f"{res['device_us_again']:.2f}; plain {res['plain_ms']:.4f}, "
          f"unfused chain preprocess_nv12 -> embed_search "
          f"{res['chain_ms']:.4f} (no library call computes this function); "
          f"bound {b['bound_ms'] * 1e3:.2f} us by {b['bound_by']} (two-tap "
          f"work + embed {b['embed_mflop']:.2f} MFLOP bf16 -> "
          f"{b['ops_ms'] * 1e3:.2f} us; {b['mbytes']:.3f} MB counting the "
          f"{b['taps'][0]} x {b['taps'][1]} luma and {b['taps'][2]} x "
          f"{b['taps'][3]} x 2 chroma bytes the taps touch -> "
          f"{b['bytes_ms'] * 1e3:.2f} us)", flush=True)

    # Every other shape on the same window: the plan's device time (tf32x3
    # and simt in turns in float32), the plain version, the unfused chain.
    res["shapes"] = {}
    for label, c, p, plans in shapes[1:]:
        w = pp.crop_window(torch.tensor(box, device=dev), c.search_factor)
        launches = {ch.variant: fpe.prepared(p, y, uv, w, c, ch)[1]
                    for ch in plans}
        us = {v: [] for v in launches}
        for _ in range(2):
            for v, fn in launches.items():
                us[v].append(graph_us(fn))
        b = prep_bound(w, y.shape, c)
        row = {"plan": list(plans[0]), "device_us": us, **b,
               "max_abs_err": {v: worst[(label, v)] for v in launches},
               "plain_ms": cuda_ms(lambda: fpe.nv12_search_tokens_reference(
                   p, y, uv, w, c), iters=10, warmup=2),
               "chain_ms": cuda_ms(chain(p, c), iters=20, warmup=3),
               "launch_ms": cuda_ms(lambda: fpe.launch(
                   *fpe.kernel_operands(p, y, uv, w, c), c), iters=20)}
        res["shapes"][label] = row
        print(f"fused_prep_embed {label} (N {c.num_search_tokens}, K "
              f"{c.patch_size ** 2 * 3}, D {c.embed_dim}), 1080p banded: "
              f"device us a launch {json.dumps(us)}; plain "
              f"{row['plain_ms']:.4f} ms, unfused chain {row['chain_ms']:.4f}, "
              f"one launch {row['launch_ms']:.4f}; bound "
              f"{b['bound_ms'] * 1e3:.3f} us by {b['bound_by']} (operations "
              f"{b['ops_ms'] * 1e3:.3f} us"
              + (f" as split TF32, {b['bound_fma_ms'] * 1e3:.3f} on the FMA "
                 f"units" if c.dtype == "float32" else "")
              + f"; {b['mbytes']:.3f} MB -> {b['bytes_ms'] * 1e3:.3f} us)",
              flush=True)
    res["device_us_f32"] = res["shapes"]["flagship f32"]["device_us"][
        "tf32x3"][0]
    return res


# The kernel-5 paths (phase 4c): steps of each, and the D-768 bf16 model
# they drive at full width (seeded weights; no preset names it, both
# packages take it).
PREP_PATH_STEPS = 8
PREP_WIDE_STEPS = 5
PREP_WIDE = dict(embed_dim=768, depth=2, num_heads=12)


def prep_path(dev, label, cfg, load, steps, routes, tols, frames, boxes,
              clip, pool) -> tuple:
    """One model of the kernel-5 paths: ``load(device)`` its params,
    ``steps`` fused_prep steps of the NV12 ``clip`` (``frames`` on the host,
    ``pool`` its (Y, UV) stacked on the card) by each of ``routes``
    ("eager": ``core.update_packed(fused_prep=True)``; "compiled":
    ``scan.update_scan_pool(fused_prep=True)``), each step from the state
    the port's CPU run of the same route had before it, held to the CPU's
    step (``tols``: px, score) and to the plain-route step on the card from
    the same state (ROUTE_BOX_TOL, ROUTE_SCORE_TOL); the counts set to 0
    just before each route's steps and read just after: kernel 5 once a
    step, kernel 1 once a step where the model has blocks, each in the
    plan's variant, nothing else.  Returns (the card's params, the
    readings)."""
    from gstreamer_vit_tracker_tpu_torch.models import vittrack
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.tracker import core, scan

    cpu = torch.device("cpu")
    ys, uvs = pool
    box_tol, score_tol = tols
    params = vittrack.with_grouped_head(load(dev))
    cparams = vittrack.with_grouped_head(load(cpu))
    dt = getattr(torch, cfg.dtype)
    k5 = fpe.plan(cfg.embed_dim, dt).variant
    k1 = vit_block.plan(1, cfg.num_tokens, cfg.embed_dim, cfg.num_heads,
                        int(cfg.embed_dim * cfg.mlp_ratio), dt,
                        attention.card(dev)[1]).variant
    n1 = steps if cfg.depth else 0
    cst = [core.init(cparams, frames[0], boxes[0], cfg, "nv12", cpu)]
    want = []
    for i in range(steps):
        st, b, c = core.update(cparams, cst[-1], frames[i + 1], cfg,
                               "nv12", cpu, fused_prep=True)
        cst.append(st)
        want.append(torch.cat([b, c[None]]).numpy())

    def held(i):
        return type(cst[i])(*(t.to(dev) for t in cst[i]))

    def step(route, i):
        if route == "eager":
            return core.update_packed(params, held(i), clip[i + 1], cfg,
                                      "nv12", dev, fused_prep=True)[1]
        st, sc = scan.update_scan_pool(
            params, held(i), (ys[i + 1:i + 2], uvs[i + 1:i + 2]), 1, cfg,
            "nv12", fused_prep=True, device=dev)
        return torch.cat([st.bbox, sc])

    plain = []                             # the plain route, uncounted
    for i in range(steps):
        _, b, c = core.update(params, held(i), clip[i + 1], cfg, "nv12",
                              dev)
        plain.append(torch.cat([b, c[None]]))
    plain, want = torch.stack(plain).cpu().numpy(), np.stack(want)
    out = {"kernel1": k1 if cfg.depth else None, "kernel5": k5}
    for route in routes:
        if route == "compiled":
            step(route, 0)                  # the first call captures
        zero_counts()
        got = [step(route, i) for i in range(steps)]
        counts, v1, v5 = (read_counts(), dict(vit_block.VARIANT_LAUNCHES),
                          dict(fpe.VARIANT_LAUNCHES))
        got = torch.stack(got).cpu().numpy()
        d_box = float(np.abs(got[:, :4] - want[:, :4]).max())
        d_score = float(np.abs(got[:, 4] - want[:, 4]).max())
        r_box = float(np.abs(got[:, :4] - plain[:, :4]).max())
        r_score = float(np.abs(got[:, 4] - plain[:, 4]).max())
        print(f"kernel-5 path {label} ({route}, {steps} fused_prep steps "
              f"of 1080p NV12, each from the CPU's state): vs the CPU max|d "
              f"bbox| {d_box:.3e} px, max|d score| {d_score:.3e} "
              f"(tolerance {box_tol}, {score_tol}); vs the plain route "
              f"{r_box:.3e} px, {r_score:.3e} ({ROUTE_BOX_TOL}, "
              f"{ROUTE_SCORE_TOL}); launches {counts}, kernel 1 {v1}, "
              f"kernel 5 {v5}", flush=True)
        if counts != dict(counts, vit_encoder=n1, vit_block=0,
                          attention_single=0, attention_flash=0,
                          fused_prep_embed=steps) \
                or v1 != only(k1, n1) \
                or v5 != {v: steps if v == k5 else 0 for v in v5}:
            raise AssertionError(f"kernel-5 path {label} {route}: "
                                 f"launches {counts} {v1} {v5}")
        if not np.isfinite(got).all() or d_box > box_tol \
                or d_score > score_tol or r_box > ROUTE_BOX_TOL \
                or r_score > ROUTE_SCORE_TOL:
            raise AssertionError(f"kernel-5 path {label} {route} "
                                 f"disagrees with the CPU or the plain "
                                 f"route")
        out[route] = {
            "steps": steps, "launches": counts, "kernel1_variants": v1,
            "kernel5_variants": v5, "max_d_bbox_px": d_box,
            "max_d_score": d_score, "route_max_d_bbox_px": r_box,
            "route_max_d_score": r_score}
    return params, out


def prep_paths_phase(dev, card: str) -> dict:
    """Kernel 5 on the paths that run it, on the main path's 1080p NV12
    clip: the ``small`` preset as shipped (float32) through
    ``scan.update_scan_pool(..., fused_prep=True)`` (compiled, one step a
    call) and ``core.update_packed(..., fused_prep=True)`` (eager);
    corr-tiny (patch 8, K 192) eagerly; the D-768 bf16 model (PREP_WIDE,
    12 heads of 64) compiled.  Each step runs on the card from the state
    the port's CPU run of the same route had before it and is held to the
    CPU's step (float32: SMALL_BOX_TOL / SMALL_SCORE_TOL, corr-tiny's
    CORR_*; bf16 CPU_BOX_TOL / CPU_SCORE_TOL) and to the plain-route step
    on the card from the same state (ROUTE_BOX_TOL, ROUTE_SCORE_TOL).  The
    counts are set to 0 just before each route's steps and read just after:
    kernel 5 once a step, kernel 1 once a step where the model has blocks,
    each in the plan's variant, nothing else.  Then the compiled ``small``
    step run free: its launches over JIT_TIMED steps and its device busy ms
    a step (``torch.profiler``)."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.tracker import core, scan

    t_phase = time.perf_counter()
    frames, boxes = nv12_clip(PREP_PATH_STEPS + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    ys, uvs = (torch.stack([c[i] for c in clip]) for i in (0, 1))
    small, corr = PRESETS["small"], PRESETS["corr-tiny"]
    wide = ModelConfig(**PREP_WIDE)
    flat = random_flat(wide, seed=19)
    models = [
        ("small f32", small, lambda d: weights.load_npz(
            weights.checkpoint_path("small"), small, device=d),
         PREP_PATH_STEPS, ("compiled", "eager"), (SMALL_BOX_TOL,
                                                  SMALL_SCORE_TOL)),
        ("corr-tiny", corr, lambda d: vittrack.init_params(
            torch.Generator().manual_seed(0), corr, d), PREP_PATH_STEPS,
         ("eager",),
         (CORR_BOX_TOL, CORR_SCORE_TOL)),
        ("D 768 bf16", wide, lambda d: weights.params_from_flat(
            flat, wide, device=d), PREP_WIDE_STEPS, ("compiled",),
         (CPU_BOX_TOL, CPU_SCORE_TOL))]
    res = {}
    for label, cfg, load, steps, routes, tols in models:
        params, res[label] = prep_path(dev, label, cfg, load, steps, routes,
                                       tols, frames, boxes, clip, (ys, uvs))
        if label == "small f32":               # the compiled step run free
            st0 = core.init(params, clip[0], boxes[0], cfg, "nv12", dev)
            pool = (ys[1:].contiguous(), uvs[1:].contiguous())

            def free():
                return scan.update_scan_pool(params, st0, pool, JIT_TIMED,
                                             cfg, "nv12", fused_prep=True,
                                             device=dev)

            free()
            zero_counts()
            _, scores = free()
            counts, v5 = read_counts(), dict(fpe.VARIANT_LAUNCHES)
            t = traced_ms(free, 1, JIT_TIMED)
            print(f"kernel-5 path small f32 compiled, run free: "
                  f"{JIT_TIMED} steps a call, launches {counts}, kernel 5 "
                  f"{v5}; device busy ms a step (torch.profiler) "
                  f"{t['device_ms']:.4f}, host wall {t['host_ms']:.4f}, "
                  f"activities {t['activities']:.1f}, idle share "
                  f"{t['idle_share']:.3f} | {card}", flush=True)
            if counts["fused_prep_embed"] != JIT_TIMED \
                    or counts["vit_encoder"] != JIT_TIMED \
                    or v5[res[label]["kernel5"]] != JIT_TIMED \
                    or not torch.isfinite(scores).all():
                raise AssertionError(f"kernel-5 path small f32 run free: "
                                     f"launches {counts} {v5}")
            res[label]["free"] = {"steps": JIT_TIMED, "launches": counts, **t}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"kernel-5 paths: {res['seconds']:.1f} s | {card}", flush=True)
    return res


def prep_alone() -> dict:
    """Phase 3c (:func:`prep_phase`, on the flagship's shipped weights) and
    :func:`prep_paths_phase` on card 0 and nothing else, after the build.
    Run from the root of a checkout: ``python -c "import chip_smoke as c;
    c.prep_alone()"``."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    card = card_line()
    print(f"kernel 5 alone | {card}", flush=True)
    cfg = PRESETS["vittrack-t"]
    params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("vittrack-t"), cfg, device=dev))
    got = {"prep": prep_phase(dev, cfg, params),
           "paths": prep_paths_phase(dev, card)}
    print(json.dumps(got), flush=True)
    return got


# ---------------------------------------------------------------------------
# Phase 4d: ViT-L's and ViT-H's widths, past the resident LN products
# ---------------------------------------------------------------------------

# ViT-L/16's width, depth and heads (Dosovitskiy et al., "An Image is Worth
# 16x16 Words", Table 1: 24 layers, width 1024, MLP 4096, 16 heads) and
# ViT-H's width and heads (1280 and 16: head dim 80, MLP 5120) at a depth
# cut to 4, each on the flagship's crops, patch, conv head and grouped head,
# with seeded weights (random_flat).
WIDE_L = dict(embed_dim=1024, depth=24, num_heads=16)
WIDE_H = dict(embed_dim=1280, depth=4, num_heads=16)
WIDE_STEPS = 3            # compiled ViT-L steps a dtype, each from the CPU's state
WIDE_CPU_STREAMS = 2      # streams of the 16-stream tick held to the CPU
WIDE_PREP_STEPS = 2       # ViT-H update(fused_prep=True) steps a dtype
WIDE_SIMT_ITERS = 3       # simt by name at the float32 ViT-L shapes: a few launches
# The forced wide-form comparisons (bf16 prenormed, float32 streamed):
# (dtype, D, heads) where the rule keeps the LN products resident (bf16 D
# 768, float32 D 512 and the flagship's 192), at batch 1 and 16.
WIDE_FORCED = ((torch.bfloat16, 768, 12), (torch.float32, 512, 8),
               (torch.float32, 192, 3))
# flagship_outputs as the build of commit 374a250 (before the streamed LN
# products) made them on an H100: sha256 of their bits.  The flagship and
# small launch what that build launched, so they stay bit-equal.
FLAGSHIP_SHA256 = {
    "kernel1_bf16":
        "7bce52b243684d9b8b7c29c8de28834cbe7000561c50c1ac26d831c5f8c73b5f",
    "kernel1_small_bf16":
        "92c5b63b200a87ed72890f46382c3945d7baeb296571b68a3ce4788d8a796774",
    "kernel2_bf16":
        "2941cbb1a226cd197e4c658397fb11864474ba958472c5a203fcc3243bec58a1",
    "kernel5_bf16": PREP_BF16_FLAGSHIP_SHA256,        # phase 3c's, unchanged
    "kernel1_f32":
        "6e32c9de95e06db07184f4cf668c08824a14ea3f67a8a0a2b2d197d084b7900d",
    "kernel1_small_f32":
        "022d053934597158ac036588ecc84bd3014079b672a8b671271c83c891e283a1",
    "kernel2_f32":
        "d95ae984c758819062dbe253391242eec0801a471ba8553fa7c841a2f1b85145",
    "kernel5_f32":
        "4fe9d41b4f1257df882d439aa877f1aa83928f405e5abb9c18f26633999bf167"}


# wide_outputs as the build of commit ed9e50f (the streamed LN products,
# before the prenormed form) made them on an NVIDIA H100 80GB HBM3:
# sha256 of their bits.  The prenormed form keeps the LN rows' and the
# products' arithmetic, so every output stays bit-equal.
WIDE_SHA256 = {
    "kernel1_vit_l_bf16":
        "c35013d0c0280478a3b49638019327027afa04557bc12510c5fb6a5cf5485e71",
    "kernel2_vit_l_bf16":
        "2262b339efc381b36fe56680121ca650eb0027791befed3af50f3f531d2e5339",
    "kernel1_vit_h_bf16":
        "fafb0c729f6605f2d3fcfddcceabb54a0611fe2d23d8f3d17f019d8fd6d61bee",
    "kernel1_model_a_bf16":
        "475493f6893068516639e3ab6f005a16b63f696060e3c113a643657f4b7fc8b1",
    "kernel2_model_a_bf16":
        "cca8a89b43f94ab9cf9b3c97e0e20ae6a77a06f665a592e3e7750260c6b74336",
    # Model A's float32 ones as the build of commit 3d013a1 (the float32
    # panel attention before its redesign, a CTA a panel of o) made them:
    # the redesign keeps each thread's sums in their order.
    "kernel1_model_a_f32":
        "fa34d40a4f25faf70489b2b720d9e483beb5a33061243688025dcf73cbd93a36",
    "kernel2_model_a_f32":
        "77c81cc4b5203bb3f3353d2257194d2aecf44384d4a873f87395c70d2f1d9d37"}


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bits."""
    import hashlib

    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(torch.int16 if t.element_size() == 2
                                 else torch.int32).numpy().tobytes()
                          ).hexdigest()


def flagship_outputs(dev) -> dict:
    """Kernels 1, 2 and 5 on the shipped weights in both dtypes, on fixed
    inputs: kernel 1 on seeded (1, 320, 192) tokens (the flagship, 12
    blocks) and (1, 80, 96) ones (``small``, 4 blocks), kernel 2 on seeded
    (16, 320, 192) tokens through the flagship's block 5, kernel 5 on
    phase 3c's banded 1080p case.  What FLAGSHIP_SHA256 fixes."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import vit, weights
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    cfg, small = PRESETS["vittrack-t"], PRESETS["small"]
    params = weights.load_npz(weights.checkpoint_path("vittrack-t"), cfg,
                              device=dev)
    sparams = weights.load_npz(weights.checkpoint_path("small"), small,
                               device=dev)
    gen = torch.Generator(device="cpu").manual_seed(20)
    x1 = (2.0 * torch.randn((1, cfg.num_tokens, cfg.embed_dim),
                            generator=gen)).to(dev)
    x16 = (2.0 * torch.randn((SERVE_SLOTS, cfg.num_tokens, cfg.embed_dim),
                             generator=gen)).to(dev)
    xs = (2.0 * torch.randn((1, small.num_tokens, small.embed_dim),
                            generator=gen)).to(dev)
    rng = np.random.default_rng(11)
    y = torch.as_tensor(rng.integers(0, 256, (FRAME_H, FRAME_W),
                                     dtype=np.uint8), device=dev)
    uv = torch.as_tensor(rng.integers(0, 256, (FRAME_H // 2, FRAME_W // 2, 2),
                                      dtype=np.uint8), device=dev)
    win = pp.crop_window(torch.tensor((1500.0, 700.0, 64.0, 64.0),
                                      device=dev), cfg.search_factor)
    out = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        blocks = [vit.cast_params(p, dt) for p in params["backbone"]["blocks"]]
        sblocks = [vit.cast_params(p, dt)
                   for p in sparams["backbone"]["blocks"]]
        out[f"kernel1_{name}"] = vit_block.encoder(x1.to(dt), blocks,
                                                   cfg.num_heads)
        out[f"kernel1_small_{name}"] = vit_block.encoder(
            xs.to(dt), sblocks, small.num_heads)
        out[f"kernel2_{name}"] = vit_block.block(x16.to(dt), blocks[5],
                                                 cfg.num_heads)
        out[f"kernel5_{name}"] = fpe.nv12_search_tokens(
            params, y, uv, win, dataclasses.replace(cfg, dtype=str(dt)[6:]))
    torch.cuda.synchronize()
    return out


def wide_outputs(dev, name: str, cfg, params, seed: int,
                 dtype=torch.bfloat16) -> dict:
    """Kernel 1 in ``dtype`` on seeded (1, 320, D) tokens through every
    block of a wide model (``wide_model(dev, spec, seed)``: ViT-L, ViT-H's
    width, Model A) and, but for ViT-H, kernel 2 on seeded (16, 320, D) ones
    through its block 0, the tokens drawn from ``seed``: what WIDE_SHA256
    fixes."""
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    blocks = [vit.cast_params(p, dtype) for p in params["backbone"]["blocks"]]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x1 = (2.0 * torch.randn((1, cfg.num_tokens, cfg.embed_dim),
                            generator=gen)).to(dev, dtype)
    out = {f"kernel1_{name}_{tag}": vit_block.encoder(x1, blocks,
                                                      cfg.num_heads)}
    if name != "vit_h":
        x16 = (2.0 * torch.randn((SERVE_SLOTS, cfg.num_tokens, cfg.embed_dim),
                                 generator=gen)).to(dev, dtype)
        out[f"kernel2_{name}_{tag}"] = vit_block.block(x16, blocks[0],
                                                       cfg.num_heads)
    torch.cuda.synchronize()
    return out


def check_wide_sha256(dev, name: str, cfg, params, seed: int,
                      dtype=torch.bfloat16) -> dict:
    """``wide_outputs`` of one model in ``dtype`` against WIDE_SHA256: the
    prenormed products (every bf16 width above 768) give the bits of the
    build before them, and so does the float32 panel attention's redesign
    (Model A in float32)."""
    got = {k: digest(t) for k, t in wide_outputs(dev, name, cfg, params,
                                                 seed, dtype).items()}
    want = {k: WIDE_SHA256[k] for k in got}
    tag = str(dtype)[6:]
    print(f"{name} {tag} kernel 1 / 2 outputs, sha256 {json.dumps(got)}; "
          f"bit-equal to the recorded build's: {got == want}", flush=True)
    if got != want:
        raise AssertionError(f"{name}: {tag} kernel outputs are no longer "
                             f"bit-equal to the recorded build's")
    return got


def wide_model(dev, spec: dict, seed: int):
    """(config, params on the card, params on the CPU) of a wide model:
    ``spec`` on the flagship's ModelConfig, the grouped head, seeded
    float32 masters (random_flat) that both dtypes cast at use."""
    from gstreamer_vit_tracker_tpu_torch.config import ModelConfig
    from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights

    cfg = dataclasses.replace(ModelConfig(), **spec)
    flat = random_flat(cfg, seed)
    return cfg, *(vittrack.with_grouped_head(weights.params_from_flat(
        flat, cfg, device=d)) for d in (dev, torch.device("cpu")))


def seeded_blocks(dev, d: int, depth: int, dtype, seed: int):
    """``depth`` blocks of width ``d`` (MLP 4 d) with seeded weights, and a
    seeded (1, 320, d) and (16, 320, d) input, in ``dtype``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def w(*shape, std=0.1, base=0.0):
        return (base + std * torch.randn(shape, generator=gen)).to(dev, dtype)

    hid = 4 * d
    blocks = [{"ln1": {"scale": w(d, base=1.0), "bias": w(d)},
               "ln2": {"scale": w(d, base=1.0), "bias": w(d)},
               "qkv": {"kernel": w(d, 3 * d, std=d ** -0.5), "bias": w(3 * d)},
               "proj": {"kernel": w(d, d, std=d ** -0.5), "bias": w(d)},
               "mlp1": {"kernel": w(d, hid, std=d ** -0.5), "bias": w(hid)},
               "mlp2": {"kernel": w(hid, d, std=hid ** -0.5), "bias": w(d)}}
              for _ in range(depth)]
    return blocks, w(1, 320, d, std=1.0), w(SERVE_SLOTS, 320, d, std=1.0)


def forced_streamed(dev) -> dict:
    """Kernels 1 and 2 at the WIDE_FORCED shapes, where the rule keeps the
    LN products resident, launched as the rule plans them and again with
    the variant's wide form named (bf16 ``prenormed``, float32
    ``streamed``; bf16 with one and two warpgroups a CTA): bit for bit the
    same output."""
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    res = {}
    for dt, d, heads in WIDE_FORCED:
        blocks, x1, x16 = seeded_blocks(dev, d, 2, dt, d)
        flat = [p[m][f] for p in blocks for m, f in vit_block._FIELDS]
        for x, stacked in ((x1, True), (x16, False)):
            weights = (vit_block._stack(flat, 2) if stacked
                       else flat[:len(vit_block._FIELDS)])
            rule = vit_block._plan_for(x, heads, 4 * d)
            wide = vit_block._WIDE_LN[rule.variant]
            named = [rule._replace(ln=wide)]
            if wide == "prenormed":            # every build of the ring
                named += [rule._replace(ln=wide, warpgroups=2, tiles=(t,) * 4)
                          for t in (64, 128)]
            outs = []
            for chosen in [rule] + named:
                out, launch = vit_block.prepared(x, weights, heads, stacked,
                                                 chosen)
                launch()
                outs.append(out)
            torch.cuda.synchronize()
            same = all(torch.equal(outs[0], o) for o in outs[1:])
            label = (f"{'encoder' if stacked else 'block'} {tuple(x.shape)} "
                     f"{str(dt)[6:]}")
            forms = [(p.warpgroups, p.tiles) for p in named]
            print(f"{wide} LN form named at {label} (the rule: {rule.ln}, "
                  f"tiles {rule.tiles}; warpgroups and tiles {forms}): "
                  f"bit-equal to the rule's {same}", flush=True)
            if rule.ln != "resident" or not same:
                raise AssertionError(f"{label}: the {wide} LN form differs "
                                     f"from the resident one")
            res[label] = same
    return res


def check_tokens(what, got, plain, dtype) -> float:
    """Kernel 5's tokens against its plain version: float32 PREP_F32_ATOL,
    bf16 one output ulp at the largest plain value (PREP_BF16_REL)."""
    err = (got.float() - plain.float()).abs().max().item()
    tol = (PREP_F32_ATOL if dtype == torch.float32
           else PREP_BF16_REL * plain.float().abs().max().item())
    print(f"{what} vs plain: max|d| {err:.3e} (tolerance {tol:.3e})",
          flush=True)
    if got.shape != plain.shape or not torch.isfinite(got.float()).all() \
            or not err <= tol:
        raise AssertionError(f"{what} disagrees with its plain version")
    return err


def wide_prep(dev, card, cfg, params) -> dict:
    """Kernel 5 of ``cfg`` (ViT-H's D 1280; a patch above 32) in both
    dtypes on phase 3c's banded 1080p case and a window inside a small
    frame: the wrapper (one launch, the plan's variant) against both modes
    of its plain version, then on the banded case its device us a launch
    (CUDA-graph replay) beside the plain version, the unfused chain and the
    bound."""
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp

    rng = np.random.default_rng(11)
    cases = []
    for (h, w), box in (((FRAME_H, FRAME_W), (1500.0, 700.0, 64.0, 64.0)),
                        ((512, 640), (300.0, 200.0, 64.0, 64.0))):
        cases.append((torch.as_tensor(rng.integers(0, 256, (h, w),
                                                   dtype=np.uint8), device=dev),
                      torch.as_tensor(rng.integers(0, 256, (h // 2, w // 2, 2),
                                                   dtype=np.uint8), device=dev),
                      box))
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=str(dt)[6:])
        chosen = fpe.plan(c.embed_dim, dt)
        rows = fpe.piece_rows(c.patch_size, chosen.variant)
        what = (f"fused_prep_embed D {c.embed_dim} patch {c.patch_size} "
                f"({rows} patch rows a piece)")
        errs = []
        for y, uv, box in cases:
            win = pp.crop_window(torch.tensor(box, device=dev), c.search_factor)
            before = dict(fpe.VARIANT_LAUNCHES)
            got = fpe.nv12_search_tokens(params, y, uv, win, c)
            torch.cuda.synchronize()
            if fpe.VARIANT_LAUNCHES != dict(before, **{
                    chosen.variant: before[chosen.variant] + 1}):
                raise AssertionError(f"{what}: not one {chosen.variant} "
                                     f"launch")
            errs += [check_tokens(
                f"{what} {c.dtype} {chosen.variant} {tiling_name(chosen)} W "
                f"{chosen.width}, window {box}, mode {mode!r}", got,
                fpe.nv12_search_tokens_reference(
                    params, y, uv, win, c, mode), dt) for mode in fpe.MODES]
        y, uv, box = cases[0]
        win = pp.crop_window(torch.tensor(box, device=dev), c.search_factor)
        _, launch = fpe.prepared(params, y, uv, win, c)

        def chain():
            x_img = pp.preprocess_nv12(y, uv, win, c.search_size, c.norm_mean,
                                       c.norm_std, dtype=dt,
                                       band=c.preprocess_band)
            return vit.embed_search(params["backbone"], x_img[None], c)

        row = {"variant": chosen.variant, "plan": list(chosen),
               "piece_rows": rows,
               "max_abs_err": max(errs), "device_us": graph_us(launch),
               "plain_ms": cuda_ms(lambda: fpe.nv12_search_tokens_reference(
                   params, y, uv, win, c), iters=10, warmup=2),
               "chain_ms": cuda_ms(chain, iters=20, warmup=3),
               "launch_ms": cuda_ms(lambda: fpe.launch(*fpe.kernel_operands(
                   params, y, uv, win, c), c), iters=20),
               "library_ms": None}
        row["device_us_again"] = graph_us(launch)
        row.update(prep_bound(win, y.shape, c))
        res[c.dtype] = row
        print(f"{what} {c.dtype} ({chosen}), 1080p "
              f"banded: device us a launch (CUDA graph of {GRAPH_LAUNCHES}) "
              f"{row['device_us']:.2f} / {row['device_us_again']:.2f}; one "
              f"launch {row['launch_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, unfused chain {row['chain_ms']:.4f} "
              f"(no library call computes it); bound "
              f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
              f"(operations {row['ops_ms'] * 1e3:.3f} us, "
              f"{row['mbytes']:.3f} MB -> {row['bytes_ms'] * 1e3:.3f} us) "
              f"| {card}", flush=True)
    return res


def model_crops(dev, cfg, params) -> list:
    """LN_CROPS encoder inputs of a model on the main-path clip: its
    template tokens of frame 0 and the search tokens of frames 1 to
    LN_CROPS around their drawn boxes, the model's own embed (the final-LN
    yardstick's crops)."""
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    frames, boxes = nv12_clip(LN_CROPS + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    z0 = core.init(params, clip[0], boxes[0], cfg, "nv12", dev).z_tok
    crops = []
    for i in range(1, LN_CROPS + 1):
        win = pp.crop_window(torch.tensor(boxes[i], device=dev),
                             cfg.search_factor)
        tok = vit.embed_search(params["backbone"], core._prep_nv12(
            clip[i], win, cfg.search_size, cfg)[None], cfg)
        crops.append(torch.cat([z0[None], tok], dim=1).contiguous())
    return crops


def wide_kernels(dev, card, lcfg, lparams, hcfg, hparams) -> dict:
    """Kernels 1, 2 and 5 at the wide shapes against their plain versions,
    timed (``timed_kernel``, ``wide_prep``): kernel 1 at ViT-L's (1, 320,
    1024) x 24 on the real tokens of a search crop of the main-path clip
    (the model's own embed), bf16 (``mma``, prenormed) with
    ``final_ln_check``'s yardstick on LN_CROPS crops (over 24 blocks the
    kernel and the twin part by 2.4 % of max|twin| on an NVIDIA H100 80GB
    HBM3 at 700 W, each as close to exact arithmetic as the other:
    ENC_REL_TOL, read at the flagship's 12 blocks, is printed and not
    asserted), float32 (``tf32x3``, streamed, ``simt`` by
    name over WIDE_SIMT_ITERS launches) at F32_ATOL;
    kernel 2 at (16, 320, 1024) on 16 crops through block 0 in both dtypes;
    kernel 1 at ViT-H's (1, 320, 1280) x 4 in both dtypes against the twin;
    kernel 5 at D 1280; the wide form named where the rule keeps the
    resident one (``forced_streamed``); the flagship's and small's outputs
    against FLAGSHIP_SHA256, ViT-L's and ViT-H's bf16 ones against
    WIDE_SHA256."""
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    res = {"forced_streamed": forced_streamed(dev)}
    got = {k: digest(t) for k, t in flagship_outputs(dev).items()}
    print(f"flagship and small kernel 1 / 2 / 5 outputs, sha256 "
          f"{json.dumps(got)}; bit-equal to the build before the streamed LN "
          f"products: {got == FLAGSHIP_SHA256}", flush=True)
    if got != FLAGSHIP_SHA256:
        raise AssertionError("the flagship's or small's kernel outputs are no "
                             "longer bit-equal to the build before")
    res["flagship_sha256"] = got
    res["wide_sha256"] = {
        **check_wide_sha256(dev, "vit_l", lcfg, lparams, 24),
        **check_wide_sha256(dev, "vit_h", hcfg, hparams, 80)}

    heads, hidden = lcfg.num_heads, int(lcfg.embed_dim * lcfg.mlp_ratio)
    crops = model_crops(dev, lcfg, lparams)
    x1, x16 = crops[0], torch.cat(crops, 0)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        blocks = [vit.cast_params(p, dt) for p in lparams["backbone"]["blocks"]]
        for x, stacked in ((x1.to(dt), True), (x16.to(dt), False)):
            chosen = vit_block._plan_for(x, heads, hidden)
            print(f"ViT-L {name} plan at batch {x.shape[0]}: {chosen}",
                  flush=True)
            variant = vit_block._VARIANTS[dt]
            if chosen.variant != variant \
                    or chosen.ln != vit_block._WIDE_LN[variant]:
                raise AssertionError(f"ViT-L {name}: expected the "
                                     f"{vit_block._WIDE_LN[variant]} "
                                     f"{variant}, the plan is {chosen}")
            if stacked:
                key, row = f"kernel1_{name}", timed_kernel(
                    f"encoder ViT-L {tuple(x.shape)} x {lcfg.depth} {name}",
                    x, blocks, heads, True,
                    lambda x=x, b=blocks: vit_block.encoder(x, b, heads),
                    simt_iters=WIDE_SIMT_ITERS, held=dt == torch.float32)
            else:
                key, row = f"kernel2_{name}", timed_kernel(
                    f"block ViT-L {tuple(x.shape)} {name}", x, [blocks[0]],
                    heads, False,
                    lambda x=x, b=blocks[0]: vit_block.block(x, b, heads),
                    simt_iters=WIDE_SIMT_ITERS)
            res[key] = dict(row, plan=list(chosen))
        if dt == torch.bfloat16:
            res["kernel1_bfloat16"]["final_ln"] = final_ln_check(
                lcfg, lparams, blocks, [c.to(dt) for c in crops], x1.to(dt))
    del crops, x16

    # ViT-H's kernel 1 against its twin, and kernel 5 at its D.
    hblocks = hparams["backbone"]["blocks"]
    gen = torch.Generator(device="cpu").manual_seed(1280)
    xh = torch.randn((1, hcfg.num_tokens, hcfg.embed_dim), generator=gen)
    for dt in (torch.bfloat16, torch.float32):
        x = xh.to(dev, dt)
        blocks = [vit.cast_params(p, dt) for p in hblocks]
        chosen = vit_block._plan_for(x, hcfg.num_heads, 4 * hcfg.embed_dim)
        res[f"kernel1_vit_h_{str(dt)[6:]}"] = {"plan": list(chosen),
                                               "max_abs_err": check_kernel(
            f"encoder ViT-H {tuple(x.shape)} x {hcfg.depth} {str(dt)[6:]} "
            f"({chosen})", vit_block.encoder(x, blocks, hcfg.num_heads),
            vit_block.encoder_reference(x, blocks, hcfg.num_heads), dt)}
    res["kernel5"] = wide_prep(dev, card, hcfg, hparams)
    return res


def compiled_steps(dev, card, label, lcfg, lparams, lcparams, steps) -> dict:
    """``core.init`` then ``steps`` compiled ``update_packed_jit`` steps of
    a model in bf16 and in float32, each on the card from the CPU's state
    before it and held to the CPU's step (bf16 CPU_BOX_TOL /
    CPU_SCORE_TOL, float32 SMALL_BOX_TOL / SMALL_SCORE_TOL), the counts set
    to 0 just before the steps and read just after: kernel 1 once a step in
    the plan's variant, nothing else (no ``simt``).  The model's graphs are
    dropped at the end."""
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    cpu = torch.device("cpu")
    res = {}
    frames, boxes = nv12_clip(steps + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    for dtype, tols in (("bfloat16", (CPU_BOX_TOL, CPU_SCORE_TOL)),
                        ("float32", (SMALL_BOX_TOL, SMALL_SCORE_TOL))):
        cfg = dataclasses.replace(lcfg, dtype=dtype)
        variant = vit_block._VARIANTS[getattr(torch, dtype)]
        cst = core.init(lcparams, frames[0], boxes[0], cfg, "nv12", cpu)
        gst = core.init(lparams, clip[0], boxes[0], cfg, "nv12", dev)
        d_z = (gst.z_tok.float().cpu() - cst.z_tok.float()).abs().max().item()
        zero_counts()
        worst_box = worst_score = 0.0
        for i in range(steps):
            held = type(cst)(*(t.to(dev) for t in cst))
            _, gout = core.update_packed_jit(lparams, held, clip[i + 1], cfg,
                                             "nv12", dev)
            cst, cout = core.update_packed(lcparams, cst, frames[i + 1], cfg,
                                           "nv12", cpu)
            gout, cout = gout.cpu().numpy(), cout.numpy()
            if not np.isfinite(gout).all():
                raise AssertionError(f"{label} {dtype} step: non-finite")
            worst_box = max(worst_box, float(np.abs(gout[:4] - cout[:4]).max()))
            worst_score = max(worst_score, float(abs(gout[4] - cout[4])))
        counts, by_variant = read_counts(), dict(vit_block.VARIANT_LAUNCHES)
        print(f"{label} {dtype} compiled (init, then update_packed_jit, 1080p "
              f"NV12): template tokens vs the CPU's max|d| {d_z:.3e}; "
              f"{steps} steps each from the CPU's state: max|d bbox| "
              f"{worst_box:.3e} px, max|d score| {worst_score:.3e} (tolerance "
              f"{tols[0]} px, {tols[1]}); launches {counts} ({by_variant}) "
              f"| {card}", flush=True)
        if counts != dict(counts, vit_encoder=steps, vit_block=0,
                          attention_single=0, attention_flash=0,
                          fused_prep_embed=0) \
                or by_variant != only(variant, steps):
            raise AssertionError(f"{label} {dtype} compiled: launches {counts} "
                                 f"{by_variant}, expected kernel 1 "
                                 f"({variant}) once a step")
        if worst_box > tols[0] or worst_score > tols[1]:
            raise AssertionError(f"{label} {dtype} compiled step disagrees with "
                                 f"the CPU")
        res[f"step_{dtype}"] = {
            "steps": steps, "variant": variant, "launches": counts,
            "launches_by_variant": by_variant, "max_d_bbox_px": worst_box,
            "max_d_score": worst_score, "template_max_abs_err": d_z}
    core.update_packed_jit.drop(lparams)     # the model's graphs' buffers go
    return res


def block_path(dev, label, lcfg, lparams, seed) -> dict:
    """A model's blocks in bf16 chained through
    ``models/vit.py::_block(fused=True)`` at B=16 on seeded tokens, the
    counts set to 0 just before and read just after: kernel 2 once a
    block (``mma``), nothing else, the output equal to kernel 1's bit for
    bit."""
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x16 = torch.randn((SERVE_SLOTS, lcfg.num_tokens, lcfg.embed_dim),
                      generator=gen).to(dev, torch.bfloat16)
    blocks = [vit.cast_params(p, torch.bfloat16)
              for p in lparams["backbone"]["blocks"]]
    zero_counts()
    x = x16
    for bp in blocks:
        x = vit._block(x, bp, lcfg.num_heads, fused=True)
    block_counts, by_variant = read_counts(), dict(vit_block.VARIANT_LAUNCHES)
    same = torch.equal(x, vit_block.encoder(x16, blocks, lcfg.num_heads))
    print(f"{label} bf16 block path: {lcfg.depth} blocks through "
          f"_block(fused=True) at B={SERVE_SLOTS}: launches {block_counts} "
          f"({by_variant}); equal to the encoder kernel bit for bit: {same}",
          flush=True)
    if block_counts != dict(block_counts, vit_encoder=0, vit_block=lcfg.depth,
                            attention_single=0, attention_flash=0,
                            fused_prep_embed=0) \
            or by_variant != only("mma", lcfg.depth) or not same:
        raise AssertionError(f"{label} block path: wrong launches or output")
    return {"launches": block_counts, "launches_by_variant": by_variant}


def wide_paths(dev, card, lcfg, lparams, lcparams, hcfg, hparams_load) -> dict:
    """The wide models on the paths a user calls, the counts set to 0 just
    before each part and read just after: ViT-L ``core.init`` then
    WIDE_STEPS compiled ``update_packed_jit`` steps in bf16 and in float32,
    each on the card from the CPU's state before it and held to the CPU's
    step (bf16 CPU_BOX_TOL / CPU_SCORE_TOL, float32 SMALL_BOX_TOL /
    SMALL_SCORE_TOL), kernel 1 once a step in the plan's variant and no
    ``simt``; one 16-stream ``multi.update_streams`` tick on 1080p NV12
    (kernel 3 depth times), streams 0 to WIDE_CPU_STREAMS - 1 held to the
    CPU's tick from the card's state; the 24 blocks chained through
    ``models/vit.py::_block(fused=True)`` at B=16 (kernel 2 24 times, equal
    to kernel 1 bit for bit); ViT-H (depth 4) through
    ``core.update_packed(fused_prep=True)`` in both dtypes (``prep_path``:
    kernel 5 at D 1280 and kernel 1 once a step)."""
    from gstreamer_vit_tracker_tpu_torch.tracker import core, multi

    cpu = torch.device("cpu")
    res = compiled_steps(dev, card, "ViT-L", lcfg, lparams, lcparams,
                         WIDE_STEPS)

    # One 16-stream tick (kernel 3), streams 0-1 against the CPU's tick.
    clips = stream_clips(SERVE_SLOTS, 2)
    f0 = tuple(np.stack([c[0][0][i] for c in clips]) for i in (0, 1))
    f1 = tuple(np.stack([c[0][1][i] for c in clips]) for i in (0, 1))
    boxes16 = np.asarray([[c[1][0]] for c in clips], np.float32)
    active = np.ones((SERVE_SLOTS, 1), bool)
    st = multi.init_streams(lparams, f0, boxes16, lcfg, device=dev,
                            frame_format="nv12")
    n = WIDE_CPU_STREAMS
    cst = type(st)(*(t[:n].to(cpu, copy=True) for t in st))
    zero_counts()
    _, gb, gc = multi.update_streams(lparams, st, f1, active, lcfg,
                                     device=dev, frame_format="nv12")
    torch.cuda.synchronize()
    tick_counts = read_counts()
    _, cb, cc = multi.update_streams(lcparams, cst, tuple(f[:n] for f in f1),
                                     active[:n], lcfg, device=cpu,
                                     frame_format="nv12")
    d_box = float((gb[:n].cpu() - cb).abs().max())
    d_score = float((gc[:n].cpu() - cc).abs().max())
    print(f"ViT-L bf16 tick: multi.update_streams at {SERVE_SLOTS} streams of "
          f"1080p NV12, launches {tick_counts}; streams 0-{n - 1} against the "
          f"CPU's tick from the card's state: max|d bbox| {d_box:.4f} px, "
          f"max|d score| {d_score:.5f} (tolerance {CPU_BOX_TOL} px, "
          f"{CPU_SCORE_TOL})", flush=True)
    if tick_counts != dict(tick_counts, vit_encoder=0, vit_block=0,
                           attention_single=lcfg.depth, attention_flash=0,
                           fused_prep_embed=0) \
            or not torch.isfinite(gb).all() or d_box > CPU_BOX_TOL \
            or d_score > CPU_SCORE_TOL:
        raise AssertionError("ViT-L tick: wrong launches or disagrees with "
                             "the CPU")
    res["tick"] = {"streams": SERVE_SLOTS, "launches": tick_counts,
                   "max_d_bbox_px": d_box, "max_d_score": d_score}

    # The 24 blocks through _block(fused=True) at B=16 (kernel 2).
    res["block_path"] = block_path(dev, "ViT-L", lcfg, lparams, seed=1024)

    # ViT-H through update_packed(fused_prep=True) in both dtypes.
    pframes, pboxes = nv12_clip(WIDE_PREP_STEPS + 1)
    pclip = [core._frame_on(f, "nv12", dev) for f in pframes]
    pool = tuple(torch.stack([c[i] for c in pclip]) for i in (0, 1))
    for dtype, tols in (("bfloat16", (CPU_BOX_TOL, CPU_SCORE_TOL)),
                        ("float32", (SMALL_BOX_TOL, SMALL_SCORE_TOL))):
        cfg = dataclasses.replace(hcfg, dtype=dtype)
        _, res[f"vit_h_{dtype}"] = prep_path(
            dev, f"ViT-H {dtype}", cfg, hparams_load, WIDE_PREP_STEPS,
            ("eager",), tols, pframes, pboxes, pclip, pool)
    return res


def wide_phase(dev, card: str) -> dict:
    """ViT-L's and ViT-H's widths (WIDE_L, WIDE_H), where kernels 1 and 2
    stream their LN products and kernel 5 runs above D 1024:
    ``wide_kernels`` then ``wide_paths``; nothing falls back to a plain
    version or the CPU, and no float32 path launches ``simt``."""
    t_phase = time.perf_counter()
    lcfg, lparams, lcparams = wide_model(dev, WIDE_L, seed=24)
    hcfg, hparams, hcparams = wide_model(dev, WIDE_H, seed=80)
    res = {"kernels": wide_kernels(dev, card, lcfg, lparams, hcfg, hparams)}
    res["paths"] = wide_paths(
        dev, card, lcfg, lparams, lcparams, hcfg,
        lambda d: hparams if d.type == "cuda" else hcparams)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"wide phase: {res['seconds']:.1f} s | {card}", flush=True)
    return res


def wide_alone() -> dict:
    """:func:`wide_phase` on card 0 and nothing else, after the build.  Run
    from the root of a checkout: ``python -c "import chip_smoke as c;
    c.wide_alone()"``."""
    from gstreamer_vit_tracker_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    card = card_line()
    print(f"wide widths alone | {card}", flush=True)
    got = wide_phase(dev, card)
    print(json.dumps(got), flush=True)
    return got


# ---------------------------------------------------------------------------
# Phase 4e: head dims above 128 and patches above 32
# ---------------------------------------------------------------------------

# Model A: ViT-L/16's width, depth and MLP (WIDE_L) in 4 heads of 256, the
# head dim of Gemma 7B's attention (Gemma Team 2024, Table 1), where the
# attention of kernels 1-4 runs in 64-column panels; Model B: the flagship
# (ModelConfig()) at patch 64, its crops of 4 template and 16 search tokens,
# where kernel 5 walks its K in pieces of patch rows.  Both on seeded
# weights (random_flat); Model B's drawn at HEADS_B_STD, since at
# random_flat's 0.02 its 4 x 4 score map is flat to a few 1e-4 and the
# step's argmax a near-tie that another summation order of the same
# function can move by a 64-pixel cell.
HEADS_A = dict(embed_dim=1024, depth=24, num_heads=4)
HEADS_B = dict(patch_size=64)
HEADS_B_STD = 0.05
HEADS_STEPS = 3           # compiled Model A steps a dtype, each from the CPU's state
HEADS_TICKS = 3           # ticks of a 16-slot engine, Model A bf16
HEADS_CPU_SLOTS = 2       # slots of each tick held to the CPU engine
HEADS_TRAIN = dict(steps=3, depth=2, batch=4)   # Model A float32 train_step s
HEADS_PREP_STEPS = 5      # Model B steps a route and a dtype
HEADS_ATT_DH = (136, 192, 256)
# Kernel 5 at a patch above 32: (patch, search), template search / 2.
HEADS_PATCHES = ((48, 192), (64, 256))


def panel_attention_case(bh, s, dh, dtype, dev, route=None,
                         timed=False, group=None) -> dict:
    """Kernels 3 and 4 at a head dim above 128 on seeded (bh, s, dh)
    tensors against ``attention_reference``: ``flash_attention`` (the
    plan's route, one launch) or, with ``route``, that route by name on
    ready operands (``prepared``), float32 at G = ``group`` panels of o a
    CTA (default the plan's).  ``timed``: device us a launch in a
    replayed CUDA graph beside ``scaled_dot_product_attention``'s, the
    plain version's ms and the bound (bf16 at bf16's rate, float32 as split
    TF32's three products at TF32's; every input read and the output
    written once)."""
    from gstreamer_vit_tracker_tpu_torch.ops import attention

    gen = torch.Generator(device="cpu").manual_seed(1000 * s + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=gen).to(dev, dtype)
               for _ in range(3))
    plain = attention.attention_reference(q, k, v)
    chosen = attention._plan_for(dev, s, dh, dtype, bh)
    if route is not None and (route != chosen.route or group is not None):
        stages = 0
        if chosen.variant == "tf32x3":
            # float32 by name: G panels of o, tf32_panel_stages' ring.
            chosen = chosen._replace(group=group or chosen.group)
            if route == "flash":
                stages = attention.tf32_panel_stages(
                    -(-dh // 64), chosen.group, attention.card(dev)[0])
        elif chosen.variant == "mma":
            # bf16 by name: flash at the plan's G and panel_stages' ring;
            # single at the largest G whose CTA holds every key.
            panels, optin = (chosen.pad or dh) // 64, attention.card(dev)[0]
            if route == "flash":
                stages = attention.panel_stages(panels, chosen.group, optin)
            else:
                chosen = chosen._replace(group=max(
                    g for g in range(1, 5) if panels % g == 0
                    and attention.smem_bytes("single", "mma", s, panels * 64,
                                             2, 64, 0, 1, g) <= optin))
        chosen = chosen._replace(route=route, stages=stages)
    before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
    if route is None:
        out = attention.flash_attention(q, k, v)
    else:
        out, launch = attention.prepared(q, k, v, chosen=chosen)
        launch()
        out = out[..., :dh]
    torch.cuda.synchronize()
    if attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES != before + 1:
        raise AssertionError("panel attention did not launch once")
    err = (out.float() - plain.float()).abs().max().item()
    tol = (ATT_F32_ATOL if dtype == torch.float32
           else ATT_BF16_REL * plain.float().abs().max().item())
    name = (f"attention_{chosen.route} ({bh}, {s}, {dh}) {str(dtype)[6:]} "
            f"{chosen.variant}{' by name' if route else ''}, pad "
            f"{chosen.pad or 'none'}, G {chosen.group}")
    print(f"{name}: max|d| {err:.3e} (tolerance {tol:.3e})", flush=True)
    if out.dtype != dtype or not torch.isfinite(out.float()).all() \
            or not err <= tol:
        raise AssertionError(f"{name} disagrees with attention_reference")
    res = {"shape": [bh, s, dh], "route": chosen.route,
           "variant": chosen.variant, "pad": chosen.pad, "plan": list(chosen),
           "max_abs_err": err}
    if not timed:
        return res
    _, launch = attention.prepared(q, k, v, chosen=chosen)
    q4, k4, v4 = (t[None] for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4)

    res["device_us"] = graph_us(launch)
    res["library_device_us"] = graph_us(library)
    res["device_us_again"] = graph_us(launch)
    res["ms"] = cuda_ms(launch)
    res["plain_ms"] = cuda_ms(lambda: attention.attention_reference(q, k, v),
                              iters=20, warmup=3)
    res["library_ms"] = cuda_ms(library)
    flops = 4 * s * s * dh * bh
    nbytes = 4 * q.numel() * q.element_size()
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    t_ops = (3 * flops / H100_TF32_FLOPS if dtype == torch.float32
             else flops / H100_BF16_FLOPS) * 1e3
    res["bound_ms"] = max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    print(f"{name} ms (CUDA events): one launch on ready operands "
          f"{res['ms']:.4f}, plain {res['plain_ms']:.4f}, "
          f"scaled_dot_product_attention {res['library_ms']:.4f}; device us a "
          f"launch (CUDA graph of {GRAPH_LAUNCHES}): {res['device_us']:.2f} / "
          f"{res['device_us_again']:.2f}, scaled_dot_product_attention "
          f"{res['library_device_us']:.2f}; bound {res['bound_ms'] * 1e3:.2f} "
          f"us by {res['bound_by']} ({flops / 1e9:.3f} GFLOP -> "
          f"{t_ops * 1e3:.2f} us, {nbytes / 1e6:.2f} MB -> "
          f"{t_bytes * 1e3:.2f} us) | {card_line()}", flush=True)
    return res


def panel_attention(dev) -> dict:
    """Kernels 3 and 4 at head dims 136, 192 and 256 in both dtypes: at
    each dh the plan's route at S 320 (Model A's shapes: bf16 its 16-slot
    tick's (64, 320, dh), float32 its training batch's (16, 320, dh); flash
    at every one) timed, float32 also at every other G by name; at a short
    S both routes, the plan's and the other by name where its CTA fits the
    card, both timed: bf16 at S 100 (the plan's single, flash by name; at dh
    256 the plan's flash at G 2, single by name at G 4), float32 at S 64
    (the plan's single at G 1, flash by name)."""
    from gstreamer_vit_tracker_tpu_torch.ops import attention

    optin = attention.card(dev)[0]
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        bh = SERVE_SLOTS * HEADS_A["num_heads"] if dtype == torch.bfloat16 \
            else HEADS_TRAIN["batch"] * HEADS_A["num_heads"]
        for dh in HEADS_ATT_DH:
            cases = [panel_attention_case(bh, 320, dh, dtype, dev,
                                          timed=True)]
            if dtype == torch.float32:
                taken = attention._plan_for(dev, 320, dh, dtype, bh).group
                cases += [panel_attention_case(bh, 320, dh, dtype, dev,
                                               "flash", True, g)
                          for g in (1, 2, 3, 4)
                          if -(-dh // 64) % g == 0 and g != taken]
            short = 100 if dtype == torch.bfloat16 else 64
            plan = attention._plan_for(dev, short, dh, dtype, bh)
            for route in ("single", "flash"):
                pad = plan.pad or dh
                stages = 0 if route == "single" else (
                    attention.panel_stages(pad // 64, plan.group, optin)
                    if plan.variant == "mma" else
                    attention.tf32_panel_stages(-(-pad // 64), plan.group,
                                                optin))
                if route == plan.route or attention.smem_bytes(
                        route, plan.variant, short, pad, 0, 64, stages, 1,
                        plan.group) <= optin:
                    cases.append(panel_attention_case(
                        bh, short, dh, dtype, dev,
                        None if route == plan.route else route,
                        timed=True))
            res[f"dh{dh}_{name}"] = cases
    return res


def panel_encoders(dev, card, acfg, aparams) -> dict:
    """Kernels 1 and 2 at head dims above 128: Model A's kernel 1 at (1,
    320, 1024) x 24 on the real tokens of LN_CROPS search crops of the
    main-path clip in bf16 (after the final LN against the float64 chain,
    as ``wide_kernels`` holds ViT-L's) and float32 (F32_ATOL), kernel 2 at
    (16, 320, 1024) in both, each timed (``timed_kernel``: the library, the
    bound; no ``simt``, which stops at a head dim of 128); and at dh 192 (D
    768, 4 heads, 2 seeded blocks) kernel 1 at (1, 320, 768) and kernel 2
    at (16, 320, 768) in both dtypes against the twin."""
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    heads, hidden = acfg.num_heads, int(acfg.embed_dim * acfg.mlp_ratio)
    crops = model_crops(dev, acfg, aparams)
    x1, x16 = crops[0], torch.cat(crops, 0)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        blocks = [vit.cast_params(p, dt) for p in aparams["backbone"]["blocks"]]
        for x, stacked in ((x1.to(dt), True), (x16.to(dt), False)):
            chosen = vit_block._plan_for(x, heads, hidden)
            print(f"Model A {name} plan at batch {x.shape[0]}: {chosen}",
                  flush=True)
            if chosen.variant != vit_block._VARIANTS[dt] \
                    or (chosen.pad or 256) != 256:
                raise AssertionError(f"Model A {name}: the plan is {chosen}")
            if stacked:
                key, row = f"kernel1_{name}", timed_kernel(
                    f"encoder Model A {tuple(x.shape)} x {acfg.depth} dh 256 "
                    f"{name}", x, blocks, heads, True,
                    lambda x=x, b=blocks: vit_block.encoder(x, b, heads),
                    simt_iters=0, held=dt == torch.float32)
            else:
                key, row = f"kernel2_{name}", timed_kernel(
                    f"block Model A {tuple(x.shape)} dh 256 {name}", x,
                    [blocks[0]], heads, False,
                    lambda x=x, b=blocks[0]: vit_block.block(x, b, heads),
                    simt_iters=0)
            res[key] = dict(row, plan=list(chosen))
        if dt == torch.bfloat16:
            res["kernel1_bfloat16"]["final_ln"] = final_ln_check(
                acfg, aparams, blocks, [c.to(dt) for c in crops], x1.to(dt))
    del crops, x16
    for dt in (torch.bfloat16, torch.float32):
        blocks, xa, xb = seeded_blocks(dev, 768, 2, dt, 192)
        before = dict(vit_block.VARIANT_LAUNCHES)
        got = vit_block.encoder(xa, blocks, 4)
        one = vit_block.block(xb, blocks[0], 4)
        variant = vit_block._VARIANTS[dt]
        if vit_block.VARIANT_LAUNCHES != dict(before, **{
                variant: before[variant] + 2}):
            raise AssertionError("dh 192: not one launch each of the plan's "
                                 "variant")
        res[f"dh192_{str(dt)[6:]}"] = {
            "encoder": check_kernel(
                f"encoder (1, 320, 768) x 2, 4 heads of 192, {str(dt)[6:]}",
                got, vit_block.encoder_reference(xa, blocks, 4), dt),
            "block": check_kernel(
                f"block (16, 320, 768), 4 heads of 192, {str(dt)[6:]}", one,
                vit_block.block_reference(xb, blocks[0], 4), dt)}
    return res


def panel_tick(dev, card, acfg, aparams, acparams) -> dict:
    """Model A in bf16 behind a 16-slot ``SlotEngine`` (its compiled tick:
    the per-block route, whose attention is kernel 3 or 4 as the plan gives
    it at (64, 320, 256): flash) over HEADS_TICKS ticks of 1080p NV12, slots
    0 to HEADS_CPU_SLOTS - 1 of each held to the port's CPU engine given
    the card's state before the tick; the counts set to 0 just before the
    ticks and read just after: the plan's attention kernel depth times a
    tick, nothing else."""
    from gstreamer_vit_tracker_tpu_torch.ops import attention
    from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine

    cpu, n = torch.device("cpu"), HEADS_CPU_SLOTS
    dh = acfg.embed_dim // acfg.num_heads
    route = attention._plan_for(dev, acfg.num_tokens, dh, torch.bfloat16,
                                SERVE_SLOTS * acfg.num_heads).route
    engine = SlotEngine(aparams, acfg, slots=SERVE_SLOTS, snapshot_every=0,
                        device=dev)
    cpu_engine = SlotEngine(acparams, acfg, slots=n, snapshot_every=0,
                            device=cpu)
    cpu_engine.occupied[:] = True
    clips = stream_clips(SERVE_SLOTS, HEADS_TICKS + 1)
    for k in range(SERVE_SLOTS):
        engine.init_slot(engine.alloc(), clips[k][0][0], clips[k][1][0])
    active = np.ones(SERVE_SLOTS, bool)
    worst_box = worst_score = 0.0
    zero_counts()
    for t in range(1, HEADS_TICKS + 1):
        ys = np.stack([clips[k][0][t][0] for k in range(SERVE_SLOTS)])
        uvs = np.stack([clips[k][0][t][1] for k in range(SERVE_SLOTS)])
        cpu_engine.state = type(engine.state)(
            *(leaf[:n].to(cpu, copy=True) for leaf in engine.state))
        packed = engine.step((ys, uvs), active)
        want = cpu_engine.step((ys[:n], uvs[:n]), np.ones(n, bool))
        if packed.shape != (SERVE_SLOTS, 5) or not np.isfinite(packed).all():
            raise AssertionError("Model A tick: non-finite or misshapen")
        worst_box = max(worst_box, float(np.abs(packed[:n, :4]
                                                - want[:, :4]).max()))
        worst_score = max(worst_score, float(np.abs(packed[:n, 4]
                                                    - want[:, 4]).max()))
    counts = read_counts()
    want_counts = dict(counts, vit_encoder=0, vit_block=0, attention_single=0,
                       attention_flash=0, fused_prep_embed=0)
    want_counts[f"attention_{route}"] = acfg.depth * HEADS_TICKS
    print(f"Model A bf16 engine: {HEADS_TICKS} compiled ticks x {SERVE_SLOTS} "
          f"slots of 1080p NV12 (the plan's attention route {route}); slots "
          f"0-{n - 1} against the CPU engine from the card's state: max|d "
          f"bbox| {worst_box:.4f} px, max|d score| {worst_score:.5f} "
          f"(tolerance {CPU_BOX_TOL} px, {CPU_SCORE_TOL}); launches {counts} "
          f"| {card}", flush=True)
    if counts != want_counts:
        raise AssertionError(f"Model A tick: launches {counts}, expected "
                             f"attention_{route} depth times a tick")
    if worst_box > CPU_BOX_TOL or worst_score > CPU_SCORE_TOL:
        raise AssertionError("Model A tick disagrees with the CPU")
    return {"ticks": HEADS_TICKS, "route": route, "launches": counts,
            "max_d_bbox_px": worst_box, "max_d_score": worst_score}


def panel_train(dev, card) -> dict:
    """Model A's width and heads in float32 at depth HEADS_TRAIN["depth"]:
    HEADS_TRAIN["steps"] compiled ``train_step`` s at batch
    HEADS_TRAIN["batch"] from seeded weights on seeded crops, beside the
    port's CPU run of the same steps (losses within TRAIN_LOSS_RTOL); the
    counts set to 0 just before the steps: kernel 4 (the plan's route at
    (batch x 4, 320, 256)) depth times a step, nothing else."""
    from gstreamer_vit_tracker_tpu_torch.config import ModelConfig
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.ops import attention
    from gstreamer_vit_tracker_tpu_torch.train import step as train

    cfg = dataclasses.replace(ModelConfig(), dtype="float32",
                              **dict(HEADS_A, depth=HEADS_TRAIN["depth"]))
    steps, batch = HEADS_TRAIN["steps"], HEADS_TRAIN["batch"]
    flat = random_flat(cfg, seed=256)
    z, x, gt = train_batch(cfg, batch, seed=32)
    opt = train.make_optimizer(TRAIN_LR)
    route = attention._plan_for(dev, cfg.num_tokens, 256, torch.float32,
                                batch * cfg.num_heads).route
    losses = {}
    for d in (dev, torch.device("cpu")):
        state = train.create_train_state(
            weights.params_from_flat(flat, cfg, device=d), opt=opt)
        zero_counts()
        losses[d.type] = []
        for _ in range(steps):
            state, loss, _ = train.train_step(state, z, x, gt, cfg, opt=opt,
                                              device=d)
            losses[d.type].append(float(loss))
        if d.type == "cuda":
            counts = read_counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    want = dict(counts, vit_encoder=0, vit_block=0, attention_single=0,
                attention_flash=0, fused_prep_embed=0)
    want[f"attention_{route}"] = cfg.depth * steps
    print(f"Model A float32 training at depth {cfg.depth}, batch {batch}: "
          f"{steps} compiled train_steps, loss on the card "
          f"{losses['cuda']}, on the CPU {losses['cpu']}, max relative "
          f"difference {rel:.2e} (tolerance {TRAIN_LOSS_RTOL}); launches "
          f"{counts} (the plan's route {route}) | {card}", flush=True)
    if counts != want or not np.isfinite(losses["cuda"]).all() \
            or rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"Model A training: launches {counts} or losses "
                             f"{losses}")
    return {"steps": steps, "depth": cfg.depth, "batch": batch,
            "route": route, "launches": counts, "losses": losses,
            "loss_rel_vs_cpu": rel}


def heads_patch_phase(dev, card: str) -> dict:
    """Head dims above 128 (kernels 1-4, Model A) and patches above 32
    (kernel 5, Model B): the kernels against their plain versions in both
    dtypes and timed (``panel_attention``, ``panel_encoders``, kernel 5 at
    patch 48 and 64 through ``wide_prep``), then the paths a user calls,
    the counts set to 0 just before each part and read just after: Model A
    ``core.init`` and HEADS_STEPS compiled ``update_packed_jit`` steps in
    bf16 and float32 from the CPU's state (``compiled_steps``: kernel 1
    once a step), its 24 blocks through ``_block(fused=True)`` at B=16
    (``block_path``: kernel 2), HEADS_TICKS ticks of a 16-slot engine
    (``panel_tick``: kernel 4), HEADS_TRAIN float32 train steps
    (``panel_train``: kernel 4); Model B through HEADS_PREP_STEPS compiled
    ``update_scan_pool(fused_prep=True)`` and eager
    ``update_packed(fused_prep=True)`` steps in both dtypes (``prep_path``:
    kernels 5 and 1 once a step).  No float32 path launches ``simt``."""
    from gstreamer_vit_tracker_tpu_torch.config import ModelConfig
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.profile_prep import seeded_params
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    t_phase = time.perf_counter()
    acfg, aparams, acparams = wide_model(dev, HEADS_A, seed=256)
    res = {"wide_sha256": check_wide_sha256(dev, "model_a", acfg, aparams,
                                            256),
           "wide_sha256_f32": check_wide_sha256(dev, "model_a", acfg,
                                                aparams, 256, torch.float32),
           "attention": panel_attention(dev),
           "encoders": panel_encoders(dev, card, acfg, aparams),
           "kernel5": {}}
    for patch, search in HEADS_PATCHES:
        c = dataclasses.replace(ModelConfig(), patch_size=patch,
                                search_size=search, template_size=search // 2)
        res["kernel5"][f"patch{patch}"] = wide_prep(
            dev, card, c, seeded_params(c, dev, patch))
    paths = compiled_steps(dev, card, "Model A", acfg, aparams, acparams,
                           HEADS_STEPS)
    paths["block_path"] = block_path(dev, "Model A", acfg, aparams, seed=256)
    paths["tick"] = panel_tick(dev, card, acfg, aparams, acparams)
    del aparams, acparams
    paths["train"] = panel_train(dev, card)

    bcfg = dataclasses.replace(ModelConfig(), **HEADS_B)
    rng = np.random.default_rng(64)
    bflat = {k: v if k.endswith(("/scale", "/bias")) else
             (HEADS_B_STD * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in random_flat(bcfg, seed=64).items()}
    frames, boxes = nv12_clip(HEADS_PREP_STEPS + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    pool = tuple(torch.stack([c[i] for c in clip]) for i in (0, 1))
    for dtype, tols in (("bfloat16", (CPU_BOX_TOL, CPU_SCORE_TOL)),
                        ("float32", (SMALL_BOX_TOL, SMALL_SCORE_TOL))):
        cfg = dataclasses.replace(bcfg, dtype=dtype)
        _, paths[f"model_b_{dtype}"] = prep_path(
            dev, f"Model B (patch 64) {dtype}", cfg,
            lambda d, cfg=cfg: weights.params_from_flat(bflat, cfg, device=d),
            HEADS_PREP_STEPS, ("compiled", "eager"), tols, frames, boxes,
            clip, pool)
    res["paths"] = paths
    res["seconds"] = time.perf_counter() - t_phase
    print(f"head dims and patches phase: {res['seconds']:.1f} s | {card}",
          flush=True)
    return res


def heads_patch_alone() -> dict:
    """:func:`heads_patch_phase` on card 0 and nothing else, after the
    build, with the flagship's and ``small``'s kernel outputs against
    FLAGSHIP_SHA256.  Run from the root of a checkout: ``python -c "import
    chip_smoke as c; c.heads_patch_alone()"``."""
    from gstreamer_vit_tracker_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    built = cuda_build.build()
    card = card_line()
    print(f"head dims and patches alone | build "
          f"{json.dumps({k: round(v, 2) for k, v in built.items()})} total "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    got = {k: digest(t) for k, t in flagship_outputs(dev).items()}
    print(f"flagship and small kernel 1 / 2 / 5 outputs bit-equal to the "
          f"build before: {got == FLAGSHIP_SHA256} {json.dumps(got)}",
          flush=True)
    if got != FLAGSHIP_SHA256:
        raise AssertionError("the flagship's or small's kernel outputs are no "
                             "longer bit-equal to the build before")
    res = heads_patch_phase(dev, card)
    print(json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 3e: head dims that no variant takes as they are, zero-padded
# ---------------------------------------------------------------------------

def padded_heads_phase(dev) -> dict:
    """Attention at head dims 4, 12, 48 and 96 (3 heads of a (2, 320, 3 dh)
    qkv buffer's chunks) in bf16 and float32, and the encoder and block
    kernels at D 192 in bf16 with 4 heads (dh 48) and 2 heads (dh 96) and in
    float32 with 8 heads (dh 24, which ``tf32x3`` takes as it is; ``simt``
    padded it to 32 before) and 16 heads (dh 12), each against its plain twin
    at the tolerances above.  A head dim no variant takes as it is runs
    zero-padded (bf16 attention: to 32 / 64 / 128 and ``mma``; float32: the
    next multiple of 8; the encoder: ``mma`` 32 / 64 / 128, ``tf32x3`` the
    next multiple of 8) with the true one's scale.  Returns max|d| by
    case."""
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block

    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for dh in (4, 12, 48, 96):
            gen = torch.Generator(device="cpu").manual_seed(31 * dh)
            qkv = torch.randn((2, 320, 9 * dh), generator=gen).to(dev, dtype)
            q, k, v = torch.chunk(qkv, 3, dim=-1)
            chosen = attention._plan_for(dev, 320, dh, dtype, 6)
            before = attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES
            got = attention.multihead_attention(q, k, v, 3)
            if attention.SINGLE_LAUNCHES + attention.FLASH_LAUNCHES != before + 1:
                raise AssertionError("padded attention did not launch once")
            plain = attention.multihead_attention(q, k, v, 3, use_kernel=False)
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs().max().item()
            tol = (ATT_F32_ATOL if dtype == torch.float32
                   else ATT_BF16_REL * plain.float().abs().max().item())
            print(f"attention head dim {dh} {name} (2, 320, 3 heads): "
                  f"{chosen.route} / {chosen.variant}, padded to "
                  f"{chosen.pad or 'none'}; max|d| {err:.3e} (tolerance "
                  f"{tol:.3e})", flush=True)
            if got.shape != plain.shape or not err <= tol or (
                    dh % 8 and chosen.pad != attention.padded_head_dim(dh, dtype)):
                raise AssertionError(f"attention at head dim {dh} {name} "
                                     f"disagrees with the plain version")
            res[f"attention_dh{dh}_{name}"] = err
    for dtype, heads in ((torch.bfloat16, 4), (torch.bfloat16, 2),
                         (torch.float32, 8), (torch.float32, 16)):
        name, d = str(dtype).split(".")[-1], 192
        blocks, x, _ = seeded_blocks(dev, d, 3, dtype, heads)
        chosen = vit_block._plan_for(x, heads, 4 * d)
        before = dict(vit_block.VARIANT_LAUNCHES)
        got = vit_block.encoder(x, blocks, heads)
        one = vit_block.block(x, blocks[0], heads)
        if vit_block.VARIANT_LAUNCHES[chosen.variant] != before[chosen.variant] + 2:
            raise AssertionError("padded encoder / block did not launch once each")
        what = (f"head dim {d // heads} {name}, {chosen.variant}, padded to "
                f"{chosen.pad or 'none'}")
        res[f"encoder_dh{d // heads}_{name}"] = check_kernel(
            f"encoder kernel, 3 blocks, {what}", got,
            vit_block.encoder_reference(x, blocks, heads), dtype)
        res[f"block_dh{d // heads}_{name}"] = check_kernel(
            f"block kernel, {what}", one,
            vit_block.block_reference(x, blocks[0], heads), dtype)
        want = "mma" if dtype == torch.bfloat16 else "tf32x3"
        if chosen.variant != want or chosen.pad != vit_block.head_pad(
                want, d // heads) or (d // heads) % 8 and not chosen.pad:
            raise AssertionError(f"the encoder plan for {what}: expected "
                                 f"{want}, padded where it pads")
    return res


# ---------------------------------------------------------------------------
# Phase 3d: the one-block kernel and its path
# ---------------------------------------------------------------------------

def block_phase(dev, cfg, params, small, sparams, z_tok, cases):
    from gstreamer_vit_tracker_tpu_torch.models import vit
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block

    def counts():
        return (vit_block.LAUNCHES, attention.SINGLE_LAUNCHES,
                attention.FLASH_LAUNCHES)

    blocks = [vit.cast_params(bp, torch.bfloat16)
              for bp in params["backbone"]["blocks"]]
    gen = torch.Generator(device="cpu").manual_seed(21)
    res = {}
    shapes = [(1, cfg.num_tokens, cfg.embed_dim, torch.bfloat16, blocks[5],
               cfg.num_heads),
              (SERVE_SLOTS, cfg.num_tokens, cfg.embed_dim, torch.bfloat16,
               blocks[5], cfg.num_heads),
              (SERVE_SLOTS, small.num_tokens, small.embed_dim, torch.float32,
               sparams["backbone"]["blocks"][1], small.num_heads)]
    for b, s, d, dtype, blk, heads in shapes:
        x = (2.0 * torch.randn((b, s, d), generator=gen)).to(dev, dtype)
        n0, other = vit_block.BLOCK_LAUNCHES, counts()
        out = vit_block.block(x, blk, heads)
        if vit_block.BLOCK_LAUNCHES != n0 + 1:
            raise AssertionError("block did not count a launch")
        ref = vit_block.block_reference(x, blk, heads)
        torch.cuda.synchronize()
        if vit_block.BLOCK_LAUNCHES != n0 + 1 or counts() != other:
            raise AssertionError("block_reference launched a kernel of the "
                                 "port: the block kernel's twin must stay plain")
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = F32_ATOL if dtype == torch.float32 else ENC_REL_TOL * scale
        name = f"({b}, {s}, {d}) {str(dtype).split('.')[-1]}"
        print(f"block kernel vs twin {name}: max|d| {err:.3e} (max|twin| "
              f"{scale:.3f}, tolerance {tol:.3e})", flush=True)
        if out.dtype != dtype or not torch.isfinite(out.float()).all() \
                or not err <= tol:
            raise AssertionError(f"block kernel {name} disagrees with "
                                 f"block_reference: {err} > {tol}")
        if dtype == torch.bfloat16:
            res[b] = timed_kernel(f"block {name}", x, [blk], heads, False,
                                  lambda: vit_block.block(x, blk, heads))
        else:
            res["max_abs_err_f32_small"] = err
    res["f32"] = {"flagship": timed_f32(cases["block_flagship"]),
                  "small": timed_f32(cases["block_small"])}

    # Gradients through block = gradients through block_reference (float32
    # masters, bf16 compute: the cast is outside the kernel).
    blk = {m: {f: t.detach().clone().requires_grad_(True)
               for f, t in leaves.items()}
           for m, leaves in params["backbone"]["blocks"][5].items()}
    leaves = [t for m in blk.values() for t in m.values()]
    x = torch.randn((2, cfg.num_tokens, cfg.embed_dim), generator=gen).to(
        dev).requires_grad_(True)
    g_k = torch.autograd.grad((vit_block.block(x, blk, cfg.num_heads) ** 2
                               ).sum(), [x, *leaves])
    g_r = torch.autograd.grad((vit_block.block_reference(
        x, blk, cfg.num_heads) ** 2).sum(), [x, *leaves])
    g_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                for a, b in zip(g_k, g_r))
    print(f"block gradients (x and 12 leaves, float32) vs block_reference's: "
          f"max relative difference {g_err:.3e}", flush=True)
    if not g_err <= 1e-4:
        raise AssertionError(f"block gradients differ from the twin's: {g_err}")

    # The kernel's path: the flagship's blocks chained through
    # vit._block(fused=True) at B=16 on the real template tokens, forward
    # and under a gradient.
    x_tok = torch.randn((SERVE_SLOTS, cfg.num_search_tokens, cfg.embed_dim),
                        generator=gen).to(dev, torch.bfloat16)
    x0 = torch.cat([z_tok[None].expand(SERVE_SLOTS, -1, -1), x_tok],
                   dim=1).contiguous()
    torch.cuda.synchronize()
    vit_block.BLOCK_LAUNCHES = 0
    zero_variants()
    x = x0
    for bp in blocks:
        x = vit._block(x, bp, cfg.num_heads, fused=True)
    xg = x0.clone().requires_grad_(True)
    y = xg
    for bp in blocks:
        y = vit._block(y, bp, cfg.num_heads, fused=True)
    (gx,) = torch.autograd.grad(y.float().pow(2).sum(), [xg])
    torch.cuda.synchronize()
    launches = vit_block.BLOCK_LAUNCHES
    by_variant = dict(vit_block.VARIANT_LAUNCHES)
    same = torch.equal(x, vit_block.encoder(x0, blocks, cfg.num_heads))
    print(f"block path: {len(blocks)} flagship blocks through "
          f"_block(fused=True) at B={SERVE_SLOTS}, forward and under a "
          f"gradient: block launches {launches} ({by_variant}); output equals "
          f"the encoder kernel's bit for bit: {same}; gradient finite: "
          f"{bool(torch.isfinite(gx.float()).all())}", flush=True)
    if launches != 2 * len(blocks) or not same \
            or by_variant != only("mma", 2 * len(blocks)) \
            or not torch.isfinite(gx.float()).all():
        raise AssertionError("block path: wrong launch count or output")
    res["launches"] = launches
    return res


# ---------------------------------------------------------------------------
# Phase 4b: the fused route and the other frame formats
# ---------------------------------------------------------------------------

def nv12_to_yuy2(y, uv):
    """Packed YUY2 (H, W*2) with the NV12 frame's bytes (chroma rows
    repeated)."""
    h, w = y.shape
    out = np.empty((h, w // 2, 4), np.uint8)
    out[..., 0], out[..., 2] = y[:, 0::2], y[:, 1::2]
    out[..., 1] = np.repeat(uv[..., 0], 2, axis=0)
    out[..., 3] = np.repeat(uv[..., 1], 2, axis=0)
    return out.reshape(h, w * 2)


def nv12_to_rgb(y, uv):
    """BT.601 limited-range RGB (H, W, 3) uint8, chroma block-replicated."""
    yf = y.astype(np.float32) - 16.0
    u = np.repeat(np.repeat(uv[..., 0], 2, 0), 2, 1).astype(np.float32) - 128.0
    v = np.repeat(np.repeat(uv[..., 1], 2, 0), 2, 1).astype(np.float32) - 128.0
    rgb = np.stack([298 * yf + 409 * v, 298 * yf - 100 * u - 208 * v,
                    298 * yf + 516 * u], -1) / 256.0
    return np.rint(rgb.clip(0, 255)).astype(np.uint8)


def fused_route_phase(dev, cfg, params, cparams, frames, boxes, clip):
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    cpu = torch.device("cpu")
    for _ in range(3):                                 # warm-up, uncounted
        core.update_packed(params, core.init(params, clip[0], boxes[0], cfg,
                                             "nv12", dev),
                           clip[1], cfg, "nv12", dev, fused_prep=True)
    state = core.init(params, clip[0], boxes[0], cfg, "nv12", dev)
    torch.cuda.synchronize()
    fpe.LAUNCHES = vit_block.LAUNCHES = 0
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(MAIN_STEPS)]
    states, packed = [state], []
    for i in range(MAIN_STEPS):
        events[i][0].record()
        state, out = core.update_packed(params, state, clip[i + 1], cfg,
                                        "nv12", dev, fused_prep=True)
        events[i][1].record()
        states.append(state)
        packed.append(out)
    torch.cuda.synchronize()
    launches, enc = fpe.LAUNCHES, vit_block.LAUNCHES
    step_ms = [a.elapsed_time(b) for a, b in events]
    packed = torch.stack(packed).cpu().numpy()
    if launches != MAIN_STEPS or enc != MAIN_STEPS:
        raise AssertionError(f"fused route: fused_prep_embed launched "
                             f"{launches} times and the encoder {enc} times "
                             f"in {MAIN_STEPS} steps")
    if packed.shape != (MAIN_STEPS, 5) or not np.isfinite(packed).all():
        raise AssertionError("fused route: non-finite or misshapen output")
    iou = [_iou(p[:4], boxes[i + 1]) for i, p in enumerate(packed)]

    # Every step beside the plain-route step from the same state (bf16: the
    # routes round at different places, see ROUTE_SCORE_TOL).
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(MAIN_STEPS)]
    want = []
    for i in range(MAIN_STEPS):
        events[i][0].record()
        want.append(core.update_packed(params, states[i], clip[i + 1], cfg,
                                       "nv12", dev)[1])
        events[i][1].record()
    torch.cuda.synchronize()
    plain_ms = [a.elapsed_time(b) for a, b in events]
    want = torch.stack(want).cpu().numpy()
    d_box = np.abs(want[:, :4] - packed[:, :4]).max()
    d_score = np.abs(want[:, 4] - packed[:, 4]).max()
    print(f"fused route: {MAIN_STEPS} flagship NV12 1080p update_packed("
          f"fused_prep=True) steps, fused_prep_embed launches {launches}, "
          f"encoder launches {enc}; step ms median "
          f"{statistics.median(step_ms):.4f} (CUDA events; min "
          f"{min(step_ms):.4f}, max {max(step_ms):.4f}) beside the plain-route "
          f"step from the same states {statistics.median(plain_ms):.4f} (min "
          f"{min(plain_ms):.4f}, max {max(plain_ms):.4f}); vs those steps "
          f"max|d bbox| {d_box:.4f} px, max|d score| {d_score:.5f} (tolerance "
          f"{ROUTE_BOX_TOL} px, {ROUTE_SCORE_TOL}); mean IoU vs drawn box "
          f"{np.mean(iou):.3f}", flush=True)
    if d_box > ROUTE_BOX_TOL or d_score > ROUTE_SCORE_TOL \
            or np.mean(iou) < 0.3:
        raise AssertionError("fused route disagrees with the plain route")

    # In float32 the two routes are one function: the same weights with
    # dtype="float32", the first steps, held to 0.05 px and 1e-3.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    s32 = core.init(params, clip[0], boxes[0], cfg32, "nv12", dev)
    for i in range(CPU_CHECK_STEPS):
        _, a = core.update_packed(params, s32, clip[i + 1], cfg32, "nv12", dev)
        s32, b = core.update_packed(params, s32, clip[i + 1], cfg32, "nv12",
                                    dev, fused_prep=True)
        d = (a - b).abs().cpu().numpy()
        print(f"fused route step {i + 1}, float32, vs the plain route: "
              f"max|d bbox| {d[:4].max():.5f} px, |d score| {d[4]:.6f}")
        if d[:4].max() > 0.05 or d[4] > 1e-3:
            raise AssertionError("float32 fused route disagrees with the "
                                 "plain route")

    # The first steps beside the port's CPU run from the card's state.
    for i in range(CPU_CHECK_STEPS):
        cstate = type(state)(*(t.to(cpu) for t in states[i]))
        _, cout = core.update_packed(cparams, cstate, frames[i + 1], cfg,
                                     "nv12", cpu, fused_prep=True)
        db = np.abs(cout[:4].numpy() - packed[i, :4]).max()
        ds = abs(float(cout[4]) - packed[i, 4])
        print(f"fused route step {i + 1} card vs CPU: max|d bbox| {db:.4f} "
              f"px, |d score| {ds:.5f}")
        if db > CPU_BOX_TOL or ds > CPU_SCORE_TOL:
            raise AssertionError("fused-route card step disagrees with the CPU")

    # The same clip as RGB and as YUY2, step by step from the NV12 states.
    res = {"launches": launches, "step_ms_median": statistics.median(step_ms),
           "plain_route_step_ms_median": statistics.median(plain_ms)}
    for fmt, convert, tol in (("yuy2", nv12_to_yuy2,
                               (CPU_BOX_TOL, CPU_SCORE_TOL)),
                              ("rgb", nv12_to_rgb,
                               (RGB_BOX_TOL, RGB_SCORE_TOL))):
        db = ds = 0.0
        ms = []
        for i in range(FORMAT_STEPS):
            frame = core._frame_on(convert(*frames[i + 1]), fmt, dev)
            for fused_embed in (False, True):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                _, out = core.update_packed(params, states[i], frame, cfg, fmt,
                                            dev, fused_embed=fused_embed)
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
                out = out.cpu().numpy()
                if not np.isfinite(out).all():
                    raise AssertionError(f"{fmt} step: non-finite output")
                db = max(db, np.abs(out[:4] - packed[i, :4]).max())
                ds = max(ds, abs(out[4] - packed[i, 4]))
        # One template from the format's own init, beside the NV12 one.
        st = core.init(params, convert(*frames[0]), boxes[0], cfg, fmt, dev)
        dz = (st.z_tok.float() - states[0].z_tok.float()).abs().max().item()
        print(f"{fmt}: {FORMAT_STEPS} steps x (plain, fused_embed) of the "
              f"converted clip from the NV12 states: max|d bbox| {db:.4f} px, "
              f"max|d score| {ds:.5f} vs the NV12 steps (tolerance {tol[0]} "
              f"px, {tol[1]}); step ms median {statistics.median(ms):.4f}; "
              f"init template max|d| {dz:.4f}", flush=True)
        if db > tol[0] or ds > tol[1]:
            raise AssertionError(f"{fmt} steps disagree with the NV12 steps")
        res[f"{fmt}_step_ms_median"] = statistics.median(ms)
    return res


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------

def train_batch(cfg, batch: int, seed: int):
    """Seeded crops: a bright textured square on noise, centred in the
    template and at a random place in the search crop; boxes (cx, cy, w, h)
    normalised to the search crop.  Normalised float32, as ``loss_fn``
    takes them."""
    rng = np.random.default_rng(seed)
    mean, std = np.asarray(cfg.norm_mean), np.asarray(cfg.norm_std)

    def crop(side, cx, cy, w, h):
        img = rng.uniform(0.15, 0.45, (side, side, 3))
        x0, y0 = int((cx - w / 2) * side), int((cy - h / 2) * side)
        x1, y1 = int((cx + w / 2) * side), int((cy + h / 2) * side)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1] = (0.75 + 0.2 * (((xx // 6) + (yy // 6)) % 2)
                             )[..., None] * (0.8, 1.0, 0.6)
        return ((img - mean) / std).astype(np.float32)

    zs, xs, gts = [], [], []
    for _ in range(batch):
        w, h = rng.uniform(0.18, 0.3, 2)
        cx, cy = rng.uniform(0.3, 0.7, 2)
        zs.append(crop(cfg.template_size, 0.5, 0.5, 2 * w, 2 * h))
        xs.append(crop(cfg.search_size, cx, cy, w, h))
        gts.append((cx, cy, w, h))
    return np.stack(zs), np.stack(xs), np.asarray(gts, np.float32)


def train_phase(dev, preset: str):
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block
    from gstreamer_vit_tracker_tpu_torch.train import step as train

    cfg = dataclasses.replace(PRESETS[preset], dtype="float32")
    z, x, gt = train_batch(cfg, TRAIN_BATCH, seed=31)
    opt = train.make_optimizer(TRAIN_LR)
    ckpt = weights.checkpoint_path(preset)
    runs = {}
    for d in (dev, torch.device("cpu")):
        state = train.create_train_state(
            weights.load_npz(ckpt, cfg, device=d), opt=opt)
        if d.type == "cuda":                          # warm-up, uncounted
            train.train_step(state, z, x, gt, cfg, opt=opt, device=d)
            torch.cuda.synchronize()
            attention.SINGLE_LAUNCHES = attention.FLASH_LAUNCHES = 0
            vit_block.LAUNCHES = vit_block.BLOCK_LAUNCHES = 0
        losses, ms = [], []
        t_all = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, loss, parts = train.train_step(state, z, x, gt, cfg,
                                                  opt=opt, device=d)
            if d.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        runs[d.type] = {"losses": [float(v) for v in losses], "ms": ms,
                        "seconds": time.perf_counter() - t_all,
                        "finite": all(bool(torch.isfinite(t).all())
                                      for t in train.tree_leaves(state.params))}
    card, cpu = runs["cuda"], runs["cpu"]
    single, flash = attention.SINGLE_LAUNCHES, attention.FLASH_LAUNCHES
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    print(f"training: {preset} width and depth {cfg.depth}, float32, TF32 off, "
          f"batch {TRAIN_BATCH}, {TRAIN_STEPS} train_steps at lr {TRAIN_LR} from "
          f"the shipped weights; loss on the card "
          f"{[round(v, 5) for v in card['losses']]}, on the CPU "
          f"{[round(v, 5) for v in cpu['losses']]}, max relative difference "
          f"{rel:.2e} (tolerance {TRAIN_LOSS_RTOL}); step ms (host clock, "
          f"synchronised) median {statistics.median(card['ms']):.2f} (min "
          f"{min(card['ms']):.2f}, max {max(card['ms']):.2f}) on the card, "
          f"{statistics.median(cpu['ms']):.0f} on the CPU; attention launches "
          f"in the {TRAIN_STEPS} steps: attention_single {single}, "
          f"attention_flash {flash}", flush=True)
    if not (card["finite"] and np.isfinite(card["losses"]).all()):
        raise AssertionError("training on the card went non-finite")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"training losses on the card and the CPU differ "
                             f"by {rel}")
    if not card["losses"][-1] < card["losses"][0]:
        raise AssertionError(f"the training loss did not fall: "
                             f"{card['losses']}")
    if single + flash != cfg.depth * TRAIN_STEPS or vit_block.LAUNCHES \
            or vit_block.BLOCK_LAUNCHES:
        raise AssertionError(
            f"training forward: {single} + {flash} attention launches in "
            f"{TRAIN_STEPS} steps of depth {cfg.depth} (encoder "
            f"{vit_block.LAUNCHES}, block {vit_block.BLOCK_LAUNCHES})")
    return {"step_ms_median": statistics.median(card["ms"]),
            "cpu_step_ms_median": statistics.median(cpu["ms"]),
            "attention_single_launches": single,
            "attention_flash_launches": flash,
            "loss_first": card["losses"][0], "loss_last": card["losses"][-1],
            "loss_rel_vs_cpu": rel}


# ---------------------------------------------------------------------------
# Phase 8: the tracker app, end to end
# ---------------------------------------------------------------------------

APP_FRAMES = 60
APP_CPU_FRAMES = 20
APP_FREE_ROWS = 3
# corr-tiny (float32) card against the CPU: bbox 1e-2 px, score 1e-4 (the
# small f32 bounds); the rows round scores to 4 places, so two scores
# within 1e-4 may print one step of that rounding apart.
CORR_BOX_TOL, CORR_SCORE_TOL = 1e-2, 1e-4
ROW_ROUNDING = 1e-9
APP_IOU_MARGIN = 0.05
PIPE_TOL = 1e-5
APP_BASE = ["--headless", "--no-pace"]
FLAGSHIP_ARGV = APP_BASE + ["--model", "vittrack-t", "--format", "nv12",
                            "--width", str(FRAME_W), "--height",
                            str(FRAME_H)]
SMALL_APP_FRAMES = 30
SMALL_ARGV = APP_BASE + ["--model", "small", "--format", "nv12", "--width",
                         str(FRAME_W), "--height", str(FRAME_H)]
SOAK_ARGV = APP_BASE + ["--model", "corr-tiny", "--width", "320", "--height",
                        "256", "--format", "nv12", "--inject-source-fault",
                        "40", "--inject-device-fault", "45"]


def zero_counts() -> None:
    from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block
    from gstreamer_vit_tracker_tpu_torch.ops import fused_prep_embed as fpe

    torch.cuda.synchronize()
    vit_block.LAUNCHES = vit_block.BLOCK_LAUNCHES = 0
    zero_variants()
    attention.SINGLE_LAUNCHES = attention.FLASH_LAUNCHES = 0
    fpe.LAUNCHES = 0
    fpe.VARIANT_LAUNCHES.update(dict.fromkeys(fpe.VARIANT_LAUNCHES, 0))


def read_counts() -> dict:
    from gstreamer_vit_tracker_tpu_torch.entry import launch_counts

    return launch_counts()


def run_app(name: str, argv, tmp: str, card: str):
    """The port's app on ``argv`` in this process, with ``--record-track``:
    (RunReport, rows, stdout).  Prints the run's own telemetry."""
    from gstreamer_vit_tracker_tpu_torch.app import main as app

    track = os.path.join(tmp, f"{name}.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = app.run(list(argv) + ["--record-track", track])
    text = out.getvalue()
    if report.rc != 0:
        raise AssertionError(f"app {name} exited {report.rc}: {text[-3000:]}")
    with open(track) as f:
        rows = [json.loads(line) for line in f]
    print(f"app {name}: {report.frames} frames in {report.wall_s:.2f} s, "
          f"{report.fps:.2f} fps, track p50 {report.track_ms_p50:.3f} ms "
          f"(mean {report.track_ms_avg:.3f}), map (frame fetch) "
          f"{report.map_ms:.3f} ms, draw {report.draw_ms:.3f} ms (the app's "
          f"telemetry, host clock); final state "
          f"{report.final_state}; faults {report.faults} (reopens "
          f"{report.source_reopens}, backend re-creates "
          f"{report.backend_recreates}) | {card}", flush=True)
    return report, rows, text


def _boxes(rows):
    return np.asarray([o["bbox"] for r in rows for o in r.get("objects",
                                                              [r])])


def _scores(rows):
    return np.asarray([o["score"] for r in rows for o in r.get("objects",
                                                               [r])])


def corr_tiny_from_cpu_state(dev) -> dict:
    """corr-tiny on the default argv's frames (rgb 640x512, seed 0): the
    app's headless flow (init on the drawn box, the auto-init update on
    frame 0, then frames 0-59) through ``core`` on the CPU, and each step
    again on the card from the CPU's state before it."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.media.source import SyntheticSource
    from gstreamer_vit_tracker_tpu_torch.models import vittrack
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    cfg, cpu = PRESETS["corr-tiny"], torch.device("cpu")
    pcpu = vittrack.init_params(torch.Generator().manual_seed(0), cfg, cpu)
    pcard = vittrack.init_params(torch.Generator().manual_seed(0), cfg, dev)
    src = SyntheticSource(640, 512, seed=0, fmt="rgb")
    bbox = tuple(int(v) for v in src.bbox_at(0))
    cst = core.init(pcpu, src.frame(0), bbox, cfg, device=cpu)
    gst = core.init(pcard, src.frame(0), bbox, cfg, device=dev)
    d_tok = (gst.z_tok.cpu() - cst.z_tok).abs().max().item()
    worst_box = worst_score = 0.0
    for f in [src.frame(0)] + [src.frame(i) for i in range(APP_FRAMES)]:
        held = type(cst)(*(t.to(dev) for t in cst))
        _, gout = core.update_packed(pcard, held, f, cfg, device=dev)
        cst, cout = core.update_packed(pcpu, cst, f, cfg, device=cpu)
        gout, cout = gout.cpu().numpy(), cout.numpy()
        worst_box = max(worst_box, float(np.abs(gout[:4] - cout[:4]).max()))
        worst_score = max(worst_score, float(abs(gout[4] - cout[4])))
    print(f"corr-tiny, {APP_FRAMES + 1} steps on the card each from the CPU's "
          f"state: max|d bbox| {worst_box:.3e} px, max|d score| "
          f"{worst_score:.3e} (tolerance {CORR_BOX_TOL} px, {CORR_SCORE_TOL}); "
          f"template tokens max|d| {d_tok:.3e}", flush=True)
    if worst_box > CORR_BOX_TOL or worst_score > CORR_SCORE_TOL:
        raise AssertionError("corr-tiny card step disagrees with the CPU")
    return {"from_cpu_state_max_box": worst_box,
            "from_cpu_state_max_score": worst_score}


def hud_phase(dev) -> dict:
    """The HUD and the display resample on 1080p frames, card against CPU."""
    from gstreamer_vit_tracker_tpu_torch.ops import (colorspace, overlay,
                                                     overlay_nv12, resample)

    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (FRAME_H, FRAME_W, 3), np.uint8)
    yuy2 = rng.integers(0, 256, (FRAME_H, FRAME_W * 2), np.uint8)
    luma = rng.integers(0, 256, (FRAME_H, FRAME_W), np.uint8)
    kw = dict(fps=58.7, track_ms=4.25, cursor=(960, 540), sel_start=(700, 400))
    params = [
        overlay.HudParams(state_name="SELECT END", score=0.0,
                          is_tracking=False, is_selecting=True,
                          sel_active=True, bbox=(0, 0, 0, 0), has_bbox=False,
                          **kw),
        overlay.HudParams(state_name="TRACKING", score=0.912,
                          is_tracking=True, is_selecting=False,
                          sel_active=False, bbox=(1850, 1020, 120, 90),
                          has_bbox=True, **kw),
        overlay.HudParams(state_name="LOST", score=0.0, is_tracking=False,
                          is_selecting=False, sel_active=False,
                          bbox=(-30, 500, 200, 150), has_bbox=False, **kw)]

    def both(fn):
        card = fn(dev).cpu().numpy()
        plain = fn(torch.device("cpu")).numpy()
        return card, plain

    checks = {
        "render_hud": lambda p: lambda d: overlay.render_hud(
            torch.tensor(rgb, device=d), p),
        "yuy2_to_rgb+render_hud": lambda p: lambda d: overlay.render_hud(
            colorspace.yuy2_to_rgb(torch.tensor(yuy2, device=d).reshape(-1),
                                   width=FRAME_W, height=FRAME_H), p),
        "render_hud_luma": lambda p: lambda d: overlay_nv12.render_hud_luma(
            torch.tensor(luma, device=d), p)}
    for name, make in checks.items():
        for p in params:
            card, plain = both(make(p))
            if not np.array_equal(card, plain):
                raise AssertionError(f"{name} on the card differs from the "
                                     f"CPU in {(card != plain).sum()} values")
    print(f"HUD: render_hud, yuy2_to_rgb + render_hud and render_hud_luma on "
          f"{FRAME_W}x{FRAME_H} frames, three HudParams each: uint8-equal to "
          f"the CPU", flush=True)
    card, plain = both(lambda d: resample.resize_static(
        torch.tensor(rgb, device=d), 1024, 1280))
    diff = np.abs(card.astype(int) - plain.astype(int))
    print(f"resize_static {FRAME_W}x{FRAME_H} -> 1280x1024: max|d| "
          f"{diff.max()} level(s), {(diff > 0).sum()} of {diff.size} values "
          f"differ (tolerance 1 level)", flush=True)
    if diff.max() > 1:
        raise AssertionError("resize_static on the card is off by > 1 level")
    img = torch.tensor(rgb, device=dev)
    hud_ms = cuda_ms(lambda: overlay.render_hud(img, params[1]), iters=50)
    return {"resize_static_values_off_by_one": int((diff > 0).sum()),
            "render_hud_1080p_ms": hud_ms}


def app_phase(dev, card: str) -> dict:
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.media.source import (FileSource,
                                                              SyntheticSource)
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- a. the flagship, card against CPU ---------------------------
        zero_counts()
        rep, rows, _ = run_app("flagship-card", FLAGSHIP_ARGV + [
            "--frames", str(APP_FRAMES)], tmp, card)
        counts = read_counts()
        # The headless auto-init makes one update on frame 0, then the
        # session makes one update a frame; each is one kernel-1 launch.
        updates = 1 + APP_FRAMES
        print(f"app flagship: kernel launches {counts} for {updates} updates",
              flush=True)
        if (len(rows) != APP_FRAMES
                or any(r["state"] != "TRACKING" for r in rows)):
            raise AssertionError("app flagship: not 60 TRACKING rows")
        if counts != dict(counts, vit_encoder=updates, attention_single=0,
                          attention_flash=0, vit_block=0, fused_prep_embed=0):
            raise AssertionError(f"app flagship: launches {counts}, expected "
                                 f"kernel 1 x {updates} and nothing else")
        res["flagship"] = {"launches": counts, "updates": updates,
                           "fps": rep.fps, "track_ms_p50": rep.track_ms_p50,
                           "map_ms": rep.map_ms, "draw_ms": rep.draw_ms}
        crep, crows, _ = run_app("flagship-cpu", FLAGSHIP_ARGV + [
            "--frames", str(APP_CPU_FRAMES), "--cpu"], tmp, card)
        d_box = np.abs(_boxes(rows[:APP_FREE_ROWS])
                       - _boxes(crows[:APP_FREE_ROWS])).max()
        d_score = np.abs(_scores(rows[:APP_FREE_ROWS])
                         - _scores(crows[:APP_FREE_ROWS])).max()
        src = SyntheticSource(FRAME_W, FRAME_H, seed=0, fmt="nv12")
        iou_card = np.mean([_iou(rows[i]["bbox"], src.bbox_at(i))
                            for i in range(APP_CPU_FRAMES)])
        iou_cpu = np.mean([_iou(crows[i]["bbox"], src.bbox_at(i))
                           for i in range(APP_CPU_FRAMES)])
        print(f"app flagship card vs CPU: first {APP_FREE_ROWS} rows "
              f"free-running max|d bbox| {d_box:.4f} px, max|d score| "
              f"{d_score:.4f} (tolerance {CPU_BOX_TOL} px, {CPU_SCORE_TOL}); "
              f"mean IoU with the drawn boxes over {APP_CPU_FRAMES} frames: "
              f"card {iou_card:.4f}, CPU {iou_cpu:.4f} (margin "
              f"{APP_IOU_MARGIN})", flush=True)
        if d_box > CPU_BOX_TOL or d_score > CPU_SCORE_TOL:
            raise AssertionError("app flagship: the card's first rows disagree")
        if iou_card < iou_cpu - APP_IOU_MARGIN:
            raise AssertionError("app flagship: the card tracks worse")
        res["flagship"].update(iou_card=iou_card, iou_cpu=iou_cpu,
                               cpu_fps=crep.fps)

        # -- a2. --model small: kernel 1 in float32 (tf32x3) an update ----
        zero_counts()
        srep, srows, _ = run_app("small-card", SMALL_ARGV + [
            "--frames", str(SMALL_APP_FRAMES)], tmp, card)
        counts, by_variant = read_counts(), dict(vit_block.VARIANT_LAUNCHES)
        updates = 1 + SMALL_APP_FRAMES
        print(f"app small: kernel launches {counts} ({by_variant}) for "
              f"{updates} updates", flush=True)
        if len(srows) != SMALL_APP_FRAMES \
                or counts != dict(counts, vit_encoder=updates,
                                  attention_single=0, attention_flash=0,
                                  vit_block=0, fused_prep_embed=0) \
                or by_variant != only("tf32x3", updates):
            raise AssertionError(f"app small: launches {counts} "
                                 f"{by_variant}, expected kernel 1 (tf32x3) "
                                 f"x {updates} and nothing else")
        res["small"] = {"launches": counts, "updates": updates,
                        "launches_by_variant": by_variant, "fps": srep.fps,
                        "track_ms_p50": srep.track_ms_p50}

        # -- b. corr-tiny, the default argv, card against CPU -------------
        default = APP_BASE + ["--frames", str(APP_FRAMES)]
        zero_counts()
        brep, brows, _ = run_app("corr-tiny-card", default, tmp, card)
        if any(read_counts().values()):
            raise AssertionError("corr-tiny (depth 0) launched a kernel")
        _, bcrows, _ = run_app("corr-tiny-cpu", default + ["--cpu"], tmp, card)
        states = [r["state"] for r in brows]
        if states != [r["state"] for r in bcrows] or len(states) != APP_FRAMES:
            raise AssertionError("corr-tiny: card and CPU states differ")
        dfree = np.abs(_boxes(brows) - _boxes(bcrows)).max(axis=1)
        sfree = np.abs(_scores(brows) - _scores(bcrows))
        print(f"corr-tiny app card vs CPU, free-running: every state equal "
              f"({states[-1]}); max|d bbox| by row {np.round(dfree, 5).tolist()}"
              f"; max|d score| first {APP_FREE_ROWS} rows "
              f"{sfree[:APP_FREE_ROWS].max():.5f}", flush=True)
        if (dfree[:APP_FREE_ROWS].max() > CORR_BOX_TOL
                or sfree[:APP_FREE_ROWS].max() > CORR_SCORE_TOL + ROW_ROUNDING):
            raise AssertionError("corr-tiny: the card's first rows disagree")
        res["corr_tiny"] = dict(corr_tiny_from_cpu_state(dev), fps=brep.fps,
                                track_ms_p50=brep.track_ms_p50,
                                map_ms=brep.map_ms, draw_ms=brep.draw_ms,
                                free_max_box_by_row=dfree.tolist())

        # -- c. the other modes -------------------------------------------
        orep, _, _ = run_app("corr-tiny-objects", APP_BASE + [
            "--frames", "30", "--objects", "3", "--exclusive"], tmp, card)
        if orep.final_state != "TRACKING 3 OF 3":
            raise AssertionError(f"--objects 3: {orep.final_state}")
        small = PRESETS["small"]
        zero_counts()
        srep, _, _ = run_app("small-objects", APP_BASE + [
            "--frames", "30", "--objects", "3", "--exclusive", "--model",
            "small"], tmp, card)
        scounts = read_counts()
        want = small.depth * 31
        print(f"app small --objects 3: launches {scounts} (attention_single "
              f"expected depth {small.depth} x 31 batched updates = {want})",
              flush=True)
        if scounts != dict(scounts, attention_single=want, vit_encoder=0):
            raise AssertionError(f"app small --objects 3: launches {scounts}")
        prep, prows, _ = run_app("corr-tiny-pipelined", default + [
            "--pipelined"], tmp, card)
        d_pipe = max(np.abs(_boxes(prows[1:]) - _boxes(brows[:-1])).max(),
                     np.abs(_scores(prows[1:]) - _scores(brows[:-1])).max())
        print(f"--pipelined rows 1-{APP_FRAMES - 1} vs rows 0-{APP_FRAMES - 2} "
              f"without it: max|d| {d_pipe:.3e} (tolerance {PIPE_TOL})",
              flush=True)
        if d_pipe > PIPE_TOL:
            raise AssertionError("--pipelined rows are not the previous rows")
        res["modes"] = {"objects_fps": orep.fps,
                        "small_objects_launches": scounts,
                        "small_objects_fps": srep.fps,
                        "pipelined_fps": prep.fps,
                        "pipelined_track_ms_p50": prep.track_ms_p50}

        # -- d. the HUD ------------------------------------------------------
        res["hud"] = hud_phase(dev)

        # -- e. faults and recording ---------------------------------------
        frep, _, ftext = run_app("soak", SOAK_ARGV + ["--frames", "150"], tmp,
                                 card)
        if (frep.final_state != "TRACKING" or frep.source_reopens != 3
                or ftext.count("Tracker error") != 3
                or "Unrecoverable" in ftext):
            raise AssertionError(f"soak: {frep}")
        mrep, _, _ = run_app("soak-objects", SOAK_ARGV + [
            "--frames", "100", "--objects", "3", "--exclusive"], tmp, card)
        if mrep.backend_recreates < 1 or mrep.final_state != "TRACKING 3 OF 3":
            raise AssertionError(f"soak --objects 3: {mrep}")
        path = os.path.join(tmp, "out.y4m")
        run_app("record", APP_BASE + ["--frames", "10", "--record", path,
                                      "--display-scale"], tmp, card)
        fs = FileSource(path)
        y, uv = fs.frame(9)
        print(f"recording: {fs.num_frames} frames of {fs.width}x{fs.height} "
              f"read back (Y {y.shape}, UV {uv.shape})", flush=True)
        if (fs.num_frames, fs.width, fs.height) != (10, 1280, 1024):
            raise AssertionError("the recording reads back wrong")
        res["faults"] = {"soak_backend_recreates": frep.backend_recreates,
                         "soak_reopens": frep.source_reopens,
                         "objects_backend_recreates": mrep.backend_recreates}
    return res


# ---------------------------------------------------------------------------
# Phase 9: train and score
# ---------------------------------------------------------------------------

TRAIN9_STEPS, TRAIN9_BATCH, TRAIN9_DATASET, TRAIN9_CPU_STEPS = 20, 16, 128, 5
EVAL_SEQS, EVAL_FRAMES, EVAL_CPU_FRAMES = 2, 150, 20
EVAL_SCENARIOS = ("basic", "occlusion")
EVAL_W, EVAL_H = 640, 512
OBJECTS_FRAMES, TRAINED_FRAMES = 30, 20


def eval_against_cpu(dev, scenario: str, cfg, params, cparams) -> dict:
    """The eval's first EVAL_CPU_FRAMES frames of each sequence on the card
    and on the CPU: the first CPU_CHECK_STEPS run free, and every step again
    on the card from the CPU's state before it, each held to CPU_BOX_TOL /
    CPU_SCORE_TOL (as the unbatched phase holds the NV12 step)."""
    from gstreamer_vit_tracker_tpu_torch.scripts import eval_tracking
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    cpu = torch.device("cpu")
    args = argparse.Namespace(world="independent", width=EVAL_W,
                              height=EVAL_H, frames=EVAL_FRAMES, speed=3.0)
    free_box = free_score = held_box = held_score = 0.0
    for seq in range(EVAL_SEQS):
        src = eval_tracking.make_source(scenario, seq, args)
        frame0, box0 = src.frame_rgb(0), src.bbox_at(0)
        st = core.init(params, frame0, box0, cfg, device=dev)
        cst = core.init(cparams, frame0, box0, cfg, device=cpu)
        for i in range(1, EVAL_CPU_FRAMES + 1):
            frame = src.frame_rgb(i)
            held = type(cst)(*(t.to(dev) for t in cst))
            _, hbox, hconf = core.update(params, held, frame, cfg, device=dev)
            st, box, conf = core.update(params, st, frame, cfg, device=dev)
            cst, cbox, cconf = core.update(cparams, cst, frame, cfg,
                                           device=cpu)
            cbox, cconf = cbox.numpy(), float(cconf)
            held_box = max(held_box,
                           float(np.abs(hbox.cpu().numpy() - cbox).max()))
            held_score = max(held_score, abs(float(hconf) - cconf))
            if i <= CPU_CHECK_STEPS:
                free_box = max(free_box,
                               float(np.abs(box.cpu().numpy() - cbox).max()))
                free_score = max(free_score, abs(float(conf) - cconf))
    print(f"eval {scenario} card vs CPU, {EVAL_SEQS} sequences: first "
          f"{CPU_CHECK_STEPS} frames free-running max|d bbox| {free_box:.4f} "
          f"px, max|d score| {free_score:.5f}; all {EVAL_CPU_FRAMES} frames "
          f"from the CPU's state max|d bbox| {held_box:.4f} px, max|d score| "
          f"{held_score:.5f} (tolerance {CPU_BOX_TOL} px, {CPU_SCORE_TOL})",
          flush=True)
    if free_box > CPU_BOX_TOL or free_score > CPU_SCORE_TOL:
        raise AssertionError(f"eval {scenario}: the card's free-running "
                             "frames disagree with the CPU")
    if held_box > CPU_BOX_TOL or held_score > CPU_SCORE_TOL:
        raise AssertionError(f"eval {scenario}: a card step from the CPU's "
                             "state disagrees with the CPU")
    return {"free_max_box": free_box, "free_max_score": free_score,
            "held_max_box": held_box, "held_max_score": held_score}


def run_eval(what: str, argv, tmp: str) -> tuple:
    """The port's eval script on ``argv`` (on the card) in this process,
    with ``--json``: (EvalReport, kernel counts of the run)."""
    from gstreamer_vit_tracker_tpu_torch.scripts import eval_tracking

    zero_counts()
    report = eval_tracking.run(list(argv) + [
        "--json", os.path.join(tmp, f"{what}.json")])
    counts = read_counts()
    if report.rc != 0:
        raise AssertionError(f"eval {what} exited {report.rc}")
    print(f"eval {what}: {report.updates} updates in {report.loop_seconds:.2f} "
          f"s of tracking loop, {report.updates_per_s:.2f} updates/s (host "
          f"clock, making the frames on the host included); kernel launches "
          f"{counts}", flush=True)
    return report, counts


def train_score_phase(dev, card: str, step_ms_median: float) -> dict:
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block
    from gstreamer_vit_tracker_tpu_torch.scripts import train_synthetic
    from gstreamer_vit_tracker_tpu_torch.train import step as train
    from gstreamer_vit_tracker_tpu_torch.utils import flops

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = PRESETS["vittrack-t"]
    ckpt = weights.checkpoint_path("vittrack-t")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- train: the flagship in float32 from the shipped weights ------
        out = os.path.join(tmp, "trained.npz")
        zero_counts()
        t0 = time.perf_counter()
        rep = train_synthetic.run([
            "--preset", "vittrack-t", "--init-from", ckpt, "--lr", "1e-4",
            "--batch", str(TRAIN9_BATCH), "--dataset-size", str(TRAIN9_DATASET),
            "--seed", "0", "--data-diversity", "v1", "--steps",
            str(TRAIN9_STEPS), "--log-every", "10", "--out", out])
        train_s = time.perf_counter() - t0
        counts = read_counts()
        if rep.rc != 0:
            raise AssertionError(f"train_synthetic exited {rep.rc}")
        print(f"train: {TRAIN9_STEPS} steps of vittrack-t (D {cfg.embed_dim}, "
              f"depth {cfg.depth}, float32, TF32 off), batch {TRAIN9_BATCH}, "
              f"{TRAIN9_DATASET} samples; data generation "
              f"{rep.data_seconds:.2f} s (host), {rep.samples_per_s:.2f} "
              f"samples/s over the steps, {train_s:.2f} s in all; losses "
              f"{[round(v, 5) for v in rep.losses]}; kernel launches {counts} "
              f"| {card}", flush=True)
        if not np.isfinite(rep.losses).all() or len(rep.losses) != TRAIN9_STEPS:
            raise AssertionError("training: a loss is not finite")
        if counts != dict(counts, attention_flash=cfg.depth * TRAIN9_STEPS,
                          attention_single=0, vit_encoder=0, vit_block=0,
                          fused_prep_embed=0):
            raise AssertionError(f"training: launches {counts}, expected "
                                 f"attention_flash {cfg.depth} a step")
        saved = weights.flatten(weights.load_npz(out, rep.cfg, device=dev))
        final = weights.flatten(rep.state.params)
        if set(saved) != set(final) or not all(
                torch.equal(saved[k], final[k]) for k in final):
            raise AssertionError("the saved checkpoint is not the final state")
        # The same first steps on the CPU, from the same CPU generator.
        state = train.create_train_state(
            weights.load_npz(ckpt, rep.cfg, device=cpu), opt=rep.opt)
        t0 = time.perf_counter()
        _, _, cls, _ = train.train_scan(
            state, *rep.dataset, torch.Generator().manual_seed(1), rep.cfg,
            rep.opt, n_steps=TRAIN9_CPU_STEPS, batch=TRAIN9_BATCH, device=cpu)
        cpu_s = time.perf_counter() - t0
        cls = cls.tolist()
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(rep.losses[:TRAIN9_CPU_STEPS], cls))
        print(f"train card vs CPU, first {TRAIN9_CPU_STEPS} steps: CPU losses "
              f"{[round(v, 5) for v in cls]}, max relative difference "
              f"{rel:.2e} (tolerance {TRAIN_LOSS_RTOL}); {cpu_s:.2f} s on the "
              f"CPU", flush=True)
        if rel > TRAIN_LOSS_RTOL:
            raise AssertionError("training: the card's losses disagree with "
                                 "the CPU's")
        res["train"] = {"losses": rep.losses, "cpu_losses": cls,
                        "loss_rel_vs_cpu": rel, "launches": counts,
                        "data_seconds": rep.data_seconds,
                        "samples_per_s": rep.samples_per_s,
                        "seconds": train_s}

        # -- score: the shipped flagship (bf16) on the independent world ---
        params = weights.load_npz(ckpt, cfg, device=dev)
        cparams = weights.load_npz(ckpt, cfg, device=cpu)
        res["eval"] = {}
        for scenario in EVAL_SCENARIOS:
            erep, counts = run_eval(scenario, [
                "--preset", "vittrack-t", "--world", "independent",
                "--scenario", scenario, "--seqs", str(EVAL_SEQS), "--frames",
                str(EVAL_FRAMES), "--width", str(EVAL_W), "--height",
                str(EVAL_H)], tmp)
            s = erep.summary["scenarios"][scenario]
            print(f"eval {scenario}: mean IoU {s['mean_iou']:.4f}, min IoU "
                  f"{s['min_iou']:.4f}, mean confidence {s['mean_conf']:.4f}, "
                  f"lost {s['lost_frames']}"
                  + "".join(f", {k} {s[k]:.4f}" for k in (
                      "hidden_conf_max", "reacquire_iou") if k in s)
                  + f" | {card}", flush=True)
            if counts != dict(counts, vit_encoder=erep.updates,
                              attention_single=0, attention_flash=0,
                              vit_block=0, fused_prep_embed=0) \
                    or vit_block.VARIANT_LAUNCHES["mma"] != erep.updates:
                raise AssertionError(f"eval {scenario}: launches {counts}, "
                                     f"expected kernel 1 once an update")
            res["eval"][scenario] = dict(
                s, updates=erep.updates, updates_per_s=erep.updates_per_s,
                launches=counts,
                cpu=eval_against_cpu(dev, scenario, cfg, params, cparams))

        # The small preset's eval (float32: kernel 1 as tf32x3 an update).
        erep, counts = run_eval("small", [
            "--preset", "small", "--world", "independent", "--seqs", "1",
            "--frames", str(TRAINED_FRAMES)], tmp)
        by_variant = dict(vit_block.VARIANT_LAUNCHES)
        if counts != dict(counts, vit_encoder=erep.updates,
                          attention_single=0, attention_flash=0,
                          vit_block=0, fused_prep_embed=0) \
                or by_variant != only("tf32x3", erep.updates):
            raise AssertionError(f"eval --preset small: launches {counts} "
                                 f"{by_variant}, expected kernel 1 (tf32x3) "
                                 f"once an update")
        res["small_eval"] = dict(erep.summary["scenarios"]["basic"],
                                 updates=erep.updates, launches=counts,
                                 launches_by_variant=by_variant)

        erep, counts = run_eval("objects-2", [
            "--preset", "vittrack-t", "--objects", "2", "--seqs", "1",
            "--frames", str(OBJECTS_FRAMES)], tmp)
        if counts != dict(counts, attention_single=cfg.depth * OBJECTS_FRAMES,
                          vit_encoder=0, attention_flash=0, vit_block=0,
                          fused_prep_embed=0):
            raise AssertionError(f"eval --objects 2: launches {counts}, "
                                 f"expected attention_single {cfg.depth} a "
                                 f"batched update")
        res["objects"] = dict(erep.summary, updates=erep.updates,
                              updates_per_s=erep.updates_per_s,
                              launches=counts)

        erep, counts = run_eval("trained", [
            "--preset", "vittrack-t", "--checkpoint", out, "--world",
            "independent", "--seqs", "1", "--frames", str(TRAINED_FRAMES)],
            tmp)
        s = erep.summary["scenarios"]["basic"]
        print(f"eval of the checkpoint just trained ({TRAIN9_STEPS} steps; "
              f"not a quality claim): mean IoU {s['mean_iou']:.4f}, mean "
              f"confidence {s['mean_conf']:.4f}", flush=True)
        if counts["vit_encoder"] != TRAINED_FRAMES:
            raise AssertionError(f"eval of the trained checkpoint: {counts}")
        res["trained_eval"] = dict(s, launches=counts)

    # -- flops: one flagship update at 1080p NV12 against the card's peak --
    gflop = flops.update_gflops(cfg, FRAME_H, FRAME_W, "nv12")
    mfu = flops.mfu_fields(1e3 / step_ms_median, gflop)
    print(f"flops: one flagship update at {FRAME_W}x{FRAME_H} NV12 (grouped "
          f"head) is {gflop:.4f} GFLOP; at phase 4's median step "
          f"{step_ms_median:.4f} ms (CUDA events) that is "
          f"{mfu['achieved_tflops']} TFLOP/s, MFU {mfu['mfu_vs_h100_bf16']} "
          f"of {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s (H100 SXM dense bf16) "
          f"| {card}", flush=True)
    res["flops"] = dict(mfu, step_ms=step_ms_median)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"train and score: {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 10: BASELINE config 5 (4K NV12, the HUD composited on the device
# every frame), the native host runtime, the scripts, tree checkpoints
# ---------------------------------------------------------------------------

UHD_H, UHD_W = 2160, 3840
UHD_POOL, UHD_REPS = 4, 200                   # bench.py's _config_uhd
UHD_BBOX0 = (900.0, 500.0, 120.0, 90.0)       # bench.py's bbox0
UHD_CPU_FRAMES = 10
HUD_TEXT = (("TRACKING", 12), ("FPS: 60.0", 16), ("trk: 0.3ms", 16))
RUNTIME_SIZES = ((1920, 1080), (3840, 2160), (1279, 719))
RUNTIME_ITERS = 10
RING_PUSHES = 10_000
SYNTH_FRAMES = 50


def uhd_phase(dev, card: str, params, cfg, cparams) -> dict:
    """The flagship's HUD pool at 4K: kernel 1 once a frame, nothing read
    back inside the call (sync debug mode "error"), the pool untouched, the
    display byte-equal to the CPU's composite of the same frame, box and
    confidence, and ten pool frames stepped from the CPU's state."""
    from gstreamer_vit_tracker_tpu_torch.ops import font
    from gstreamer_vit_tracker_tpu_torch.ops import vit_block
    from gstreamer_vit_tracker_tpu_torch.tracker import core, scan

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    frames, _ = nv12_clip(UHD_POOL, seed=4, h=UHD_H, w=UHD_W)
    make_s = time.perf_counter() - t0
    ys = torch.as_tensor(np.stack([f[0] for f in frames]), device=dev)
    uvs = torch.as_tensor(np.stack([f[1] for f in frames]), device=dev)
    kept = ys.clone(), uvs.clone()
    hud_text = tuple(font.encode_text(t, n) for t, n in HUD_TEXT)

    def start():
        return core.init(params, (ys[0], uvs[0]), UHD_BBOX0, cfg, device=dev,
                         frame_format="nv12")

    scan.update_scan_hud_pool(params, start(), (ys, uvs), hud_text, 2, cfg,
                              dev)                     # warm-up, uncounted
    st0 = start()
    zero_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, disp, scores = scan.update_scan_hud_pool(
            params, st0, (ys, uvs), hud_text, UHD_REPS, cfg, dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    by_variant = dict(vit_block.VARIANT_LAUNCHES)
    uhd_fps = UHD_REPS / wall
    scores = scores.cpu().numpy()
    last = ys[(UHD_REPS - 1) % UHD_POOL]
    diff = float((disp != last).float().mean())
    print(f"uhd: {UHD_REPS} flagship updates on a pool of {UHD_POOL} "
          f"{UHD_W}x{UHD_H} NV12 frames, the luma HUD composited on the "
          f"device every frame: {uhd_fps:.2f} fps ({wall * 1e3 / UHD_REPS:.3f} "
          f"ms a frame, host wall to the last sync, nothing read back inside "
          f"the call under sync debug mode 'error'); kernel launches {counts} "
          f"({by_variant}); display pixels differing from the last pool "
          f"frame {diff:.5f}; score first/last {scores[0]:.4f}/"
          f"{scores[-1]:.4f}; frames made on the host in {make_s:.2f} s "
          f"| {card}", flush=True)
    if counts != dict(counts, vit_encoder=UHD_REPS, vit_block=0,
                      attention_single=0, attention_flash=0,
                      fused_prep_embed=0) \
            or by_variant != only("mma", UHD_REPS):
        raise AssertionError(f"uhd: launches {counts} {by_variant}, expected "
                             f"kernel 1 (mma) once a frame")
    if not np.isfinite(scores).all() or not 0.0 < diff < 0.05:
        raise AssertionError(f"uhd: scores finite {np.isfinite(scores).all()}"
                             f", display differs in {diff} of its pixels")
    if not (torch.equal(ys, kept[0]) and torch.equal(uvs, kept[1])):
        raise AssertionError("uhd: the HUD pool wrote a pool frame")
    # The card's display against the CPU's composite of the same frame with
    # the card's own final box and confidence.
    want = scan.composite_hud(torch.empty_like(last, device=cpu), last.cpu(),
                              st.bbox.cpu(), torch.tensor(scores[-1]),
                              scan.hud_glyphs(hud_text, cpu))
    if not torch.equal(disp.cpu(), want):
        raise AssertionError("uhd: the card's display differs from the CPU "
                             "composite")
    # Pool frames stepped from the CPU's state, one at a time.
    cstate = core.init(cparams, frames[0], UHD_BBOX0, cfg, device=cpu,
                       frame_format="nv12")
    worst_box = worst_score = 0.0
    for i in range(UHD_CPU_FRAMES):
        k = i % UHD_POOL
        held = type(cstate)(*(t.to(dev) for t in cstate))
        gst, _, gsc = scan.update_scan_hud_pool(
            params, held, (ys[k:k + 1], uvs[k:k + 1]), hud_text, 1, cfg, dev)
        cpool = tuple(torch.from_numpy(p[None]) for p in frames[k])
        cstate, _, csc = scan.update_scan_hud_pool(
            cparams, cstate, cpool, hud_text, 1, cfg, cpu)
        worst_box = max(worst_box, float((gst.bbox.cpu()
                                          - cstate.bbox).abs().max()))
        worst_score = max(worst_score, abs(float(gsc[0]) - float(csc[0])))
    print(f"uhd: {UHD_CPU_FRAMES} pool frames from the CPU's state, card vs "
          f"CPU max|d bbox| {worst_box:.4f} px, max|d score| "
          f"{worst_score:.5f} (tolerance {CPU_BOX_TOL} px, {CPU_SCORE_TOL})",
          flush=True)
    if worst_box > CPU_BOX_TOL or worst_score > CPU_SCORE_TOL:
        raise AssertionError("uhd: card steps from the CPU's state disagree")
    return {"fps": uhd_fps, "ms_a_frame": wall * 1e3 / UHD_REPS,
            "reps": UHD_REPS, "launches": counts,
            "launches_by_variant": by_variant, "display_diff_share": diff,
            "cpu_state_max_box_px": worst_box,
            "cpu_state_max_score": worst_score, "state": st}


def runtime_phase(card: str) -> dict:
    """The native runtime built from the checkout's source: the converters
    bit-equal to the port's op, their ms with 8 threads, the ring's
    drop-oldest semantics, the frame generator's rate."""
    from gstreamer_vit_tracker_tpu_torch import runtime
    from gstreamer_vit_tracker_tpu_torch.ops import colorspace

    t0 = time.perf_counter()
    ok = runtime.available()
    build_s = time.perf_counter() - t0
    path = runtime.library_path()
    print(f"runtime: available {ok}, built from {runtime.SOURCE} in "
          f"{build_s:.2f} s into {path}", flush=True)
    if not ok or not path.startswith(runtime.BUILD_DIR):
        raise AssertionError("runtime: the native library did not build")
    rng = np.random.default_rng(10)
    res = {"build_s": build_s, "nv12_ms": {}, "yuy2_ms": {}, "op_ms": {}}

    def host_ms(fn, n):
        fn()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) * 1e3 / n

    for w, h in RUNTIME_SIZES:
        nv12 = rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint8)
        got = runtime.nv12_to_rgb(nv12, w, h, num_threads=8)
        want = colorspace.nv12_to_rgb(torch.from_numpy(nv12), width=w,
                                      height=h).numpy()
        yw = w - w % 2
        yuy2 = rng.integers(0, 256, yw * h * 2, dtype=np.uint8)
        ygot = runtime.yuy2_to_rgb(yuy2, yw, h, num_threads=8)
        ywant = colorspace.yuy2_to_rgb(torch.from_numpy(yuy2), width=yw,
                                       height=h).numpy()
        if not (np.array_equal(got, want) and np.array_equal(ygot, ywant)):
            raise AssertionError(f"runtime: a converter differs from the "
                                 f"op at {w}x{h}")
        key = f"{w}x{h}"
        res["nv12_ms"][key] = host_ms(
            lambda: runtime.nv12_to_rgb(nv12, w, h, 8), RUNTIME_ITERS)
        res["yuy2_ms"][key] = host_ms(
            lambda: runtime.yuy2_to_rgb(yuy2, yw, h, 8), RUNTIME_ITERS)
        res["op_ms"][key] = host_ms(lambda: colorspace.nv12_to_rgb(
            torch.from_numpy(nv12), width=w, height=h), 2)
        print(f"runtime {key}: nv12_to_rgb and yuy2_to_rgb ({yw}x{h}) "
              f"bit-equal to the port's op; native with 8 threads "
              f"{res['nv12_ms'][key]:.3f} / {res['yuy2_ms'][key]:.3f} ms, "
              f"the op on the host's CPU {res['op_ms'][key]:.3f} ms (host "
              f"clock) | {card}", flush=True)
    ring = runtime.NativeFrameRing(capacity=3, slot_bytes=16)
    for i in range(RING_PUSHES):
        ring.push(np.full(16, i % 251, np.uint8))
    stats, length = ring.stats, len(ring)
    popped = [ring.pop() for _ in range(4)]
    ring.close()
    want_seq = [RING_PUSHES - 2, RING_PUSHES - 1, RING_PUSHES]
    if stats != {"pushed": RING_PUSHES, "dropped": RING_PUSHES - 3,
                 "popped": 0} or length != 3 or popped[3] is not None \
            or [p[0] for p in popped[:3]] != want_seq \
            or [int(p[1][0]) for p in popped[:3]] != [
                (s - 1) % 251 for s in want_seq]:
        raise AssertionError(f"runtime: ring {stats}, len {length}, popped "
                             f"{[p and p[0] for p in popped]}")
    t0 = time.perf_counter()
    for i in range(SYNTH_FRAMES):
        runtime.synth_nv12(1920, 1080, 100 + i, 200, 96)
    res["synth_fps_1080p"] = SYNTH_FRAMES / (time.perf_counter() - t0)
    res["ring"] = stats
    print(f"runtime: ring of 3 kept the newest 3 of {RING_PUSHES} pushes "
          f"({stats}); synth_nv12 {res['synth_fps_1080p']:.1f} frames/s at "
          f"1920x1080 (host clock) | {card}", flush=True)
    return res


# profile_scan / profile_streams: the marginal ms a step (a slope of device
# time) against the device ms a step over --reps steps, which also holds
# the run's set-up (a template init, the final read) spread over the reps:
# at most MARGINAL_NOISE x it, at least (1 - MARGINAL_SETUP) x it.  A first
# card run with other processes on the card read 0.78-1.13 x (prep alone
# below 0.85: its template init is large next to a 0.25 ms step;
# profile_streams' slope spans 5 steps).
MARGINAL_SETUP, MARGINAL_NOISE = 0.30, 1.15


def script_json(mod, argv) -> tuple:
    """``mod.main(argv)`` in this process: (rc, its last JSON line, its
    stdout, the kernel launches it made)."""
    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    counts = read_counts()
    text = out.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if rc != 0 or not lines:
        raise AssertionError(f"{mod.__name__} {argv} exited {rc}: "
                             f"{text[-3000:]}")
    return rc, json.loads(lines[-1]), text, counts


def torch_layout(params, cfg) -> dict:
    """The parameters as a PyTorch-export ONNX file names and lays them out
    (the inverse of the importer's name map)."""
    from gstreamer_vit_tracker_tpu_torch.models import import_onnx as io_

    back = {io_._t: lambda a: a.T,
            io_._conv: lambda a: a.transpose(3, 2, 0, 1),
            io_._patch: lambda a: a.reshape(cfg.patch_size, cfg.patch_size,
                                            3, -1).transpose(3, 2, 0, 1),
            io_._pos: lambda a: a[None], io_._ident: lambda a: a}
    out, seen = {}, set()
    for name, (path, conv) in io_.default_name_map(params).items():
        if path not in seen:
            seen.add(path)
            leaf = io_._get_path(params, path).detach().cpu().numpy()
            out[name] = np.ascontiguousarray(back[conv](leaf))
    return out


def scripts_phase(dev, card: str, tmp: str) -> dict:
    """The new scripts through ``main(argv)`` on the card, each exiting 0
    with its JSON line; the ONNX pair round-trips the shipped flagship."""
    from gstreamer_vit_tracker_tpu_torch.config import ModelConfig
    from gstreamer_vit_tracker_tpu_torch.models import import_onnx, weights
    from gstreamer_vit_tracker_tpu_torch.scripts import (
        bench_serve, export_vittrack_onnx, import_vittrack_onnx, profile_scan,
        profile_streams, soak)

    res = {}
    _, res["profile_scan"], text, counts = script_json(
        profile_scan, ["--reps", "5"])
    res["profile_scan"]["launches"] = counts
    print(text.rstrip(), flush=True)
    print(f"profile_scan kernel launches {counts} | {card}", flush=True)
    _, res["profile_streams"], text, counts = script_json(
        profile_streams, ["--reps", "5"])
    res["profile_streams"]["launches"] = counts
    print(text.rstrip(), flush=True)
    print(f"profile_streams kernel launches {counts} | {card}", flush=True)
    for key in ("profile_scan", "profile_streams"):
        if not res[key]["device_ms"] or not all(
                v > 0 for v in res[key]["device_ms"].values()):
            raise AssertionError(f"{key}: no device time")
        # The marginal ms a step is a slope of device time: positive, and at
        # most its device ms a step over --reps steps (which holds the run's
        # set-up too), less at most MARGINAL_SETUP of it.
        for label, d in res[key]["device_ms"].items():
            m = res[key][f"{label}_ms"]
            print(f"{key} {label}: marginal {m:.4f} ms a step, device "
                  f"{d:.4f} ms a step over --reps steps (bound "
                  f"{1 - MARGINAL_SETUP:.2f}-{MARGINAL_NOISE:.2f} x)",
                  flush=True)
            if not (1 - MARGINAL_SETUP) * d <= m <= MARGINAL_NOISE * d:
                raise AssertionError(f"{key} {label}: marginal {m} ms off "
                                     f"its device ms {d}")
    _, res["bench_serve"], _, counts = script_json(
        bench_serve, ["--streams", "4", "--frames", "30"])
    print(f"bench_serve: {json.dumps(res['bench_serve'])} | {card}",
          flush=True)
    t0 = time.perf_counter()
    _, res["soak"], _, _ = script_json(soak, [
        "--frames", "1500", "--model", "corr-tiny", "--width", "320",
        "--height", "256", "--source-fault-every", "397",
        "--device-fault-every", "601", "--corrupt-every", "251",
        "--sample-s", "0.25"])
    print(f"soak ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(res['soak'])} | {card}", flush=True)
    if not res["soak"]["ok"]:
        raise AssertionError("soak: a check failed")

    # ONNX: the exported graph holds every shipped tensor; a PyTorch-layout
    # file of the same tensors imports back to them, bit for bit.
    ckpt = weights.checkpoint_path("vittrack-t")
    graph = os.path.join(tmp, "vittrack.onnx")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = export_vittrack_onnx.main(["--checkpoint", ckpt, "--out", graph])
    if rc != 0:
        raise AssertionError(f"export_vittrack_onnx exited {rc}")
    exported = {}
    for arr in import_onnx.read_onnx_tensors(graph).values():
        exported.setdefault(arr.size, []).append(np.sort(arr.ravel()))
    cfg = ModelConfig()
    params = weights.load_npz(ckpt, cfg, device=dev)
    src = os.path.join(tmp, "torch_layout.onnx")
    import_onnx.write_onnx_tensors(src, torch_layout(params, cfg))
    back = os.path.join(tmp, "imported.npz")
    with contextlib.redirect_stdout(out):
        rc = import_vittrack_onnx.main(["--onnx", src, "--out", back])
    if rc != 0:
        raise AssertionError(f"import_vittrack_onnx exited {rc}")
    with np.load(ckpt) as want, np.load(back) as got:
        missing = [k for k in want.files if not any(
            np.array_equal(np.sort(want[k].astype(np.float32).ravel()), g)
            for g in exported.get(want[k].size, []))]
        differ = [k for k in want.files if k not in got.files
                  or not np.array_equal(got[k], want[k].astype(np.float32))]
        n = len(want.files)
    print(f"onnx: {out.getvalue().strip()}; the export holds {n - len(missing)}"
          f" of {n} shipped tensors, the import gives back {n - len(differ)} "
          f"of {n} bit for bit", flush=True)
    if missing or differ:
        raise AssertionError(f"onnx: missing {missing[:5]}, differ "
                             f"{differ[:5]}")
    res["onnx"] = {"tensors": n}
    return res


def checkpoint_phase(dev, state) -> dict:
    """``save_tree`` / ``load_tree`` of a live card TrackState and of an
    AdamW state, bit-equal after loading onto the card."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.train import step as train

    params = weights.load_npz(weights.checkpoint_path("vittrack-t"),
                              PRESETS["vittrack-t"], device=dev)
    ts = train.create_train_state(params, opt=train.make_optimizer(1e-4))
    gen = torch.Generator(device=dev).manual_seed(3)
    ts = ts._replace(opt_state=ts.opt_state._replace(
        mu=train.tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                                device=dev),
                          ts.opt_state.mu)))
    like_ts = train.create_train_state(
        train.tree_map(torch.zeros_like, params),
        opt=train.make_optimizer(1e-4))
    like_st = type(state)(*(torch.zeros_like(t) for t in state))
    n = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, tree, like in (("track_state", state, like_st),
                                 ("adamw", ts, like_ts)):
            path = os.path.join(tmp, f"{name}.pt")
            weights.save_tree(path, tree)
            back = weights.load_tree(path, like)
            a, b = ([x for x in train.tree_leaves(t) if x is not None]
                    for t in (tree, back))
            if len(a) != len(b) or not all(
                    y.device == x.device and x.dtype == y.dtype
                    and torch.equal(x, y)
                    for x, y in zip(a, b)):
                raise AssertionError(f"checkpoint: {name} differs after the "
                                     f"round trip")
            n += len(a)
    print(f"checkpoint: save_tree / load_tree of the card's final uhd "
          f"TrackState ({state.z_tok.dtype} template) and a flagship AdamW "
          f"state, {n} tensors bit-equal on the card", flush=True)
    return {"tensors": n}


def config5_phase(dev, card: str, params, cfg, cparams) -> dict:
    t_phase = time.perf_counter()
    res = {"uhd": uhd_phase(dev, card, params, cfg, cparams)}
    state = res["uhd"].pop("state")
    res["runtime"] = runtime_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        res["scripts"] = scripts_phase(dev, card, tmp)
    res["checkpoint"] = checkpoint_phase(dev, state)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"config 5, runtime, scripts, checkpoints: {res['seconds']:.1f} s",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 11: parallel/ over ranks of the one card
# ---------------------------------------------------------------------------

MESH_SLOTS = 16
MESH_TICKS = 3
MESH_TRAIN_STEPS = 5
MESH_DRYRUN_RANKS = 8
# A mesh of one rank computes what one engine computes: bit for bit.
# 2x1 and 1x2 against one engine, tick by tick from its state: phase 5's
# card-vs-CPU bounds (CPU_BOX_TOL, CPU_SCORE_TOL).  Every score is held to
# its bound.  A box may also jump to a neighbouring cell of the score map
# where two cells nearly tie: another summation order (the dp slice's
# smaller batch, the tp all-reduce) moves the bf16 encoder by an ulp of its
# residual stream, and one such flip moved one slot of 16 by 11.5 px (its
# score by 0.0033) in a CPU rehearsal of the 1x2 tick.  So at most
# MESH_TIE_FLIPS slots a tick may miss the box bound, and each is printed.
MESH_TIE_FLIPS = 1


def mesh_frames(n: int):
    """n ticks of phase 5's MESH_SLOTS seeded 1080p NV12 clips (a moving
    target each), stacked a tick, and each slot's first box."""
    clips = stream_clips(MESH_SLOTS, n)
    ticks = [(np.stack([c[0][t][0] for c in clips]),
              np.stack([c[0][t][1] for c in clips])) for t in range(n)]
    return ticks, [list(c[1][0]) for c in clips]


def mesh_serve_rank(rank: int, n: int, shapes, device: str) -> dict:
    """One rank of phase 11b: for each mesh shape of ``shapes`` (n ranks
    each), the shipped flagship (bf16) behind a MESH_SLOTS-slot SlotEngine
    on phase 5's clips beside one engine in this rank, each mesh tick from
    the one engine's state before it; then the engine's and a
    ShardedStreamTracker's recover()."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import weights

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["vittrack-t"]
    params = weights.load_npz(weights.checkpoint_path("vittrack-t"), cfg,
                              device="cpu")
    ticks, boxes = mesh_frames(MESH_TICKS + 1)
    return {f"{a}x{b}": mesh_serve(cfg, params, ticks, boxes, (a, b),
                                   torch.device(device))
            for a, b in shapes}


def mesh_serve(cfg, params, ticks, boxes, shape, dev) -> dict:
    """One mesh shape of :func:`mesh_serve_rank` on this rank."""
    import torch.distributed as dist

    from gstreamer_vit_tracker_tpu_torch.entry import launch_counts
    from gstreamer_vit_tracker_tpu_torch.parallel import (
        ShardedStreamTracker, make_mesh)
    from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine

    mesh = make_mesh(shape, device=dev)
    one = SlotEngine(params, cfg, MESH_SLOTS, "nv12", device=dev)
    eng = SlotEngine(params, cfg, MESH_SLOTS, "nv12", device=dev, mesh=mesh)
    for e in (one, eng):
        for i in range(MESH_SLOTS):
            e.init_slot(e.alloc(), (ticks[0][0][i], ticks[0][1][i]), boxes[i])
    active = np.ones(MESH_SLOTS, bool)
    rows = slice(eng.rows.start, eng.rows.stop)
    d_box, d_score, launches = [], [], {}
    for t in range(1, MESH_TICKS + 1):
        # From the one engine's state: this rank's rows of it.
        eng.state = type(eng.state)(*(x[rows].clone() for x in one.state))
        before = launch_counts()
        got = eng.step(ticks[t], active)
        after = launch_counts()
        for k in after:
            launches[k] = launches.get(k, 0) + after[k] - before[k]
        want = one.step(ticks[t], active)
        if got.shape != (MESH_SLOTS, 5) or not np.isfinite(got).all():
            raise AssertionError(f"mesh {shape}: misshapen or non-finite rows")
        d_box.append(np.abs(got[:, :4] - want[:, :4]).max(axis=1).tolist())
        d_score.append(float(np.abs(got[:, 4] - want[:, 4]).max()))
    # The engine's recover(): the snapshot comes back, bit for bit.
    eng.snapshot()
    saved = [x.clone() for x in eng.state]
    eng.step(ticks[1], active)
    lost = eng.recover()
    engine_recovered = not lost and all(
        torch.equal(a, b) for a, b in zip(eng.state, saved))
    # ShardedStreamTracker: init, a tick, a snapshot, a tick, recover().
    tr = ShardedStreamTracker(mesh, params, cfg, frame_format="nv12",
                              snapshot_every=2, device=dev)
    tr.init(ticks[0], np.asarray(boxes, np.float32)[:, None, :])
    tr.update(ticks[1])
    tr.update(ticks[2])                   # snapshots before it steps
    snap = [x.to(dev) for x in tr._snapshot[0]]
    tr.recover()
    tracker_recovered = all(torch.equal(a, b) for a, b in zip(tr.state,
                                                              snap))
    bx, sc = tr.update(ticks[3])
    return {"backend": dist.get_backend(), "rows": [eng.rows.start,
                                                    eng.rows.stop],
            "d_box": d_box, "d_score": d_score, "launches": launches,
            "engine_recovered": engine_recovered,
            "tracker_recovered": tracker_recovered,
            "tracker_finite": bool(torch.isfinite(bx).all()
                                   and torch.isfinite(sc).all()),
            "qkv_cols": eng.params["backbone"]["blocks"][0]["qkv"][
                "kernel"].shape[1]}


def mesh_train_argv(out: str, device: str):
    from gstreamer_vit_tracker_tpu_torch.models import weights

    return ["--cpu"] * (device == "cpu") + ["--preset", "vittrack-t", "--init-from",
            weights.checkpoint_path("vittrack-t"), "--lr", "1e-4", "--batch",
            str(TRAIN9_BATCH), "--dataset-size", str(TRAIN9_DATASET),
            "--seed", "0", "--data-diversity", "v1", "--steps",
            str(MESH_TRAIN_STEPS), "--log-every", str(MESH_TRAIN_STEPS),
            "--out", out]


def mesh_train_rank(rank: int, n: int, out: str, device: str) -> dict:
    """One rank of phase 11c: ``train_synthetic --mesh 2x2`` through
    ``run(argv)``; rank 0 holds its checkpoint to the gathered params."""
    from gstreamer_vit_tracker_tpu_torch.entry import launch_counts
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.parallel import sharding
    from gstreamer_vit_tracker_tpu_torch.scripts import train_synthetic

    text = io.StringIO()
    before = launch_counts()
    with contextlib.redirect_stdout(text):
        rep = train_synthetic.run(mesh_train_argv(out, device)
                                  + ["--mesh", "2x2"])
    after = launch_counts()
    full = sharding.gather_params(rep.state.params, rep.mesh)
    res = {"rc": rep.rc, "losses": rep.losses, "stdout": text.getvalue(),
           "launches": {k: after[k] - before[k] for k in after},
           "samples_per_s": rep.samples_per_s}
    if rank == 0:
        saved = weights.flatten(weights.load_npz(out, rep.cfg,
                                                 device=torch.device("cpu")))
        final = weights.flatten(weights.tree_to(full, "cpu"))
        res["saved_equal"] = set(saved) == set(final) and all(
            torch.equal(saved[k], final[k]) for k in final)
    return res


def parallel_phase(dev, card: str) -> dict:
    """Phase 11: the dry run on 8 ranks, the flagship SlotEngine on 1x1
    (NCCL), 2x1 and 1x2 meshes, and train_synthetic --mesh 2x2, all ranks
    on this card; then the four A/B and probe scripts."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.entry import dryrun_multichip
    from gstreamer_vit_tracker_tpu_torch.parallel.launch import run_ranks
    from gstreamer_vit_tracker_tpu_torch.parallel.mesh import backend_for
    from gstreamer_vit_tracker_tpu_torch.scripts import (
        ab_fused_prep, ab_grouped_head, probe_int8, probe_relay_fetch,
        train_synthetic)

    t_phase = time.perf_counter()
    cfg = PRESETS["vittrack-t"]
    res = {"backend": {n: backend_for(dev, n) for n in (1, 2, 4, 8)}}
    print(f"parallel: ranks share this card; group backend by world size "
          f"{res['backend']} (NCCL refuses two ranks on one device) | {card}",
          flush=True)

    # -- a. JAX's dry run at its own 4x2 mesh.
    t0 = time.perf_counter()
    dry = dryrun_multichip(MESH_DRYRUN_RANKS, device=dev, timeout=600)
    per_rank = [r["train_launches"]["attention_single"]
                + r["train_launches"]["attention_flash"]
                for r in dry["launches"]]
    serve_att = [r["serve_launches"]["attention_single"]
                 + r["serve_launches"]["attention_flash"]
                 for r in dry["launches"]]
    tp_att = [r["tp_serve_launches"]["attention_single"]
              + r["tp_serve_launches"]["attention_flash"]
              for r in dry["launches"]]
    print(f"dry run ({time.perf_counter() - t0:.1f} s, {MESH_DRYRUN_RANKS} "
          f"ranks, {res['backend'][MESH_DRYRUN_RANKS]}): attention launches "
          f"a rank: train step {per_rank}, serve tick {serve_att}, tp serve "
          f"tick {tp_att} | {card}", flush=True)
    if dry["mesh"] != [4, 2] or set(per_rank) != {12} or set(
            serve_att) != {2} or set(tp_att) != {2}:
        raise AssertionError(f"dry run: mesh {dry['mesh']}, launches "
                             f"{dry['launches']}")
    res["dryrun"] = {k: dry[k] for k in ("mesh", "loss", "loss_single",
                                         "d_loss", "d_serve", "d_tp",
                                         "launches")}

    # -- b. the flagship SlotEngine on 1x1 (NCCL), then 2x1 and 1x2 on one
    # pair of ranks.
    res["serve"] = {}
    served = {}
    for n, shapes in ((1, [(1, 1)]), (2, [(2, 1), (1, 2)])):
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_serve_rank, n, shapes, dev.type, device=dev,
                          timeout=300)
        seconds = time.perf_counter() - t0
        for name in ranks[0]:
            served[name] = ([r[name] for r in ranks], seconds, n)
    for name, (ranks, seconds, n) in served.items():
        bound = (0.0, 0.0) if n == 1 else (CPU_BOX_TOL, CPU_SCORE_TOL)
        flips = {(t, i): round(d, 4) for r in ranks
                 for t, tick in enumerate(r["d_box"])
                 for i, d in enumerate(tick) if d > bound[0]}
        box = max((d for r in ranks for tick in r["d_box"] for d in tick
                   if d <= bound[0]), default=0.0)
        score = max(max(r["d_score"]) for r in ranks)
        att = [r["launches"]["attention_single"] for r in ranks]
        ticks_over = max((sum(1 for (t, _i) in flips if t == k)
                          for k in range(MESH_TICKS)), default=0)
        tie_flips = 0 if n == 1 else MESH_TIE_FLIPS
        print(f"mesh {name} ({ranks[0]['backend']}, {seconds:.1f} s): "
              f"{MESH_SLOTS} flagship slots of 1080p NV12, rows a rank "
              f"{[r['rows'] for r in ranks]}, qkv columns a rank "
              f"{[r['qkv_cols'] for r in ranks]}; {MESH_TICKS} ticks from the "
              f"one engine's state: max|d bbox| {box:.4f} px over the slots "
              f"within it, (tick, slot): |d bbox| beyond it {flips} (at most "
              f"{tie_flips} a tick), max|d score| {score:.5f} (bound "
              f"{bound[0]} px, {bound[1]}); kernel 3 "
              f"launches a rank {att} (want {cfg.depth * MESH_TICKS}); "
              f"SlotEngine.recover {[r['engine_recovered'] for r in ranks]}, "
              f"ShardedStreamTracker.recover "
              f"{[r['tracker_recovered'] for r in ranks]} | {card}",
              flush=True)
        if ticks_over > tie_flips or score > bound[1]:
            raise AssertionError(f"mesh {name}: rows disagree with one engine")
        if set(att) != {cfg.depth * MESH_TICKS} or not all(
                r["engine_recovered"] and r["tracker_recovered"]
                and r["tracker_finite"] for r in ranks):
            raise AssertionError(f"mesh {name}: {ranks}")
        if ranks[0]["backend"] != res["backend"][n]:
            raise AssertionError(f"mesh {name}: backend {ranks[0]['backend']}")
        res["serve"][name] = {"backend": ranks[0]["backend"], "d_box": box,
                              "tie_flips": {f"{t}:{i}": d for (t, i), d in
                                            flips.items()},
                              "d_score": score, "kernel3_launches": att,
                              "seconds": seconds}

    # -- c. train_synthetic --mesh 2x2 against one process.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_train_rank, 4, os.path.join(tmp, "mesh.npz"),
                          dev.type, device=dev, timeout=600)
        seconds = time.perf_counter() - t0
        with contextlib.redirect_stdout(io.StringIO()):
            one = train_synthetic.run(mesh_train_argv(os.path.join(
                tmp, "one.npz"), dev.type))
    mesh_losses = ranks[0]["losses"]
    # Every rank's losses (the data mean each rank reads; the two model
    # ranks of a data slice may differ in the last bits) against one
    # process.
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["losses"], one.losses))
    flash = [r["launches"]["attention_flash"] for r in ranks]
    spread = max(max(step) - min(step)
                 for step in zip(*(r["losses"] for r in ranks)))
    print(ranks[0]["stdout"].rstrip())
    print(f"train_synthetic --mesh 2x2 ({seconds:.1f} s, "
          f"{res['backend'][4]}): rank 0's losses "
          f"{[round(v, 6) for v in mesh_losses]}, ranks' largest spread "
          f"{spread:.2e}"
          f", one process {[round(v, 6) for v in one.losses]}, max relative "
          f"difference {rel:.2e} (bound {TRAIN_LOSS_RTOL}); kernel 4 launches "
          f"a rank {flash} (want {cfg.depth * MESH_TRAIN_STEPS}); saved npz "
          f"equals the gathered params: {ranks[0]['saved_equal']} | {card}",
          flush=True)
    if any(r["rc"] != 0 or len(r["losses"]) != MESH_TRAIN_STEPS
           for r in ranks):
        raise AssertionError(f"train_synthetic --mesh 2x2: {ranks}")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError("train_synthetic --mesh 2x2: the losses "
                             "disagree with one process")
    if not ranks[0]["saved_equal"]:
        raise AssertionError("train_synthetic --mesh 2x2: the saved npz is "
                             "not the gathered params")
    if set(flash) != {cfg.depth * MESH_TRAIN_STEPS}:
        raise AssertionError(f"train_synthetic --mesh 2x2: kernel 4 "
                             f"launches {flash}")
    res["train"] = {"losses": mesh_losses, "one_process": one.losses,
                    "rel": rel, "kernel4_launches": flash,
                    "seconds": seconds}

    # -- d. the four scripts with short arguments.
    res["scripts"] = {}
    for mod, argv in ((ab_fused_prep, ["--reps", "3"]),
                      (ab_grouped_head, ["--reps", "2"]),
                      (probe_int8, ["--reps", "2", "--big-reps", "1"]),
                      (probe_relay_fetch, [])):
        t0 = time.perf_counter()
        _, line, text, counts = script_json(mod, argv)
        name = mod.__name__.rsplit(".", 1)[1]
        print(text.rstrip(), flush=True)
        print(f"{name} ({time.perf_counter() - t0:.1f} s) kernel launches "
              f"{counts} | {card}", flush=True)
        line["launches"] = counts
        res["scripts"][name] = line
    if not res["scripts"]["ab_fused_prep"]["launches"]["fused_prep_embed"]:
        raise AssertionError("ab_fused_prep: kernel 5 never launched")
    if not res["scripts"]["probe_int8"]["int8_exact"]:
        raise AssertionError("probe_int8: the int8 product is not exact")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"parallel and scripts: {res['seconds']:.1f} s", flush=True)
    return res


# Phase 12: the bench with every config on, the counts cut to keep it near
# half a minute (bench.py's defaults otherwise: a pool of 16, 16 streams, 8
# objects, 16 slots, best of 2 timed runs).
BENCH_FRAMES, BENCH_LOOP = 120, 50
BENCH_ARGV = ["--frames", str(BENCH_FRAMES), "--loop-frames", str(BENCH_LOOP)]
# The keys of its line: the JAX bench's, with bench.py's substitutions.
BENCH_TEXT_KEYS = ("metric", "unit", "backend", "model", "uhd_hud",
                   "gpu_name", "gpu_power_limit")
BENCH_NUMBER_KEYS = (
    "value", "scan_step_ms_mean", "python_loop_fps", "sync_p50_ms",
    "sync_p99_ms", "gflop_per_frame", "achieved_tflops", "mfu_vs_h100_bf16",
    "stream_fps_total", "streams", "stream_gflop_per_frame",
    "stream_achieved_tflops", "stream_mfu_vs_h100_bf16",
    "object_tracks_per_s", "objects", "uhd_fps", "uhd_gflop_per_frame",
    "uhd_achieved_tflops", "uhd_mfu_vs_h100_bf16", "rgb_1080p_fps",
    "yuy2_640x512_fps", "serve_fps", "serve_ticks_per_s", "serve_slots",
    "serve_fps_pipelined", "serve_ticks_per_s_pipelined",
    "serve_pipeline_depth", "ingest_fps", "ingest_mb_s", "h2d_mb_s")


def bench_launches(depth: int) -> dict:
    """The kernel launches each config of ``BENCH_ARGV`` makes.  kernel 1
    once a tracked frame: the headline's warm-up run and two timed runs of
    BENCH_FRAMES steps; the loop's warm-up step, its chained and its synced
    runs; uhd's, rgb's and yuy2's warm-up and two timed runs; ingest's
    warm-up step and its run (at most 200 steps).  kernel 3 ``depth`` times
    a batched step: stream's and object's three runs of at most 300 steps;
    serve's warm-up tick, two timed runs of ticks, a warm-up and two timed
    runs of pipelined ticks.  Nothing else launches: the inits embed the
    template only."""
    n = BENCH_FRAMES
    batched = min(n, 300)
    ticks = max(10, min(50, n // 10))
    encoder = {"headline": 3 * n, "loop": 1 + 2 * min(n, BENCH_LOOP),
               "uhd": 3 * min(n, 200), "rgb": 3 * n, "yuy2": 3 * n,
               "ingest": 1 + min(n, 200)}
    attention = {"stream": 3 * batched, "object": 3 * batched,
                 "serve": 1 + 5 * ticks}
    zero = {"vit_encoder": 0, "vit_block": 0, "attention_single": 0,
            "attention_flash": 0, "fused_prep_embed": 0}
    out = {k: dict(zero, vit_encoder=v) for k, v in encoder.items()}
    out.update({k: dict(zero, attention_single=depth * v)
                for k, v in attention.items()})
    return out


def bench_phase(card: str, depth: int) -> dict:
    """The port's bench on the card, in this process (phase 12)."""
    from gstreamer_vit_tracker_tpu_torch import bench

    t_phase = time.perf_counter()
    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out):
        rc, line = bench.run(BENCH_ARGV)
    total = read_counts()
    seconds = time.perf_counter() - t_phase
    print(out.getvalue().rstrip(), flush=True)
    errors = {k: v for k, v in line.items() if k.endswith("_error")}
    if rc != 0 or errors:
        raise AssertionError(f"bench {BENCH_ARGV} exited {rc}: {errors}")
    missing = [k for k in BENCH_TEXT_KEYS + BENCH_NUMBER_KEYS + (
        "runs_s", "launches") if k not in line]
    if missing:
        raise AssertionError(f"bench line lacks {missing}")
    bad = [k for k in BENCH_NUMBER_KEYS
           if not (isinstance(line[k], (int, float))
                   and np.isfinite(line[k]) and line[k] > 0)]
    bad += [k for k in BENCH_TEXT_KEYS
            if not (isinstance(line[k], str) and line[k])]
    bad += [k for k, walls in line["runs_s"].items()
            if not walls or min(walls) <= 0]
    if bad:
        raise AssertionError(f"bench keys not finite and positive: {bad}")
    if line["backend"] != "cuda":
        raise AssertionError(f"bench ran on {line['backend']}")
    want = bench_launches(depth)
    if line["launches"] != want:
        raise AssertionError(f"bench launches {line['launches']} != {want}")
    summed = {k: sum(c[k] for c in want.values()) for k in total}
    if total != summed:
        raise AssertionError(f"bench launched {total} in all, its configs "
                             f"{summed}")
    print(f"bench ({' '.join(BENCH_ARGV)}): every config exited clean, "
          f"launches as stated ({summed}); {seconds:.1f} s | {card}",
          flush=True)
    return {"line": line, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 13: the compiled entry points (CUDA graphs, utils/graph.py)
# ---------------------------------------------------------------------------

JIT_STEPS = 30                # update_packed_jit steps on the flagship
JIT_TICKS = 20                # engine ticks at SERVE_SLOTS slots
JIT_POOL, JIT_POOL_REPS = 16, 48    # update_scan_pool: wraps the pool 3x
JIT_HUD_POOL, JIT_HUD_REPS = 4, 12  # update_scan_hud_pool at 4K
JIT_OBJECTS = 8               # update_objects_jit targets in one frame
JIT_OBJECT_STEPS = 20
JIT_TIMED = 20                # steps in each timed window


def _same(a, b) -> bool:
    """Every leaf of two trees of tensors equal, bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and bool(
            torch.equal(a, b))
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _max_diff(a, b) -> float:
    if isinstance(a, torch.Tensor):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    return max(_max_diff(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def no_sync():
    """Raise on any host sync inside the block."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def traced_ms(fn, reps: int, per: int, kernel: str = "") -> dict:
    """``reps`` calls of ``fn`` (``per`` steps each) after a warm-up: host
    wall ms a step to the final synchronise, unprofiled; then under
    ``torch.profiler``: device busy ms a step (the CUDA activities summed:
    one stream, they do not overlap), device activities a step, and the
    idle share of the profiled window's wall; with ``kernel``, the mean
    device us of the activities whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / (reps * per)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (reps * per)
    cuda = [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.time_range.elapsed_us() for ev in cuda) / 1e3 / (reps * per)
    res = {"host_ms": host_ms, "profiled_wall_ms": wall_ms,
           "device_ms": busy, "activities": len(cuda) / (reps * per),
           "idle_share": max(0.0, 1.0 - busy / wall_ms)}
    if kernel:
        us = [ev.time_range.elapsed_us() for ev in cuda if kernel in ev.name]
        if not us:
            raise AssertionError(f"no {kernel} activity in the trace")
        res["kernel_us"] = sum(us) / len(us)
        res["kernel_count"] = len(us) / (reps * per)
    return res


def jit_check(name, eager, compiled, launches, want, traces) -> None:
    """Fail unless the compiled path's results equal the eager function's
    bit for bit, it launched ``want`` and nothing else, and each wrapper
    of ``traces`` captured at most once (a key an earlier phase captured,
    such as phase 10's HUD pool, is replayed)."""
    if not _same(eager, compiled):
        raise AssertionError(f"{name}: the compiled results differ from the "
                             f"eager function's (max |d| "
                             f"{_max_diff(eager, compiled):.3e})")
    if launches != dict(launches, **want) or any(
            n for k, n in launches.items() if k not in want):
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    bad = {w.name: n for w, n in traces.items() if n > 1}
    if bad:
        raise AssertionError(f"{name}: captures {bad}, expected at most "
                             f"one a key")
    return {w.name: n for w, n in traces.items()}


def print_timing(name: str, t: dict, card: str) -> None:
    e, c = t["eager"], t["compiled"]
    print(f"compiled {name}: host wall ms a step eager {e['host_ms']:.4f} / "
          f"compiled {c['host_ms']:.4f}; device busy ms a step (torch."
          f"profiler) eager {e['device_ms']:.4f} / compiled "
          f"{c['device_ms']:.4f}; device activities a step eager "
          f"{e['activities']:.1f} / compiled {c['activities']:.1f}; idle "
          f"share eager {e['idle_share']:.3f} / compiled "
          f"{c['idle_share']:.3f} | {card}", flush=True)


def jit_phase(dev, card: str, params, cfg) -> dict:
    """Phase 13: each compiled path against its eager function on the card
    (bit for bit), at most one capture a key, the kernels launched exactly
    once a step, no host sync inside the replays; then eager against
    compiled: host wall, device busy and idle share a step."""
    from gstreamer_vit_tracker_tpu_torch.ops import font
    from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine
    from gstreamer_vit_tracker_tpu_torch.serve import engine as engine_mod
    from gstreamer_vit_tracker_tpu_torch.tracker import core, multi, scan

    t_phase = time.perf_counter()
    res = {}
    frames, boxes = nv12_clip(JIT_STEPS + 1, seed=13)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    enc1 = {"vit_encoder": 1}

    # -- a. init_jit + update_packed_jit, JIT_STEPS flagship steps ----------
    def traces(*ws):
        return {w: w.traces for w in ws}

    t0s = traces(core.init_jit, core.update_packed_jit)
    st_e = core.init(params, clip[0], boxes[0], cfg, "nv12", dev)
    out_e = []
    s = st_e
    for f in clip[1:]:
        s, p = core.update_packed(params, s, f, cfg, "nv12", dev)
        out_e.append(p)
    zero_counts()
    st_c = core.init_jit(params, clip[0], boxes[0], cfg, "nv12", dev)
    if not _same(st_e, st_c):
        raise AssertionError("init_jit differs from init")
    s, p = core.update_packed_jit(params, st_c, clip[1], cfg, "nv12", dev)
    out_c = [p]
    with no_sync():
        for f in clip[2:]:
            s, p = core.update_packed_jit(params, s, f, cfg, "nv12", dev)
            out_c.append(p)
    counts = read_counts()
    caps = jit_check("update_packed_jit", out_e, out_c, counts,
              {"vit_encoder": JIT_STEPS},
              {w: w.traces - n for w, n in t0s.items()})
    held = out_c[0].clone()
    core.update_packed_jit(params, s, clip[1], cfg, "nv12", dev)
    if not torch.equal(held, out_c[0]):
        raise AssertionError("update_packed_jit: a held result changed")
    frame = clip[1]
    st_t = core.init(params, clip[0], boxes[0], cfg, "nv12", dev)
    box = [core.init_jit(params, clip[0], boxes[0], cfg, "nv12", dev)]

    def eager_step():
        nonlocal st_t
        st_t, _ = core.update_packed(params, st_t, frame, cfg, "nv12", dev)

    def jit_step():
        box[0], _ = core.update_packed_jit(params, box[0], frame, cfg, "nv12",
                                           dev)

    res["step"] = {"eager": traced_ms(eager_step, JIT_TIMED, 1),
                   "compiled": traced_ms(jit_step, JIT_TIMED, 1),
                   "launches": counts}
    print(f"compiled step: {JIT_STEPS} update_packed_jit steps on the "
          f"flagship, 1080p NV12, equal to update_packed's bit for bit, "
          f"captures {caps}, launches {counts}, no host sync in the "
          f"replays",
          flush=True)
    print_timing("step (update_packed_jit)", res["step"], card)

    # -- b. the engine: slot writes, JIT_TICKS ticks at SERVE_SLOTS --------
    n = SERVE_SLOTS
    ys = torch.stack([c[0] for c in clip])
    uvs = torch.stack([c[1] for c in clip])
    ticks = []
    for t in range(JIT_TICKS + 1):
        idx = (torch.arange(n, device=dev) + t) % len(clip)
        ticks.append((ys.index_select(0, idx), uvs.index_select(0, idx)))
    eng = SlotEngine(params, cfg, slots=n, snapshot_every=0, device=dev)
    st_e = type(eng.state)(*(t.clone() for t in eng.state))
    for k in range(n):
        st_e = engine_mod._write_slot(
            st_e, eng.params, (ticks[0][0][k], ticks[0][1][k]), boxes[k % 4],
            torch.tensor([k], device=dev), cfg, "nv12", dev)
    active = np.ones(n, bool)
    active_dev = torch.ones((n, 1), dtype=torch.bool, device=dev)
    zero_counts()
    for k in range(n):
        eng.init_slot(eng.alloc(), (ticks[0][0][k], ticks[0][1][k]),
                      boxes[k % 4])
    if not _same(st_e, eng.state):
        raise AssertionError("the compiled slot write differs from the "
                             "eager one")
    got = [eng.step_async(ticks[1], active)]
    with no_sync():
        for t in range(2, JIT_TICKS + 1):
            got.append(eng.step_async(ticks[t], active))
    counts = read_counts()
    got = [g.packed for g in got]
    want = []
    for t in range(1, JIT_TICKS + 1):
        st_e, p = engine_mod._step_packed(eng.params, st_e, ticks[t],
                                          active_dev, cfg, "nv12", dev)
        want.append(p)
    caps = jit_check("engine tick", want, got, counts,
              {"attention_single": cfg.depth * JIT_TICKS},
              {eng._tick: eng._tick.traces, eng._write: eng._write.traces})
    if not _same(st_e, eng.state):
        raise AssertionError("engine tick: the state differs from the eager "
                             "chain's")
    st_t = st_e

    def eager_tick():
        nonlocal st_t
        st_t, p = engine_mod._step_packed(eng.params, st_t, ticks[1],
                                          active_dev, cfg, "nv12", dev)

    res["tick"] = {"eager": traced_ms(eager_tick, JIT_TIMED, 1),
                   "compiled": traced_ms(
                       lambda: eng.step_async(ticks[1], active),
                       JIT_TIMED, 1),
                   "launches": counts}
    print(f"compiled tick: {n} slot writes and {JIT_TICKS} engine ticks at "
          f"{n} slots equal to the eager chain's bit for bit, captures "
          f"{caps}, launches {counts}, no host sync in the replays",
          flush=True)
    print_timing(f"tick ({n} slots)", res["tick"], card)
    del ticks, eng

    # -- c. update_scan_pool on the JIT_POOL-frame pool -----------------------
    pool = (ys[:JIT_POOL].contiguous(), uvs[:JIT_POOL].contiguous())
    st0 = core.init(params, clip[0], boxes[0], cfg, "nv12", dev)
    s, want = st0, []
    for i in range(JIT_POOL_REPS):
        s, _, c = core.update(params, s, (pool[0][i % JIT_POOL],
                                          pool[1][i % JIT_POOL]), cfg,
                              "nv12", dev)
        want.append(c)
    want = (s, torch.stack(want))
    n0 = scan._pool_step.traces
    scan.update_scan_pool(params, st0, pool, 2, cfg, "nv12", device=dev)
    zero_counts()
    with no_sync():
        got = scan.update_scan_pool(params, st0, pool, JIT_POOL_REPS, cfg,
                                    "nv12", device=dev)
    counts = read_counts()
    caps = jit_check("update_scan_pool", want, got, counts,
              {"vit_encoder": JIT_POOL_REPS},
              {scan._pool_step: scan._pool_step.traces - n0})

    def eager_pool():
        s = st0
        for i in range(JIT_POOL_REPS):
            s, _, c = core.update(params, s, (pool[0][i % JIT_POOL],
                                              pool[1][i % JIT_POOL]), cfg,
                                  "nv12", dev)

    res["scan_pool"] = {
        "eager": traced_ms(eager_pool, 1, JIT_POOL_REPS),
        "compiled": traced_ms(lambda: scan.update_scan_pool(
            params, st0, pool, JIT_POOL_REPS, cfg, "nv12", device=dev), 1,
            JIT_POOL_REPS),
        "launches": counts}
    print(f"compiled scan pool: update_scan_pool, {JIT_POOL_REPS} steps on "
          f"the {JIT_POOL}-frame 1080p pool, equal to the eager loop bit for "
          f"bit, captures {caps}, launches {counts}, no host sync", flush=True)
    print_timing("scan pool (update_scan_pool)", res["scan_pool"], card)

    # -- d. update_scan_hud_pool at 4K ---------------------------------------
    uhd, uboxes = nv12_clip(JIT_HUD_POOL, seed=14, h=UHD_H, w=UHD_W)
    uys = torch.as_tensor(np.stack([f[0] for f in uhd]), device=dev)
    uuvs = torch.as_tensor(np.stack([f[1] for f in uhd]), device=dev)
    hud_text = tuple(font.encode_text(t, k) for t, k in HUD_TEXT)
    st0 = core.init(params, (uys[0], uuvs[0]), uboxes[0], cfg, "nv12", dev)
    glyphs = scan.hud_glyphs(hud_text, dev)
    s, disp, want = st0, torch.zeros_like(uys[0]), []
    for i in range(JIT_HUD_REPS):
        f = (uys[i % JIT_HUD_POOL], uuvs[i % JIT_HUD_POOL])
        s, bb, c = core.update(params, s, f, cfg, "nv12", dev)
        scan.composite_hud(disp, f[0], bb, c, glyphs)
        want.append(c)
    want = (s, disp, torch.stack(want))
    n0 = scan._hud_step.traces
    scan.update_scan_hud_pool(params, st0, (uys, uuvs), hud_text, 2, cfg, dev)
    zero_counts()
    with no_sync():
        got = scan.update_scan_hud_pool(params, st0, (uys, uuvs), hud_text,
                                        JIT_HUD_REPS, cfg, dev)
    counts = read_counts()
    caps = jit_check("update_scan_hud_pool", want, got, counts,
              {"vit_encoder": JIT_HUD_REPS},
              {scan._hud_step: scan._hud_step.traces - n0})

    def eager_hud():
        s = st0
        for i in range(JIT_HUD_REPS):
            f = (uys[i % JIT_HUD_POOL], uuvs[i % JIT_HUD_POOL])
            s, bb, c = core.update(params, s, f, cfg, "nv12", dev)
            scan.composite_hud(disp, f[0], bb, c, glyphs)

    res["hud_pool"] = {
        "eager": traced_ms(eager_hud, 1, JIT_HUD_REPS),
        "compiled": traced_ms(lambda: scan.update_scan_hud_pool(
            params, st0, (uys, uuvs), hud_text, JIT_HUD_REPS, cfg, dev), 1,
            JIT_HUD_REPS),
        "launches": counts}
    print(f"compiled HUD pool: update_scan_hud_pool, {JIT_HUD_REPS} frames on "
          f"{JIT_HUD_POOL} {UHD_W}x{UHD_H} NV12 frames, state, display and "
          f"scores equal to the eager loop bit for bit, captures {caps}, "
          f"launches {counts}, no host sync", flush=True)
    print_timing(f"HUD frame ({UHD_W}x{UHD_H})", res["hud_pool"], card)
    del uys, uuvs

    # -- e. init_objects_jit + update_objects_jit, template update on --------
    mcfg = dataclasses.replace(cfg, template_update_enabled=True)
    bbs = (np.tile(boxes[0], (JIT_OBJECTS, 1))
           + np.arange(JIT_OBJECTS)[:, None] * np.asarray([40.0, 20.0, 0, 0]))
    act = np.ones(JIT_OBJECTS, bool)
    act[-1] = False
    t0s = traces(multi.init_objects_jit, multi.update_objects_jit)
    s = multi.init_objects(params, clip[0], bbs, mcfg, "nv12", dev)
    want = []
    for f in clip[1:JIT_OBJECT_STEPS + 1]:
        s, b, c = multi.update_objects(params, s, f, act, mcfg, "nv12",
                                       exclusive=True, device=dev)
        want.append((b, c))
    want.append(s)
    zero_counts()
    sc = multi.init_objects_jit(params, clip[0], bbs, mcfg, "nv12", dev)
    got = []
    for k, f in enumerate(clip[1:JIT_OBJECT_STEPS + 1]):
        with (no_sync() if k else contextlib.nullcontext()):
            sc, b, c = multi.update_objects_jit(params, sc, f, act, mcfg,
                                                "nv12", exclusive=True,
                                                device=dev)
        got.append((b, c))
    got.append(sc)
    counts = read_counts()
    caps = jit_check("update_objects_jit", want, got, counts,
              {"attention_single": cfg.depth * JIT_OBJECT_STEPS},
              {w: w.traces - n for w, n in t0s.items()})
    st_t = multi.init_objects(params, clip[0], bbs, mcfg, "nv12", dev)
    box = [sc]

    def eager_objects():
        nonlocal st_t
        st_t, _, _ = multi.update_objects(params, st_t, frame, act, mcfg,
                                          "nv12", exclusive=True, device=dev)

    def jit_objects():
        box[0], _, _ = multi.update_objects_jit(params, box[0], frame, act,
                                                mcfg, "nv12", exclusive=True,
                                                device=dev)

    res["objects"] = {"eager": traced_ms(eager_objects, JIT_TIMED, 1),
                      "compiled": traced_ms(jit_objects, JIT_TIMED, 1),
                      "launches": counts}
    print(f"compiled objects: init_objects_jit and {JIT_OBJECT_STEPS} "
          f"update_objects_jit steps, {JIT_OBJECTS} targets (one inactive, "
          f"exclusive, template update on), equal to the eager steps bit for "
          f"bit, captures {caps}, launches {counts}, no host sync",
          flush=True)
    print_timing(f"objects ({JIT_OBJECTS} targets)", res["objects"], card)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13: {res['seconds']:.1f} s | {card}", flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 14: compiled training (train/step.py through utils/graph.py)
# ---------------------------------------------------------------------------

JIT_TRAIN_STEPS = 20          # train_step calls, phase 7's batch
JIT_SCAN_STEPS = 20           # one train_scan, phase 9a's dataset
JIT_TRAIN_TIMED = 5           # train_step calls in each timed window
# Compiled against eager training, checked with cuDNN's deterministic
# algorithms (the patch embed's weight gradient otherwise sums in an
# order the card does not fix: on a first H100 run 114 of the flagship's
# 145 leaves differed between two eager steps from one state, none with
# them): bit for bit where two eager runs are bit for bit.  Where they
# are not, the compiled run is one more draw from the same spread: its
# largest distance from eager run A, over the losses and the parameters
# together, at most TRAIN_JIT_SPREAD x eager run B's (that run, without
# deterministic algorithms: B 1.03e-05 from A after 20 steps, the
# compiled run 1.40e-05), and its losses within phase 7's card-vs-CPU
# bound of A's.  The timings run with the default algorithms (their own
# captures: the switches are part of a compiled key).
TRAIN_JIT_SPREAD = 4.0


def train_agree(name: str, a, b, c) -> dict:
    """Eager runs ``a`` and ``b`` and compiled run ``c`` (each (losses,
    params)): bit for bit if ``a`` and ``b`` are, else within the eager
    runs' spread (TRAIN_JIT_SPREAD) and TRAIN_LOSS_RTOL."""
    eager_same = _same(a, b)
    d_ab, d_ac = _max_diff(a, b), _max_diff(a, c)
    same = _same(a, c)
    rel = float(((c[0] - a[0]).abs() / a[0].abs()).max())
    print(f"{name}: eager against eager bit for bit: {eager_same} (max |d| "
          f"{d_ab:.3e}; losses {_max_diff(a[0], b[0]):.3e}); compiled "
          f"against eager bit for bit: {same} (max |d| {d_ac:.3e}; losses "
          f"{_max_diff(a[0], c[0]):.3e}, relative {rel:.2e}; params "
          f"{_max_diff(a[1], c[1]):.3e})", flush=True)
    if eager_same and not same:
        raise AssertionError(f"{name}: the compiled run differs from the "
                             f"eager one, which repeats bit for bit")
    if not eager_same and (d_ac > TRAIN_JIT_SPREAD * d_ab
                           or rel > TRAIN_LOSS_RTOL):
        raise AssertionError(f"{name}: the compiled run is {d_ac:.3e} from "
                             f"the eager one (losses {rel:.2e} relative), "
                             f"past {TRAIN_JIT_SPREAD} x the eager runs' "
                             f"spread {d_ab:.3e} or {TRAIN_LOSS_RTOL}")
    return {"eager_bit_equal": eager_same, "bit_equal": same,
            "eager_max_diff": d_ab, "max_diff": d_ac, "loss_rel": rel}


def train_jit_phase(dev, card: str) -> dict:
    """Phase 14: the flagship in float32 (TF32 off) from the shipped
    weights, phase 7's batch of 16: JIT_TRAIN_STEPS compiled ``train_step``
    s and one JIT_SCAN_STEPS-step compiled ``train_scan`` (augmentation on,
    a seeded CPU generator, phase 9a's dataset) against the eager
    functions, with cuDNN's deterministic algorithms (TRAIN_JIT_SPREAD);
    one capture a key, kernel 4 launched 12 times a step and nothing
    else, no host sync in the replays; then, with the default algorithms,
    eager against compiled: host wall, device busy, idle share and
    samples/s a step, and kernel 4's device time inside the replayed
    step."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.train import step as train

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(PRESETS["vittrack-t"], dtype="float32")
    z, x, gt = (torch.as_tensor(a, device=dev)
                for a in train_batch(cfg, TRAIN_BATCH, seed=31))
    opt = train.make_optimizer(TRAIN_LR)
    host = weights.load_npz(weights.checkpoint_path("vittrack-t"), cfg,
                            device=torch.device("cpu"))

    def fresh():
        return train.create_train_state(weights.tree_to(host, dev, copy=True),
                                        opt=opt)

    def params_of(state):
        return [t.clone() for t in train.tree_leaves(state.params)]

    torch.backends.cudnn.deterministic = True
    try:
        res = train_jit_checks(dev, cfg, z, x, gt, opt, fresh, params_of)
    finally:
        torch.backends.cudnn.deterministic = False

    # -- c. eager against compiled, the default algorithms -------------------
    st_e, box = fresh(), [fresh()]

    def eager_step():
        nonlocal st_e
        st_e = train.train_step_eager(st_e, z, x, gt, cfg, opt=opt,
                                      device=dev)[0]

    def jit_step():
        box[0] = train.train_step(box[0], z, x, gt, cfg, opt=opt,
                                  device=dev)[0]

    res["step"].update(
        eager=traced_ms(eager_step, JIT_TRAIN_TIMED, 1),
        compiled=traced_ms(jit_step, JIT_TRAIN_TIMED, 1,
                           kernel="attention_flash"))
    ds = res.pop("dataset")

    def scan(fn):
        fn(fresh(), *ds, torch.Generator().manual_seed(1), cfg, opt,
           n_steps=JIT_SCAN_STEPS, batch=TRAIN_BATCH, device=dev)

    res["scan"].update(
        eager=traced_ms(lambda: scan(train.train_scan_eager), 1,
                        JIT_SCAN_STEPS),
        compiled=traced_ms(lambda: scan(train.train_scan), 1,
                           JIT_SCAN_STEPS),
        window_steps=train.window_steps(JIT_SCAN_STEPS, TRAIN_BATCH,
                                        ds[1].shape[1:], True))
    for name, key in (("train_step", "step"), ("train_scan", "scan")):
        t = res[key]
        for mode in ("eager", "compiled"):
            t[mode]["samples_per_s"] = TRAIN_BATCH / t[mode]["host_ms"] * 1e3
        print_timing(f"{name} (flagship f32, batch {TRAIN_BATCH})", t, card)
        print(f"compiled {name}: samples/s eager "
              f"{t['eager']['samples_per_s']:.1f} / compiled "
              f"{t['compiled']['samples_per_s']:.1f} | {card}", flush=True)

    # -- d. kernel 4 at the training shape -----------------------------------
    shape = (TRAIN_BATCH * cfg.num_heads, cfg.num_tokens,
             cfg.embed_dim // cfg.num_heads)
    res["kernel4"] = attention_case(
        *shape, torch.float32, dev, "flash", "tf32x3", timed=True,
        lib_shape=(TRAIN_BATCH, cfg.num_heads) + shape[1:])
    res["kernel4"]["replay_device_us"] = res["step"]["compiled"]["kernel_us"]
    res["kernel4"]["launches_per_step"] = cfg.depth
    print(f"kernel 4 at the training shape {shape} float32: "
          f"{res['kernel4']['replay_device_us']:.2f} us a launch inside the "
          f"replayed step (torch.profiler), {cfg.depth} launches a step | "
          f"{card}", flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14: {res['seconds']:.1f} s | {card}", flush=True)
    return res


def train_jit_checks(dev, cfg, z, x, gt, opt, fresh, params_of) -> dict:
    """Phase 14's checks (a: ``train_step``, b: ``train_scan``), each
    compiled run against two eager runs (``train_agree``)."""
    from gstreamer_vit_tracker_tpu_torch.train import data
    from gstreamer_vit_tracker_tpu_torch.train import step as train

    k4 = {"attention_flash": cfg.depth}

    # -- a. train_step ------------------------------------------------------
    def eager_steps():
        s, ls = fresh(), []
        for _ in range(JIT_TRAIN_STEPS):
            s, loss, _ = train.train_step_eager(s, z, x, gt, cfg, opt=opt,
                                                device=dev)
            ls.append(loss)
        return torch.stack(ls), params_of(s)

    run_a, run_b = eager_steps(), eager_steps()
    n0 = train.train_step.traces
    s = fresh()
    zero_counts()
    s, loss, _ = train.train_step(s, z, x, gt, cfg, opt=opt, device=dev)
    ls = [loss]
    with no_sync():
        for _ in range(JIT_TRAIN_STEPS - 1):
            s, loss, _ = train.train_step(s, z, x, gt, cfg, opt=opt,
                                          device=dev)
            ls.append(loss)
    counts = read_counts()
    caps = jit_check("train_step", [], [], counts,
                     {k: n * JIT_TRAIN_STEPS for k, n in k4.items()},
                     {train.train_step: train.train_step.traces - n0})
    res = {"step": train_agree("compiled train_step", run_a, run_b,
                               (torch.stack(ls), params_of(s)))}
    res["step"].update(launches=counts, captures=caps)
    print(f"compiled train_step: {JIT_TRAIN_STEPS} flagship float32 steps at "
          f"batch {TRAIN_BATCH}, captures {caps}, launches {counts}, no host "
          f"sync in the replays", flush=True)

    # -- b. train_scan --------------------------------------------------------
    data.set_diversity("v1")
    ds = tuple(torch.as_tensor(a, device=dev)
               for a in data.make_dataset(0, TRAIN9_DATASET, cfg))

    def scan(fn, st=None):
        gen = torch.Generator().manual_seed(1)
        st, gen, ls, parts = fn(st or fresh(), *ds, gen, cfg, opt,
                                n_steps=JIT_SCAN_STEPS, batch=TRAIN_BATCH,
                                device=dev)
        return (ls, params_of(st)), gen.get_state()

    (run_a, g_a), (run_b, _) = (scan(train.train_scan_eager),
                                scan(train.train_scan_eager))
    n0 = train._scan_step.traces
    zero_counts()
    run_c, g_c = scan(train.train_scan)
    counts = read_counts()
    st = fresh()
    with no_sync():
        run_d, _ = scan(train.train_scan, st)
    if not torch.equal(g_a, g_c):
        raise AssertionError("train_scan: the generator ends elsewhere than "
                             "the eager scan leaves it")
    caps = jit_check("train_scan", [], [], counts,
                     {k: n * JIT_SCAN_STEPS for k, n in k4.items()},
                     {train._scan_step: train._scan_step.traces - n0})
    res["scan"] = train_agree("compiled train_scan", run_a, run_b, run_c)
    res["scan_again"] = train_agree("compiled train_scan again", run_a,
                                    run_b, run_d)
    res["scan"].update(launches=counts, captures=caps)
    print(f"compiled train_scan: {JIT_SCAN_STEPS} steps with augmentation "
          f"from a seeded CPU generator, twice (the second under sync debug "
          f"mode error), the generator left as the eager scan leaves it, "
          f"captures {caps}, launches {counts}, no host sync in the replays",
          flush=True)
    res["dataset"] = ds
    return res


# ---------------------------------------------------------------------------
# Phase 15: the programs under a mesh compiled (CUDA graphs, NCCL inside)
# ---------------------------------------------------------------------------

MESH_JIT_TICKS = 20           # tracker and engine ticks at SERVE_SLOTS slots
MESH_JIT_STEPS = 5            # flagship f32 train steps at TRAIN_BATCH
MESH_JIT_TIMED = 10           # ticks in each timed window (train: 5 steps)
PROBE_REPLAYS = 20            # replays of the captured one-rank all-reduce
PROBE_CHAIN = 3000            # ops after the all-reduce in the mode probe
MESH_JIT_PARTS = ("tracker", "engine", "train")


def mesh_jit_run(dev, mesh, parts=MESH_JIT_PARTS, timed: bool = True) -> dict:
    """On this rank under ``mesh`` (NCCL groups): the shipped flagship
    (bf16) behind a ShardedStreamTracker and a mesh SlotEngine at
    SERVE_SLOTS slots over MESH_JIT_TICKS ticks of a 1080p NV12 clip on
    the device (each slot its own offset into it), and MESH_JIT_STEPS
    flagship float32 ``train_step`` s at phase 7's batch (this rank's
    shards and data slice, cuDNN's deterministic algorithms), each
    compiled against its eager mesh body called by name: bit for bit, one
    capture a key, kernel 3 launched depth times a tick and kernel 4 depth
    times a step and nothing else, no host sync inside the replays; with
    ``timed``, eager against compiled host wall, device busy ms and idle
    share a tick or step (the default algorithms)."""
    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import weights
    from gstreamer_vit_tracker_tpu_torch.parallel import (
        ShardedStreamTracker, sharding)
    from gstreamer_vit_tracker_tpu_torch.parallel.mesh import use_mesh
    from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine
    from gstreamer_vit_tracker_tpu_torch.tracker import core, multi
    from gstreamer_vit_tracker_tpu_torch.train import step as train

    cfg = PRESETS["vittrack-t"]
    cpu = torch.device("cpu")
    n, ticks_n = SERVE_SLOTS, MESH_JIT_TICKS
    # Across ranks the replays' NCCL kernels are read from the trace (the
    # tracker's only collective is its gather over data, dimension 0).
    nccl = "nccl" if mesh.size() > 1 else ""
    res = {}
    if "tracker" in parts or "engine" in parts:
        host = weights.load_npz(weights.checkpoint_path("vittrack-t"), cfg,
                                device=cpu)
        frames, boxes = nv12_clip(ticks_n + 1, seed=15)
        clip = [core._frame_on(f, "nv12", dev) for f in frames]
        ys = torch.stack([c[0] for c in clip])
        uvs = torch.stack([c[1] for c in clip])
        ticks = []
        for t in range(ticks_n + 1):
            idx = (torch.arange(n, device=dev) + t) % len(clip)
            ticks.append((ys.index_select(0, idx), uvs.index_select(0, idx)))
        bbs = np.asarray([boxes[k % len(clip)] for k in range(n)],
                         np.float32)[:, None, :]
        active = np.ones(n, bool)
    k3 = {"attention_single": cfg.depth * ticks_n}

    if "tracker" in parts:
        tr_e, tr_c = (ShardedStreamTracker(mesh, host, cfg, "nv12",
                                           snapshot_every=0, device=dev)
                      for _ in range(2))
        tr_e.compiled = False                 # the eager body, by name
        if not tr_c.compiled:
            raise AssertionError("tracker: the mesh's groups do not compile")
        tr_e.init(ticks[0], bbs)
        want = [tr_e.update(ticks[t]) for t in range(1, ticks_n + 1)]
        n0 = multi.init_streams_jit.traces
        zero_counts()
        tr_c.init(ticks[0], bbs)
        got = [tr_c.update(ticks[1])]
        with no_sync():
            got += [tr_c.update(ticks[t]) for t in range(2, ticks_n + 1)]
        counts = read_counts()
        caps = jit_check("mesh tracker", want + [tr_e.state],
                         got + [tr_c.state], counts, k3,
                         {tr_c._step: tr_c._step.traces,
                          multi.init_streams_jit:
                          multi.init_streams_jit.traces - n0})
        res["tracker"] = {"launches": counts, "captures": caps,
                          "rows": int(tr_c.state.bbox.shape[0])}
        if timed:
            res["tracker"].update(
                eager=traced_ms(lambda: tr_e.update(ticks[1]),
                                MESH_JIT_TIMED, 1),
                compiled=traced_ms(lambda: tr_c.update(ticks[1]),
                                   MESH_JIT_TIMED, 1,
                                   kernel=nccl if mesh.size(0) > 1 else ""))
        del tr_e, tr_c

    if "engine" in parts:
        eng_e, eng_c = (SlotEngine(host, cfg, n, "nv12", snapshot_every=0,
                                   device=dev, mesh=mesh) for _ in range(2))
        eng_e.compiled = False
        for e in (eng_e, eng_c):
            for k in range(n):
                e.init_slot(e.alloc(), (ticks[0][0][k], ticks[0][1][k]),
                            bbs[k, 0])
        if not _same(eng_e.state, eng_c.state):
            raise AssertionError("mesh engine: the compiled slot write "
                                 "differs from the eager one")
        want = [eng_e.step_async(ticks[t], active).packed
                for t in range(1, ticks_n + 1)]
        zero_counts()
        got = [eng_c.step_async(ticks[1], active).packed]
        with no_sync():
            got += [eng_c.step_async(ticks[t], active).packed
                    for t in range(2, ticks_n + 1)]
        counts = read_counts()
        caps = jit_check("mesh engine", want + [eng_e.state],
                         got + [eng_c.state], counts, k3,
                         {eng_c._tick: eng_c._tick.traces,
                          eng_c._write: eng_c._write.traces})
        res["engine"] = {"launches": counts, "captures": caps,
                         "rows": [eng_c.rows.start, eng_c.rows.stop]}
        if timed:
            res["engine"].update(
                eager=traced_ms(lambda: eng_e.step_async(ticks[1], active),
                                MESH_JIT_TIMED, 1),
                compiled=traced_ms(lambda: eng_c.step_async(ticks[1], active),
                                   MESH_JIT_TIMED, 1, kernel=nccl))
        del eng_e, eng_c

    if "train" in parts:
        tcfg = dataclasses.replace(cfg, dtype="float32")
        thost = weights.load_npz(weights.checkpoint_path("vittrack-t"), tcfg,
                                 device=cpu)
        opt = train.make_optimizer(TRAIN_LR)
        z, x, gt = (torch.as_tensor(a, device=dev) for a in
                    sharding.shard_batch(train_batch(tcfg, TRAIN_BATCH, 31),
                                         mesh))

        def fresh():
            return train.create_train_state(sharding.shard_params(
                weights.tree_to(thost, dev, copy=True), mesh), opt=opt)

        def run(step, check):
            s, ls = fresh(), []
            for i in range(MESH_JIT_STEPS):
                with (no_sync() if check and i else contextlib.nullcontext()):
                    s, loss, _ = step(s, z, x, gt, tcfg, opt=opt, device=dev)
                ls.append(loss)
            return torch.stack(ls), [t.clone() for t in
                                     train.tree_leaves(s.params)]

        torch.backends.cudnn.deterministic = True
        try:
            with use_mesh(mesh):
                want = run(train.train_step_eager, False)
                n0 = train.train_step.traces
                zero_counts()
                got = run(train.train_step, True)
                counts = read_counts()
        finally:
            torch.backends.cudnn.deterministic = False
        caps = jit_check("mesh train_step", want, got, counts,
                         {"attention_flash": cfg.depth * MESH_JIT_STEPS},
                         {train.train_step: train.train_step.traces - n0})
        res["train"] = {"launches": counts, "captures": caps,
                        "batch_rows": int(z.shape[0]),
                        "losses": [float(v) for v in got[0]]}
        if timed:
            box = {"eager": fresh(), "compiled": fresh()}

            def timed_step(name, step):
                def go():
                    box[name] = step(box[name], z, x, gt, tcfg, opt=opt,
                                     device=dev)[0]
                return go

            with use_mesh(mesh):
                res["train"].update(
                    eager=traced_ms(
                        timed_step("eager", train.train_step_eager),
                        MESH_JIT_TIMED // 2, 1),
                    compiled=traced_ms(
                        timed_step("compiled", train.train_step),
                        MESH_JIT_TIMED // 2, 1, kernel=nccl))
            del box
    return res


def mesh_jit_rank(rank: int, n: int, runs, device: str) -> dict:
    """One rank of phase 15's runs on several cards: ``runs`` is a list of
    (parts, mesh shape)."""
    from gstreamer_vit_tracker_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, torch.cuda.current_device())
    out = {}
    for parts, shape in runs:
        mesh = make_mesh(tuple(shape), device=dev)
        got = mesh_jit_run(dev, mesh, parts)
        for part, v in got.items():
            out[f"{part} {shape[0]}x{shape[1]}"] = v
    return out


def _probe_body(x, device):
    """The one-rank NCCL probe: one all-reduce on the default group between
    elementwise ops."""
    import torch.distributed as dist

    y = x * 2.0 + 1.0
    dist.all_reduce(y)
    return y.square()


def nccl_probe(dev, card: str) -> dict:
    """A body holding one ``dist.all_reduce`` on the one-rank NCCL group,
    compiled: captured once, replayed PROBE_REPLAYS times under sync debug
    mode "error", each equal to the eager body on its own input; the
    device activities of one replay (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from gstreamer_vit_tracker_tpu_torch.utils import graph

    probe = graph.Compiled(_probe_body, "probe.all_reduce")
    gen = torch.Generator(device=dev).manual_seed(15)
    xs = [torch.randn(1 << 16, device=dev, generator=gen)
          for _ in range(PROBE_REPLAYS + 1)]
    want = [_probe_body(x, dev) for x in xs]
    got = [probe(xs[0], dev)]
    with no_sync():
        got += [probe(x, dev) for x in xs[1:]]
    if not _same(want, got) or probe.traces != 1:
        raise AssertionError(f"NCCL probe: compiled differs from eager "
                             f"({_max_diff(want, got):.3e}) or "
                             f"{probe.traces} captures")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        probe(xs[1], dev)
        torch.cuda.synchronize()
    names = sorted({ev.name for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA})
    print(f"NCCL probe: a body with one dist.all_reduce on the one-rank "
          f"NCCL group captured once, replayed {PROBE_REPLAYS} times under "
          f"sync debug mode error, equal to the eager body bit for bit; one "
          f"replay's device activities {names} | {card}", flush=True)
    return {"replays": PROBE_REPLAYS, "captures": probe.traces,
            "replay_activities": names}


def gloo_raises(dev, card: str) -> dict:
    """A mesh of gloo groups with CUDA tensors: a compiled call raises,
    naming the entry point and the backend, before any launch (no device
    activity under torch.profiler, the kernel counters unmoved)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.profiler import ProfilerActivity, profile

    from gstreamer_vit_tracker_tpu_torch.parallel.mesh import use_mesh
    from gstreamer_vit_tracker_tpu_torch.utils import graph

    group = dist.new_group([0], backend="gloo")
    mesh = DeviceMesh.from_group([group, group], "cuda", mesh=[[0]],
                                 mesh_dim_names=("data", "model"))
    probe = graph.Compiled(_probe_body, "probe.all_reduce")
    x = torch.ones(8, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        try:
            with use_mesh(mesh):
                probe(x, dev)
            message = None
        except RuntimeError as err:
            message = str(err)
        torch.cuda.synchronize()
    counts = read_counts()
    activities = [ev.name for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
    print(f"gloo mesh on the card: {message!r}; device activities "
          f"{activities}, launches {counts} | {card}", flush=True)
    if (message is None or "gloo" not in message
            or "probe.all_reduce" not in message or activities
            or any(counts.values()) or probe.traces):
        raise AssertionError("a gloo mesh with CUDA tensors did not raise "
                             "before any launch")
    return {"message": message}


def capture_mode_rank(rank: int, n: int, device: str) -> dict:
    """Phase 15's capture-mode probe on one NCCL rank: a backward (on
    autograd's device thread) and an all-reduce followed by PROBE_CHAIN
    ops, each run eagerly on the capture stream, then captured right after
    an eager all-reduce (whose work the NCCL watchdog then polls) under
    ``thread_local`` and under ``global``, replayed and compared."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(1 << 16, device=dev, generator=gen)
    w = torch.randn(256, 256, device=dev, generator=gen, requires_grad=True)
    inp = torch.randn(64, 256, device=dev, generator=gen)

    def backward():
        with torch.enable_grad():
            loss = (inp @ w).tanh().square().sum()
            return torch.autograd.grad(loss, w)[0]

    def reduce():
        y = x * 2.0
        dist.all_reduce(y)
        for _ in range(PROBE_CHAIN):
            y = y * 0.999 + 0.001
        return y

    out = {}
    for mode in ("thread_local", "global"):
        for name, body in (("backward", backward), ("all_reduce", reduce)):
            key = f"{mode} {name}"
            try:
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    want = body()
                dist.all_reduce(torch.ones(1, device=dev))
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, stream=side,
                                      capture_error_mode=mode):
                    got = body()
                g.replay()
                torch.cuda.synchronize()
                out[key] = ("captured, equal" if torch.equal(got, want)
                            else "captured, differs")
            except Exception as err:              # what the mode does
                out[key] = (f"{type(err).__name__}: "
                            f"{str(err).strip().splitlines()[0][:200]}")
    return out


def hud_jit_check(dev, card: str) -> dict:
    """The app's compiled HUD draws (``render_hud_jit``, ``yuy2_to_rgb_jit``
    then ``render_hud_jit``, ``render_hud_luma_jit``, ``resize_static_jit``)
    against the eager functions on 1080p frames, phase 8's three HudParams:
    byte-equal; the returned frame passed back is drawn in place."""
    from gstreamer_vit_tracker_tpu_torch.ops import (colorspace, overlay,
                                                     overlay_nv12, resample)

    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (FRAME_H, FRAME_W, 3), np.uint8)
    yuy2 = rng.integers(0, 256, (FRAME_H, FRAME_W * 2), np.uint8)
    luma = rng.integers(0, 256, (FRAME_H, FRAME_W), np.uint8)
    kw = dict(fps=58.7, track_ms=4.25, cursor=(960, 540), sel_start=(700, 400))
    params = [
        overlay.HudParams(state_name="SELECT END", score=0.0,
                          is_tracking=False, is_selecting=True,
                          sel_active=True, bbox=(0, 0, 0, 0), has_bbox=False,
                          **kw),
        overlay.HudParams(state_name="TRACKING", score=0.912,
                          is_tracking=True, is_selecting=False,
                          sel_active=False, bbox=(1850, 1020, 120, 90),
                          has_bbox=True, **kw),
        overlay.HudParams(state_name="LOST", score=0.0, is_tracking=False,
                          is_selecting=False, sel_active=False,
                          bbox=(-30, 500, 200, 150), has_bbox=False, **kw)]
    checks = {
        "render_hud": (
            lambda p: overlay.render_hud(torch.tensor(rgb, device=dev), p),
            lambda p: overlay.render_hud_jit(rgb, p, dev)),
        "yuy2_to_rgb+render_hud": (
            lambda p: overlay.render_hud(colorspace.yuy2_to_rgb(
                torch.tensor(yuy2, device=dev).reshape(-1), width=FRAME_W,
                height=FRAME_H), p),
            lambda p: overlay.render_hud_jit(colorspace.yuy2_to_rgb_jit(
                yuy2.reshape(-1), FRAME_W, FRAME_H, dev), p, dev)),
        "render_hud_luma": (
            lambda p: overlay_nv12.render_hud_luma(
                torch.tensor(luma, device=dev), p),
            lambda p: overlay_nv12.render_hud_luma_jit(luma, p, dev))}
    for name, (eager, jit) in checks.items():
        for p in params:
            if not torch.equal(eager(p), jit(p)):
                raise AssertionError(f"{name}: compiled differs from eager")
    # A frame on the card (a host frame is another key), drawn, then passed
    # back: the donated chain paints in place.
    out = overlay.render_hud_jit(torch.tensor(rgb, device=dev), params[0],
                                 dev)
    again = overlay.render_hud_jit(out, params[1], dev)
    want = overlay.render_hud(overlay.render_hud(
        torch.tensor(rgb, device=dev), params[0]), params[1])
    if again is not out or not torch.equal(again, want):
        raise AssertionError(f"the donated HUD chain differs from eager in "
                             f"{int((again != want).sum())} values")
    img = torch.tensor(rgb, device=dev)
    a = resample.resize_static(img, 1024, 1280)
    b = resample.resize_static_jit(img, 1024, 1280, dev)
    if not torch.equal(a, b):
        raise AssertionError(f"resize_static_jit differs from eager in "
                             f"{int((a != b).sum())} values")
    print(f"HUD compiled: render_hud_jit, yuy2_to_rgb_jit + render_hud_jit "
          f"and render_hud_luma_jit on {FRAME_W}x{FRAME_H} frames, three "
          f"HudParams each, and resize_static_jit: byte-equal to the eager "
          f"draws; a returned frame passed back is painted in place | "
          f"{card}", flush=True)
    return {"captures": {"render_hud": overlay._render_hud.traces,
                         "render_hud_luma":
                         overlay_nv12._render_hud_luma.traces}}


def print_mesh_jit(where: str, got: dict, card: str) -> None:
    for name, v in got.items():
        print(f"mesh {name} ({where}): compiled equal to the eager mesh body "
              f"bit for bit, no host sync in the replays, captures "
              f"{v['captures']}, launches {v['launches']}", flush=True)
        if "eager" in v:
            print_timing(f"mesh {name} ({where})", v, card)
        if "kernel_us" in v.get("compiled", {}):
            c = v["compiled"]
            print(f"mesh {name} ({where}): NCCL kernels in the replay "
                  f"{c['kernel_count']:.1f} a step, {c['kernel_us']:.2f} us "
                  f"each on average (waiting for the peers included) | "
                  f"{card}", flush=True)


def mesh_jit_phase(dev, card: str) -> dict:
    """Phase 15: on a 1x1 NCCL mesh in this process, ``mesh_jit_run``,
    the one-rank NCCL all-reduce probe, a gloo mesh raising and the HUD
    draws; the capture-mode probe on one NCCL rank; with two or more
    cards, ``mesh_jit_run`` on meshes of NCCL ranks with a card each and
    the dry run compiled over them."""
    import torch.distributed as dist

    from gstreamer_vit_tracker_tpu_torch.parallel import make_mesh
    from gstreamer_vit_tracker_tpu_torch.parallel.launch import run_ranks
    from gstreamer_vit_tracker_tpu_torch.parallel.mesh import init_group
    from gstreamer_vit_tracker_tpu_torch.utils import graph

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    res = {"cards": cards}
    backend = init_group(dev)
    try:
        mesh = make_mesh((1, 1), device=dev)
        backends = graph.mesh_backends(mesh)
        if backend != "nccl" or set(backends) != {"nccl"}:
            raise AssertionError(f"the 1x1 mesh's groups are {backends}")
        t0 = time.perf_counter()
        res["one_card"] = mesh_jit_run(dev, mesh)
        res["one_card_seconds"] = time.perf_counter() - t0
        print_mesh_jit("1x1, NCCL, one card", res["one_card"], card)
        res["probe"] = nccl_probe(dev, card)
        res["gloo"] = gloo_raises(dev, card)
        res["hud"] = hud_jit_check(dev, card)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    try:
        modes = run_ranks(capture_mode_rank, 1, "cuda", device=dev,
                          timeout=180)[0]
    except RuntimeError as err:          # the rank's process ended
        modes = {"process": str(err).strip().splitlines()[0][:200]}
    res["capture_modes"] = modes
    print(f"capture modes ({time.perf_counter() - t0:.1f} s, one NCCL rank, "
          f"an eager all-reduce just before each capture): {modes} | {card}",
          flush=True)
    if modes.get("thread_local backward") != "captured, equal" or modes.get(
            "thread_local all_reduce") != "captured, equal":
        raise AssertionError(f"thread_local capture failed: {modes}")
    res["part"] = "one card"
    if cards >= 2:
        res["cards_part"] = mesh_jit_cards(dev, card)
        res["part"] = "one card and several cards"
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15 ({res['part']}): {res['seconds']:.1f} s | {card}",
          flush=True)
    return res


def mesh_jit_cards(dev, card: str) -> dict:
    """Phase 15 with two or more cards: ``mesh_jit_run`` on NCCL ranks, a
    card each (four cards: the tracker at 4x1, the engine and the train
    step at 2x2; two: all three at 2x1 and 1x2), then
    ``entry.dryrun_multichip`` over them, compiled, within JAX's bounds."""
    from gstreamer_vit_tracker_tpu_torch.entry import dryrun_multichip
    from gstreamer_vit_tracker_tpu_torch.parallel.launch import run_ranks

    n = 4 if torch.cuda.device_count() >= 4 else 2
    runs = ([(("tracker",), (4, 1)), (("engine", "train"), (2, 2))]
            if n == 4 else [(MESH_JIT_PARTS, (2, 1)),
                            (MESH_JIT_PARTS, (1, 2))])
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_jit_rank, n, runs, "cuda", device=dev,
                      timeout=900)
    res = {"ranks": ranks, "seconds": time.perf_counter() - t0}
    print_mesh_jit(f"{n} NCCL ranks, a card each, rank 0", ranks[0], card)
    t0 = time.perf_counter()
    dry = dryrun_multichip(n, device=dev, timeout=900)
    if dry["route"] != "compiled" or dry["backend"] != "nccl":
        raise AssertionError(f"dry run route {dry['route']} on "
                             f"{dry['backend']}")
    res["dryrun"] = {k: dry[k] for k in ("mesh", "route", "loss",
                                         "loss_single", "d_loss", "d_serve",
                                         "launches")}
    res["dryrun"]["d_tp"] = dry.get("d_tp")
    seconds = res["dryrun"]["seconds"] = time.perf_counter() - t0
    print(f"dry run compiled on {n} NCCL ranks ({seconds:.1f} s): within "
          f"JAX's bounds, launches a rank {dry['launches']} | {card}",
          flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2

    from gstreamer_vit_tracker_tpu_torch.config import PRESETS
    from gstreamer_vit_tracker_tpu_torch.models import vit, vittrack, weights
    from gstreamer_vit_tracker_tpu_torch.ops import (attention, cuda_build,
                                                     vit_block)
    from gstreamer_vit_tracker_tpu_torch.ops import preprocess as pp
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

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
        print_ptxas(name, cuda_build.library_path(name) + ".log")

    # -- 3. kernels against their plain versions ---------------------------
    cfg = PRESETS["vittrack-t"]
    fn, params, (state, frame), x = entry_tokens(dev)
    blocks = [vit.cast_params(bp, torch.bfloat16)
              for bp in params["backbone"]["blocks"]]
    assert x.shape == (1, 320, 192) and x.dtype == torch.bfloat16

    small = PRESETS["small"]
    sparams = weights.load_npz(weights.checkpoint_path("small"), small,
                               device=dev)
    # The main path's clip, and the final-LN yardstick's crops from it: the
    # search crops of frames 1-16 around their drawn boxes, with the
    # template of the clip's first frame.
    frames, boxes = nv12_clip(MAIN_STEPS + 1)
    clip = [core._frame_on(f, "nv12", dev) for f in frames]
    z0 = core.init(params, clip[0], boxes[0], cfg, device=dev,
                   frame_format="nv12").z_tok
    crops = []
    for i in range(1, LN_CROPS + 1):
        win = pp.crop_window(torch.tensor(boxes[i], device=dev),
                             cfg.search_factor)
        tok = vit.embed_search(params["backbone"], core._prep_nv12(
            clip[i], win, cfg.search_size, cfg)[None], cfg)
        crops.append(torch.cat([z0[None], tok], dim=1).contiguous())
    cases = f32_cases(dev, cfg, params, x, small, sparams)
    enc = encoder_phase(dev, cfg, params, x, blocks, crops, small, sparams,
                        cases)

    att_single, att_flash = attention_phase(dev, cfg, small)
    prep = prep_phase(dev, cfg, params)
    padded = padded_heads_phase(dev)
    blk = block_phase(dev, cfg, params, small, sparams, state.z_tok, cases)

    # -- 4. unbatched path -------------------------------------------------
    for _ in range(3):                                 # warm-up, uncounted
        fn(params, core.init(params, clip[0], boxes[0], cfg, device=dev,
                             frame_format="nv12"),
           clip[1])
    state = core.init(params, clip[0], boxes[0], cfg, device=dev,
                      frame_format="nv12")
    torch.cuda.synchronize()
    vit_block.LAUNCHES = 0
    zero_variants()
    attention.SINGLE_LAUNCHES = attention.FLASH_LAUNCHES = 0
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(MAIN_STEPS)]
    packed = []
    t0 = time.perf_counter()
    for i in range(MAIN_STEPS):
        events[i][0].record()
        state, out = core.update_packed(params, state, clip[i + 1], cfg,
                                        device=dev, frame_format="nv12")
        events[i][1].record()
        packed.append(out)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / MAIN_STEPS
    launches = vit_block.LAUNCHES
    by_variant = dict(vit_block.VARIANT_LAUNCHES)
    step_ms = [a.elapsed_time(b) for a, b in events]
    packed = torch.stack(packed).cpu().numpy()
    if launches != MAIN_STEPS or attention.SINGLE_LAUNCHES \
            or attention.FLASH_LAUNCHES \
            or by_variant != only("mma", MAIN_STEPS):
        raise AssertionError(f"encoder kernel launched {launches} times in "
                             f"{MAIN_STEPS} unbatched steps ({by_variant}; "
                             f"attention kernels {attention.SINGLE_LAUNCHES}, "
                             f"{attention.FLASH_LAUNCHES})")
    if packed.shape != (MAIN_STEPS, 5) or not np.isfinite(packed).all():
        raise AssertionError("main path produced non-finite or misshapen output")
    iou = [_iou(p[:4], boxes[i + 1]) for i, p in enumerate(packed)]
    print(f"main path: {MAIN_STEPS} flagship NV12 1080p update_packed steps, "
          f"encoder launches {launches} ({by_variant}); step ms median "
          f"{statistics.median(step_ms):.4f} (CUDA events; min "
          f"{min(step_ms):.4f}, max {max(step_ms):.4f}), host wall "
          f"{wall_ms:.4f} ms/step; score first/last {packed[0, 4]:.4f}/"
          f"{packed[-1, 4]:.4f}, mean IoU vs drawn box {np.mean(iou):.3f}",
          flush=True)

    # The first steps against the same steps run by the port on the CPU:
    # run free (the card's own trajectory above), and beside that each step
    # again on the card from the CPU's state before it, which a near-tie
    # crossed earlier in the trajectory cannot move.  Both held to 2 px /
    # 0.02.
    cpu = torch.device("cpu")
    cparams = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("vittrack-t"), cfg, device=cpu))
    cstate = core.init(cparams, frames[0], boxes[0], cfg, device=cpu,
                       frame_format="nv12")
    for i in range(CPU_CHECK_STEPS):
        held = type(cstate)(*(t.to(dev) for t in cstate))
        _, hout = core.update_packed(params, held, clip[i + 1], cfg,
                                     device=dev, frame_format="nv12")
        hout = hout.cpu().numpy()
        cstate, cout = core.update_packed(cparams, cstate, frames[i + 1], cfg,
                                          device=cpu, frame_format="nv12")
        d_box = np.abs(cout[:4].numpy() - packed[i, :4]).max()
        d_score = abs(float(cout[4]) - packed[i, 4])
        h_box = np.abs(cout[:4].numpy() - hout[:4]).max()
        h_score = abs(float(cout[4]) - float(hout[4]))
        print(f"flagship step {i + 1} card vs CPU: free-running max|d bbox| "
              f"{d_box:.4f} px, |d score| {d_score:.5f}; from the CPU's state "
              f"max|d bbox| {h_box:.4f} px, |d score| {h_score:.5f} "
              f"(tolerance {CPU_BOX_TOL} px, {CPU_SCORE_TOL})")
        if d_box > CPU_BOX_TOL or d_score > CPU_SCORE_TOL:
            raise AssertionError("flagship card step disagrees with the CPU")
        if h_box > CPU_BOX_TOL or h_score > CPU_SCORE_TOL:
            raise AssertionError("flagship card step from the CPU's state "
                                 "disagrees with the CPU")

    # The f32 small preset, every step, against the CPU.
    sparams = vittrack.with_grouped_head(sparams)
    cs_params = vittrack.with_grouped_head(weights.load_npz(
        weights.checkpoint_path("small"), small, device=cpu))
    gs = core.init(sparams, clip[0], boxes[0], small, device=dev,
                   frame_format="nv12")
    cs = core.init(cs_params, frames[0], boxes[0], small, device=cpu,
                   frame_format="nv12")
    worst_box = worst_score = 0.0
    for i in range(MAIN_STEPS):
        gs, gout = core.update_packed(sparams, gs, clip[i + 1], small,
                                      device=dev, frame_format="nv12")
        cs, cout = core.update_packed(cs_params, cs, frames[i + 1], small,
                                      device=cpu, frame_format="nv12")
        gout = gout.cpu().numpy()
        worst_box = max(worst_box, np.abs(gout[:4] - cout[:4].numpy()).max())
        worst_score = max(worst_score, abs(gout[4] - float(cout[4])))
    print(f"small f32, {MAIN_STEPS} steps card vs CPU: max|d bbox| "
          f"{worst_box:.2e} px, max|d score| {worst_score:.2e}")
    if worst_box > SMALL_BOX_TOL or worst_score > SMALL_SCORE_TOL:
        raise AssertionError("small f32 card trajectory disagrees with the CPU")
    small_step = small_jit(dev, card)
    small_bf16 = small_bf16_phase(dev, card)

    # The fused route, and the clip as RGB and as YUY2.
    fused = fused_route_phase(dev, cfg, params, cparams, frames, boxes, clip)
    del clip, frames
    prep_paths = prep_paths_phase(dev, card)
    wide = wide_phase(dev, card)
    wk, wp = wide["kernels"], wide["paths"]
    heads = heads_patch_phase(dev, card)
    ha, he, hp = heads["attention"], heads["encoders"], heads["paths"]

    # -- 5, 6. the serving paths --------------------------------------------
    serve = serve_phase(dev, "vittrack-t")
    flash_launches = long_phase(dev, cfg)
    long_step = long_unbatched_phase(dev, cfg)

    # -- 7. training ---------------------------------------------------------
    training = train_phase(dev, "vittrack-t")

    # -- 8. the tracker app -------------------------------------------------
    app = app_phase(dev, card)

    # -- 9. train and score -------------------------------------------------
    scored = train_score_phase(dev, card, statistics.median(step_ms))

    # -- 10. BASELINE config 5, the runtime, the scripts, checkpoints ------
    config5 = config5_phase(dev, card, params, cfg, cparams)

    # -- 11. parallel/ over ranks of this card, the A/B and probe scripts --
    parallel = parallel_phase(dev, card)

    # -- 12. the port's bench ------------------------------------------------
    benched = bench_phase(card, cfg.depth)

    # -- 13. the compiled entry points against the eager functions -----------
    compiled = jit_phase(dev, card, params, cfg)

    # -- 14. compiled training against the eager functions ------------------
    trained = train_jit_phase(dev, card)

    # -- 15. the programs under a mesh compiled (NCCL inside the replay) ----
    meshed = mesh_jit_phase(dev, card)

    # -- 16. result lines --------------------------------------------------
    pkg = "gstreamer_vit_tracker_tpu_torch/csrc/"
    kernels = [{
        "name": "vit_encoder",
        "route": "cuda",
        "source": pkg + "vit_encoder.cu",
        "replaces": "gstreamer_vit_tracker_tpu/ops/vit_block.py:110",
        "tpu_kernel": "ops/vit_block.py::_encoder_kernel",
        "shape": [1, 320, 192],
        "launches": launches,
        "launches_per_step": launches / MAIN_STEPS,
        "launches_by_variant": by_variant,
        "app_launches": app["flagship"]["launches"]["vit_encoder"],
        "app_updates": app["flagship"]["updates"],
        "eval_launches": {k: v["launches"]["vit_encoder"]
                          for k, v in scored["eval"].items()},
        "eval_updates": {k: v["updates"] for k, v in scored["eval"].items()},
        "uhd_launches": config5["uhd"]["launches"]["vit_encoder"],
        "uhd_reps": UHD_REPS,
        "profile_scan_launches": config5["scripts"]["profile_scan"][
            "launches"]["vit_encoder"],
        "ab_script_launches": {k: parallel["scripts"][k]["launches"][
            "vit_encoder"] for k in ("ab_fused_prep", "ab_grouped_head")},
        "bench_launches": {k: v["vit_encoder"] for k, v in benched[
            "line"]["launches"].items() if v["vit_encoder"]},
        "compiled_launches": {k: compiled[k]["launches"]["vit_encoder"]
                              for k in ("step", "scan_pool", "hud_pool")},
        **{k: enc[k] for k in TIMED_KEYS},
        "max_abs_err_f32_small": enc["max_abs_err_f32_small"],
        "variants": list(vit_block.VARIANT_LAUNCHES),
        "f32": {k: {kk: v[kk] for kk in TIMED_F32_KEYS}
                for k, v in enc["f32"].items()},
        "small_jit": {k: small_step[k] for k in (
            "variant", "launches_by_variant", "steps", "max_d_bbox_px",
            "max_d_score", "device_ms", "host_ms", "idle_share")},
        "small_app": {k: app["small"][k] for k in (
            "launches_by_variant", "updates")},
        "small_eval": {k: scored["small_eval"][k] for k in (
            "launches_by_variant", "updates")},
        "final_ln": enc["final_ln"],
        "small_bf16": {**{k: small_bf16["kernel1"][k] for k in TIMED_KEYS},
                       "final_ln": small_bf16["kernel1"]["final_ln"],
                       "step": {k: small_bf16["step"][k] for k in (
                           "variant", "launches_by_variant", "steps",
                           "max_d_bbox_px", "max_d_score", "device_ms",
                           "host_ms", "idle_share")},
                       "fused_prep_launches": small_bf16["fused_prep"][
                           "launches"]["vit_encoder"]},
        "long_unbatched": long_step,
        "step_ms_median": statistics.median(step_ms),
        "wide": {
            "vit_l_bf16": {**{k: wk["kernel1_bfloat16"][k]
                              for k in TIMED_KEYS + ("plan", "final_ln")},
                           "step": wp["step_bfloat16"]},
            "vit_l_f32": {**{k: wk["kernel1_float32"][k]
                             for k in TIMED_F32_KEYS + ("plan",)},
                          "step": wp["step_float32"]},
            "vit_h": {t: wk[f"kernel1_vit_h_{t}"]
                      for t in ("bfloat16", "float32")},
            "vit_h_prep_launches": {
                t: wp[f"vit_h_{t}"]["eager"]["kernel1_variants"]
                for t in ("bfloat16", "float32")},
            "forced_streamed_bit_equal": wk["forced_streamed"],
            "flagship_sha256": wk["flagship_sha256"],
            "wide_sha256": {**wk["wide_sha256"], **heads["wide_sha256"]}},
        "heads_above_128": {
            **{f"model_a_{t}": {**{k: he[f"kernel1_{t}"][k]
                                   for k in TIMED_KEYS + ("plan",)},
                                "step": hp[f"step_{t}"]}
               for t in ("bfloat16", "float32")},
            "final_ln": he["kernel1_bfloat16"]["final_ln"],
            "dh192_max_abs_err": {t: he[f"dh192_{t}"]["encoder"]
                                  for t in ("bfloat16", "float32")},
            "model_b_launches": {t: hp[f"model_b_{t}"]["compiled"][
                "kernel1_variants"] for t in ("bfloat16", "float32")}},
    }, {
        "name": "attention_single",
        "route": "cuda",
        "source": pkg + "attention.cu",
        "replaces": "gstreamer_vit_tracker_tpu/ops/attention.py:83",
        "tpu_kernel": "ops/attention.py::_single_block_kernel",
        "shape": [48, 320, 64],
        "launches": serve["launches"],
        "launches_per_tick": serve["launches"] / serve["ticks"],
        "app_launches": app["modes"]["small_objects_launches"][
            "attention_single"],
        "eval_objects_launches": scored["objects"]["launches"][
            "attention_single"],
        "eval_objects_updates": scored["objects"]["updates"],
        "profile_scan_launches": config5["scripts"]["profile_scan"][
            "launches"]["attention_single"],
        "profile_streams_launches": config5["scripts"]["profile_streams"][
            "launches"]["attention_single"],
        "mesh_serve_launches_a_rank": {
            k: v["kernel3_launches"] for k, v in parallel["serve"].items()},
        "bench_launches": {k: v["attention_single"] for k, v in benched[
            "line"]["launches"].items() if v["attention_single"]},
        "compiled_launches": {k: compiled[k]["launches"]["attention_single"]
                              for k in ("tick", "objects")},
        "compiled_mesh_launches": {
            k: meshed["one_card"][k]["launches"]["attention_single"]
            for k in ("tracker", "engine")},
        "compiled_mesh_ticks": MESH_JIT_TICKS,
        "variant": att_single["variant"],
        "max_abs_err": att_single["max_abs_err"],
        "ms": att_single["ms"],
        "launch_ms": att_single["launch_ms"],
        "device_us": att_single["device_us"],
        "simt_ms": att_single["simt_ms"],
        "simt_device_us": att_single["simt_device_us"],
        "library_device_us": att_single["library_device_us"],
        "plain_ms": att_single["plain_ms"],
        "library_ms": att_single["library_ms"],
        "bound_ms": att_single["bound_ms"],
        "bound_by": att_single["bound_by"],
        "tick_ms_median": serve["tick_ms_median"],
        "padded_head_dims_max_abs_err": padded,
        "multihead_ms": att_single["multihead"]["ms"],
        "multihead_copied_ms": att_single["multihead"]["copied_ms"],
        "f32": {k: att_single["f32"][k] for k in F32_KEYS},
        "small_bf16": {**small_bf16["kernel3"],
                       "tick_launches": small_bf16["tick"]["launches"][
                           "attention_single"],
                       "ticks": SMALL_BF16_TICKS},
        "wide_tick": wp["tick"],
        "heads_above_128": {k: [c for c in v if c["route"] == "single"]
                            for k, v in ha.items()},
    }, {
        "name": "attention_flash",
        "route": "cuda",
        "source": pkg + "attention.cu",
        "replaces": "gstreamer_vit_tracker_tpu/ops/attention.py:53",
        "tpu_kernel": "ops/attention.py::_flash_kernel",
        "shape": [3, 1088, 64],
        "launches": flash_launches,
        "launches_per_tick": flash_launches / LONG_TICKS,
        "train_launches": scored["train"]["launches"]["attention_flash"],
        "train_steps": TRAIN9_STEPS,
        "mesh_train_launches_a_rank": parallel["train"]["kernel4_launches"],
        "mesh_train_steps": MESH_TRAIN_STEPS,
        "compiled_train_launches": {
            k: trained[k]["launches"]["attention_flash"]
            for k in ("step", "scan")},
        "compiled_train_steps": {"step": JIT_TRAIN_STEPS,
                                 "scan": JIT_SCAN_STEPS},
        "compiled_mesh_train_launches": meshed["one_card"]["train"][
            "launches"]["attention_flash"],
        "compiled_mesh_train_steps": MESH_JIT_STEPS,
        "train_shape": {k: trained["kernel4"][k] for k in (
            "route", "variant", "max_abs_err", "ms", "launch_ms",
            "device_us", "replay_device_us", "plain_ms", "library_ms",
            "library_device_us", "bound_ms", "bound_by",
            "launches_per_step", "simt_ms", "simt_device_us")},
        "f32": {k: trained["kernel4"][k] for k in F32_KEYS},
        "variant": att_flash["variant"],
        "max_abs_err": att_flash["max_abs_err"],
        "ms": att_flash["ms"],
        "launch_ms": att_flash["launch_ms"],
        "device_us": att_flash["device_us"],
        "simt_ms": att_flash["simt_ms"],
        "simt_device_us": att_flash["simt_device_us"],
        "library_device_us": att_flash["library_device_us"],
        "plain_ms": att_flash["plain_ms"],
        "library_ms": att_flash["library_ms"],
        "bound_ms": att_flash["bound_ms"],
        "bound_by": att_flash["bound_by"],
        "small_bf16": {**small_bf16["kernel4"],
                       "long_launches": small_bf16["long"]["launches"][
                           "attention_flash"],
                       "long_ticks": SMALL_BF16_LONG_TICKS},
        "heads_above_128": {
            **{k: [c for c in v if c["route"] == "flash"]
               for k, v in ha.items()},
            "model_a_tick": hp["tick"], "model_a_train": hp["train"]},
    }, {
        "name": "vit_block",
        "route": "cuda",
        "source": pkg + "vit_encoder.cu",
        "replaces": "gstreamer_vit_tracker_tpu/ops/vit_block.py:100",
        "tpu_kernel": "ops/vit_block.py::_block_kernel",
        "shape": [SERVE_SLOTS, 320, 192],
        "launches": blk["launches"],
        **{k: blk[SERVE_SLOTS][k] for k in TIMED_KEYS},
        "max_abs_err_f32_small": blk["max_abs_err_f32_small"],
        "batch_1": {k: blk[1][k] for k in TIMED_KEYS},
        "f32": {k: {kk: v[kk] for kk in TIMED_F32_KEYS}
                for k, v in blk["f32"].items()},
        "small_bf16": {**{k: small_bf16["kernel2"][k] for k in TIMED_KEYS},
                       "path_launches": small_bf16["block_path"]["launches"][
                           "vit_block"]},
        "wide": {"bf16": {k: wk["kernel2_bfloat16"][k]
                          for k in TIMED_KEYS + ("plan",)},
                 "f32": {k: wk["kernel2_float32"][k]
                         for k in TIMED_F32_KEYS + ("plan",)},
                 "path": wp["block_path"]},
        "heads_above_128": {
            **{f"model_a_{t}": {k: he[f"kernel2_{t}"][k]
                                for k in TIMED_KEYS + ("plan",)}
               for t in ("bfloat16", "float32")},
            "dh192_max_abs_err": {t: he[f"dh192_{t}"]["block"]
                                  for t in ("bfloat16", "float32")},
            "path": hp["block_path"]},
    }, {
        "name": "fused_prep_embed",
        "route": "cuda",
        "source": pkg + "fused_prep_embed.cu",
        "replaces": "gstreamer_vit_tracker_tpu/ops/fused_prep_embed.py:79",
        "tpu_kernel": "ops/fused_prep_embed.py::_kernel",
        "shape": [256, 192],
        "launches": fused["launches"],
        "launches_per_step": fused["launches"] / MAIN_STEPS,
        "ab_fused_prep_launches": parallel["scripts"]["ab_fused_prep"][
            "launches"]["fused_prep_embed"],
        "max_abs_err": prep["max_abs_err"],
        "max_abs_err_f32": prep["max_abs_err_f32"],
        "variant": prep["variant"],
        "plan": prep["plan"],
        "ms": prep["ms"],
        "ms_again": prep["ms_again"],
        "launch_ms": prep["launch_ms"],
        "device_us": prep["device_us"],
        "device_us_again": prep["device_us_again"],
        "device_us_f32": prep["device_us_f32"],
        "device_activities_a_call": prep["device_activities"],
        "plain_ms": prep["plain_ms"],
        "library_ms": None,
        "unfused_chain_ms": prep["chain_ms"],
        "bound_ms": prep["bound_ms"],
        "bound_by": prep["bound_by"],
        "step_ms_median": fused["step_ms_median"],
        "small_bf16": {**small_bf16["kernel5"],
                       "launches": small_bf16["fused_prep"]["launches"][
                           "fused_prep_embed"],
                       "steps": SMALL_BF16_PREP_STEPS},
        "flagship_bf16_sha256": prep["sha256"],
        "variants": {label: {
            "plan": row["plan"], "device_us": row["device_us"],
            "max_abs_err": row["max_abs_err"], "ms": row["launch_ms"],
            "plain_ms": row["plain_ms"], "library_ms": None,
            "unfused_chain_ms": row["chain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound_fma_ms": row["bound_fma_ms"]}
            for label, row in prep["shapes"].items()},
        "paths": {label: {k: v for k, v in r.items()
                          if k in ("kernel1", "kernel5", "compiled", "eager",
                                   "free")}
                  for label, r in prep_paths.items() if label != "seconds"},
        "wide": {t: {**wk["kernel5"][t],
                     "path": wp[f"vit_h_{t}"]["eager"]["kernel5_variants"]}
                 for t in ("bfloat16", "float32")},
        "patch_above_32": {
            **heads["kernel5"],
            "model_b_paths": {t: {r: hp[f"model_b_{t}"][r]["kernel5_variants"]
                                  for r in ("compiled", "eager")}
                              for t in ("bfloat16", "float32")}},
    }]
    print(f"fused route summary: {json.dumps(fused)}")
    print(f"kernel-5 paths summary: {json.dumps(prep_paths)}")
    print(f"wide widths summary: {json.dumps(wide)}")
    print(f"head dims and patches summary: {json.dumps(heads)}")
    print(f"training summary: {json.dumps(training)}")
    print(f"serving summary: {json.dumps(serve)}")
    print(f"app summary: {json.dumps(app)}")
    print(f"train and score summary: {json.dumps(scored)}")
    print(f"config 5 summary: {json.dumps(config5)}")
    print(f"parallel summary: {json.dumps(parallel)}")
    print(f"bench: {benched['seconds']:.1f} s")
    print(f"compiled summary: {json.dumps(compiled)}")
    print(f"compiled training summary: {json.dumps(trained)}")
    print(f"compiled mesh summary: {json.dumps(meshed)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
