"""Times of the attention kernels by variant, key block, stages and
warpgroups.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_attention [cut]

For a few (batch*heads, S, dh) cases this script launches every
configuration of ``csrc/attention.cu`` that fits the card's shared memory
through ``ops/attention.py::prepared`` (one launch on ready operands): the
``mma`` variant of ``attention_single`` with 64- and 128-key blocks, of
``attention_flash`` with 64- and 128-key blocks, 2 stages and 1 or 2
warpgroups or 3 stages and 1, the ``tf32x3`` variant of both kernels
(float32 cases), and the ``simt`` variant of both kernels.  A bf16 head
dim the ``mma`` tiles do not take (48: the ``small`` architecture in bf16)
runs them zero-padded to the next of 32 / 64 / 128, as the plan has it.
Above a head dim of 128 (Model A's 256 at its 16-slot tick's (64, 320)
and at S 100, and 192; in float32 its training batch's (16, 320) at dh
256, 192 and 136, and (16, 64)) the panel kernels instead, both routes at
every G (``Plan.group``, the panels of o a CTA: each divisor of the panels
up to 4): bf16 with the flash ring of ``attention.panel_stages``, float32
(``tf32x3``) with ``attention.tf32_panel_stages``'s, the single route
where a ring of every load fits the card.  It
checks each against ``attention_reference`` and prints the device time of a
launch in microseconds (20 launches captured into a CUDA graph and replayed,
so the host's enqueue time is not read as the kernel's) beside
``F.scaled_dot_product_attention`` on the same tensors, then the host-side
times (CUDA events over back-to-back calls) of ``flash_attention``, of one
prepared launch and of the library call.  The configuration that
``ops/attention.py::plan`` takes is marked with ``*``.

``cut``: kernel 4 in float32 above a head dim of 128 at the plan, (16, 320,
dh) for dh 256, 192 and 136, from the shipped build and from builds of
``csrc/attention.cu`` whose ``csrc/panel_tf32.cuh`` is rewritten in a copy
under ``build/`` to leave out the ``wgmma`` products, the producers' split
and stores of each panel, or their reads from device memory (the outputs
are wrong; the device us a launch say what each part holds the kernel
to).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import sys

import torch
import torch.nn.functional as F

from .ops import attention, cuda_build

CASES = ((48, 320, 64, torch.bfloat16), (3, 320, 64, torch.bfloat16),
         (3, 1088, 64, torch.bfloat16), (48, 1088, 64, torch.bfloat16),
         (3, 600, 64, torch.bfloat16), (48, 600, 64, torch.bfloat16),
         (4, 777, 128, torch.bfloat16), (48, 320, 32, torch.bfloat16),
         (48, 320, 64, torch.float32), (3, 1088, 64, torch.float32),
         (32, 80, 48, torch.float32), (32, 80, 48, torch.bfloat16),
         (2, 1088, 48, torch.bfloat16), (64, 320, 256, torch.bfloat16),
         (64, 100, 256, torch.bfloat16), (64, 320, 192, torch.bfloat16),
         (16, 320, 256, torch.float32), (16, 320, 192, torch.float32),
         (16, 320, 136, torch.float32), (16, 64, 256, torch.float32))
P = attention.Plan
CONFIGS = ([P("single", "mma", 64), P("single", "mma", 128)]
           + [P("flash", "mma", kb, stages, wg) for kb in (64, 128)
              for stages, wg in ((2, 1), (2, 2), (3, 1))]
           + [P("single", "tf32x3", 64), P("flash", "tf32x3", 64, 2)]
           + [P("single", "simt"), P("flash", "simt")])
GRAPH_LAUNCHES = 20


def _configs(dh: int, optin: int) -> list:
    """CONFIGS, or above a head dim of 128 the panel kernels' (module
    docstring)."""
    if dh <= attention._TILE_MAX_DH:
        return CONFIGS
    panels = -(-dh // 64)
    return [c for g in (4, 3, 2, 1) if panels % g == 0
            for c in (P("single", "mma", 64, group=g),
                      P("flash", "mma", 64,
                        attention.panel_stages(panels, g, optin), group=g),
                      P("single", "tf32x3", 64, group=g),
                      P("flash", "tf32x3", 64,
                        attention.tf32_panel_stages(panels, g, optin),
                        group=g))]


def _ms(fn, iters: int = 200) -> float:
    for _ in range(10):
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
    return _ms(graph.replay, iters=20) / GRAPH_LAUNCHES * 1e3


# What the cut builds take out of csrc/panel_tf32.cuh: (statement, its
# replacement) pairs.
_CUT = {
    "no products": [(
        "    wgmma_tf32(d, lo[i], descriptor(at));\n"
        "    wgmma_tf32(d, hi[i], descriptor(at + kPlaneBytes));\n"
        "    wgmma_tf32(d, hi[i], descriptor(at));", "    (void)at;")],
    "no stores": [(
        "      if (i >= scores) store_v(tid, cur, stage(l));\n"
        "      else if (resident || (i & 1)) store_k(tid, cur, stage(l));\n"
        "      else store_q(tid, cur, reinterpret_cast<float*>(stage(l)));",
        "      (void)cur;")],
    "no reads": [(f"    x[it] = load4(g + (long long)(row0 + r) * rs + 4 * {c}, "
                  f"row0 + r < S && 4 * {c} < cols);",
                  "    x[it] = make_float4(0.f, 0.f, 0.f, 0.f);")
                 for c in ("k", "c")]}


def _cut_builds() -> dict:
    """``attention`` built from copies of the sources under ``build/`` with
    each of _CUT's rewrites of ``panel_tf32.cuh``, every build compiled at
    once: {name: loaded library}.  Raises if a statement is no longer in
    the source once."""
    with open(os.path.join(cuda_build.CSRC, "panel_tf32.cuh")) as f:
        shipped = f.read()
    procs = {}
    for name, edits in _CUT.items():
        src = shipped
        for old, new in edits:
            if shipped.count(old) != 1:
                raise RuntimeError(f"panel_tf32.cuh no longer has {old!r} once")
            src = src.replace(old, new)
        where = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "rewritten",
                             "attention " + name)
        os.makedirs(where, exist_ok=True)
        for fn in os.listdir(cuda_build.CSRC):
            if fn.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(cuda_build.CSRC, fn), where)
        with open(os.path.join(where, "panel_tf32.cuh"), "w") as f:
            f.write(src)
        out = os.path.join(where, "libattention.so")
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
               os.path.join(where, "attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {"shipped": attention._library()}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


@contextlib.contextmanager
def _forward_from(lib: ctypes.CDLL):
    """Kernels 3 and 4 launched from ``lib`` (a build of ``attention``)."""
    shipped = dict(attention._FORWARD)
    for route in shipped:
        fn = getattr(lib, f"attention_{route}_forward")
        fn.argtypes, fn.restype = shipped[route].argtypes, shipped[route].restype
        attention._FORWARD[route] = fn
    try:
        yield
    finally:
        attention._FORWARD.update(shipped)


def cut(dev) -> dict:
    """Device us a launch of kernel 4 in float32 at (16, 320, dh), dh 256,
    192 and 136, at the plan, from each build of :func:`_cut_builds`."""
    gen = torch.Generator().manual_seed(24)
    cases = {dh: [torch.randn((16, 320, dh), generator=gen).to(dev)
                  for _ in range(3)] for dh in (256, 192, 136)}
    out = {}
    for name, lib in _cut_builds().items():
        out[name] = {}
        with _forward_from(lib):
            for dh, qkv in cases.items():
                # The output stays referenced while the graph writes it.
                result, launch = attention.prepared(*qkv)
                out[name][f"(16, 320, {dh})"] = _graph_us(launch)
        print(name, out[name], flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    if "cut" in sys.argv[1:]:
        cut(dev)
        return
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for bh, s, dh, dtype in CASES:
        gen = torch.Generator().manual_seed(s + dh)
        q, k, v = (torch.randn((bh, s, dh), generator=gen).to(dev, dtype)
                   for _ in range(3))
        ref = attention.attention_reference(q, k, v).float()
        taken = attention._plan_for(dev, s, dh, dtype, bh)
        cells = []
        for p in _configs(dh, optin):
            takes = {"mma": dtype == torch.bfloat16,
                     "tf32x3": dtype == torch.float32}.get(p.variant, True)
            runs_at = attention.variant_pad(p.variant, dh) or dh
            if not takes or attention._refusal(p, s, runs_at, optin) \
                    or attention.smem_bytes(
                        p.route, p.variant, s, runs_at, q.element_size(),
                        p.kb, p.stages, p.warpgroups, p.group) > optin:
                continue
            out, launch = attention.prepared(q, k, v, chosen=p)
            launch()
            torch.cuda.synchronize()
            err = (out.float()[..., :dh] - ref).abs().max().item()
            mark = "*" if p == taken._replace(pad=0) else ""
            group = f" G {p.group}" if p.group else ""
            cells.append(f"{mark}{p.route} {p.variant} {p.kb}/{p.stages}/"
                         f"{p.warpgroups}{group}: {_graph_us(launch):.1f} us, "
                         f"max|d| {err:.1e}")

        def library():
            return F.scaled_dot_product_attention(q[None], k[None], v[None])

        _, launch = attention.prepared(q, k, v)
        print(f"({bh}, {s}, {dh}) {str(dtype)[6:]} | "
              f"scaled_dot_product_attention {_graph_us(library):.1f} us | "
              + " | ".join(cells), flush=True)
        print(f"    host side, ms a call on CUDA events: flash_attention "
              f"{_ms(lambda: attention.flash_attention(q, k, v)):.4f}, one "
              f"prepared launch {_ms(launch):.4f}, "
              f"scaled_dot_product_attention {_ms(library):.4f}", flush=True)


if __name__ == "__main__":
    main()
