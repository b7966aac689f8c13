"""Times of the attention kernels by variant, key block, stages and
warpgroups.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python -m gstreamer_vit_tracker_tpu_torch.profile_attention

For a few (batch*heads, S, dh) cases this script launches every
configuration of ``csrc/attention.cu`` that fits the card's shared memory
through ``ops/attention.py::prepared`` (one launch on ready operands): the
``mma`` variant of ``attention_single`` with 64- and 128-key blocks, of
``attention_flash`` with 64- and 128-key blocks, 2 stages and 1 or 2
warpgroups or 3 stages and 1, the ``tf32x3`` variant of both kernels
(float32 cases), and the ``simt`` variant of both kernels.  A bf16 head
dim the ``mma`` tiles do not take (48: the ``small`` architecture in bf16)
runs them zero-padded to the next of 32 / 64 / 128, as the plan has it.  It
checks each against ``attention_reference`` and prints the device time of a
launch in microseconds (20 launches captured into a CUDA graph and replayed,
so the host's enqueue time is not read as the kernel's) beside
``F.scaled_dot_product_attention`` on the same tensors, then the host-side
times (CUDA events over back-to-back calls) of ``flash_attention``, of one
prepared launch and of the library call.  The configuration that
``ops/attention.py::plan`` takes is marked with ``*``.
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from .ops import attention

CASES = ((48, 320, 64, torch.bfloat16), (3, 320, 64, torch.bfloat16),
         (3, 1088, 64, torch.bfloat16), (48, 1088, 64, torch.bfloat16),
         (3, 600, 64, torch.bfloat16), (48, 600, 64, torch.bfloat16),
         (4, 777, 128, torch.bfloat16), (48, 320, 32, torch.bfloat16),
         (48, 320, 64, torch.float32), (3, 1088, 64, torch.float32),
         (32, 80, 48, torch.float32), (32, 80, 48, torch.bfloat16),
         (2, 1088, 48, torch.bfloat16))
P = attention.Plan
CONFIGS = ([P("single", "mma", 64), P("single", "mma", 128)]
           + [P("flash", "mma", kb, stages, wg) for kb in (64, 128)
              for stages, wg in ((2, 1), (2, 2), (3, 1))]
           + [P("single", "tf32x3", 64), P("flash", "tf32x3", 64, 2)]
           + [P("single", "simt"), P("flash", "simt")])
GRAPH_LAUNCHES = 20


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for bh, s, dh, dtype in CASES:
        gen = torch.Generator().manual_seed(s + dh)
        q, k, v = (torch.randn((bh, s, dh), generator=gen).to(dev, dtype)
                   for _ in range(3))
        ref = attention.attention_reference(q, k, v).float()
        taken = attention._plan_for(dev, s, dh, dtype, bh)
        cells = []
        for p in CONFIGS:
            takes = {"mma": dtype == torch.bfloat16,
                     "tf32x3": dtype == torch.float32}.get(p.variant, True)
            runs_at = attention.variant_pad(p.variant, dh) or dh
            if not takes or attention.smem_bytes(
                    p.route, p.variant, s, runs_at, q.element_size(), p.kb,
                    p.stages, p.warpgroups) > optin:
                continue
            out, launch = attention.prepared(q, k, v, chosen=p)
            launch()
            torch.cuda.synchronize()
            err = (out.float()[..., :dh] - ref).abs().max().item()
            mark = "*" if p == taken._replace(pad=0) else ""
            cells.append(f"{mark}{p.route} {p.variant} {p.kb}/{p.stages}/"
                         f"{p.warpgroups}: {_graph_us(launch):.1f} us, "
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
