"""Probe: does an int8 W8A8 product beat bf16 at the flagship's MLP shapes?

Port of ``scripts/probe_int8.py``, with its prints.  This probes a library
call, ``torch._int_mm`` (int8 x int8 -> int32, cuBLASLt on the card), not
a kernel of the port: nothing in the port calls it.

1. correctness: ``torch._int_mm`` of int8 (64, 192) x (192, 128) against
   numpy's int32 product, which it must equal exactly;
2. timing: the 12-layer MLP chain (N,192)@(192,768) -> tanh ->
   (N,768)@(768,192), bf16 against W8A8 with dynamic per-row activation
   scales and per-output-channel weight scales, at N = 320 (one stream)
   and N = 5120 (16 streams), each as a slope between a low and 5x the
   rep count (``utils/profiling.py::marginal_ms``: device time on the card,
   the host clock with ``--cpu``).

The correctness product and each chain's rep loop are compiled programs
(``utils/graph.py::Compiled``, ``tracker/scan.py::scanned``), as JAX's
are jitted.

Usage:
    python -m gstreamer_vit_tracker_tpu_torch.scripts.probe_int8 \
        [--reps 50] [--big-reps 20] [--sizes 320,5120] [--cpu]

It runs on the card; ``--cpu`` runs on the CPU.  Without ``--cpu`` and
without a card it exits 1 with a message.  Prints the JAX script's lines,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..tracker import scan
from ..utils import graph
from ..utils.profiling import marginal_ms

D, HID, DEPTH = 192, 768, 12


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50,
                    help="low rep count at N = 320 (high: 5x)")
    ap.add_argument("--big-reps", type=int, default=20,
                    help="low rep count at N = 5120 (high: 5x)")
    ap.add_argument("--sizes", default="320,5120")
    ap.add_argument("--cpu", action="store_true")
    return ap


def make_weights(gen: torch.Generator, dev):
    ws = []
    for _ in range(DEPTH):
        w1 = torch.randn((D, HID), generator=gen) * 0.05
        w2 = torch.randn((HID, D), generator=gen) * 0.05
        ws.append((w1.to(dev), w2.to(dev)))
    return ws


def quant_w(w: torch.Tensor):
    """Per-output-channel symmetric int8 weights and their scales."""
    s = w.abs().amax(dim=0) / 127.0
    return torch.round(w / s).to(torch.int8), s.float()


def qdq_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor
               ) -> torch.Tensor:
    """Dynamic per-row activation quantisation, int8 x int8 -> int32, then
    both scales."""
    xs = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    xq = torch.round(x / xs).to(torch.int8)
    return torch._int_mm(xq, wq).float() * xs * ws


@graph.compiled("probe_int8.i8mm")
def i8mm(a, b, device) -> torch.Tensor:
    """int8 x int8 -> int32 (``torch._int_mm``), compiled."""
    return torch._int_mm(a, b)


def bench(n: int, reps_lo: int, dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    ws = make_weights(gen, dev)
    ws_bf = [(w1.bfloat16(), w2.bfloat16()) for w1, w2 in ws]
    ws_q = [(quant_w(w1), quant_w(w2)) for w1, w2 in ws]
    x0 = torch.randn((n, D), generator=gen).to(dev)

    def step_bf16(c, i):
        y = c.bfloat16()
        for w1, w2 in ws_bf:
            y = torch.tanh(y @ w1) @ w2
        return y.float() * 0.5 + c * 0.5, None

    def step_i8(c, i):
        y = c
        for (w1q, w1s), (w2q, w2s) in ws_q:
            y = qdq_matmul(torch.tanh(qdq_matmul(y, w1q, w1s)), w2q, w2s)
        return y * 0.5 + c * 0.5, None

    def chain(step, name):
        program = scan.scanned(step, f"probe_int8.run_{name}")

        def run(reps):
            return float(program(x0, reps, dev)[0].sum())
        return run

    out = {}
    for name, fn in (("bf16", chain(step_bf16, "bf16")),
                     ("int8", chain(step_i8, "int8"))):
        ms = marginal_ms(fn, reps_lo, 5 * reps_lo, dev)
        out[name] = ms
        print(f"N={n} {name}: {ms:.4f} ms per 12x(mlp) chain "
              f"({ms / DEPTH * 1000:.2f} us/layer)")
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("backend:", dev.type, f"({name})")

    # ---- 1. correctness ---------------------------------------------------
    rng = np.random.default_rng(0)
    a8 = rng.integers(-127, 128, (64, 192), dtype=np.int8)
    b8 = rng.integers(-127, 128, (192, 128), dtype=np.int8)
    got = i8mm(a8, b8, dev).cpu().numpy()
    want = a8.astype(np.int32) @ b8.astype(np.int32)
    exact = bool((got == want).all())
    print("int8 matmul exact:", exact)

    # ---- 2. timing ----------------------------------------------------------
    sizes = [int(v) for v in args.sizes.split(",") if v]
    timed = {n: bench(n, args.reps if n <= 320 else args.big_reps, dev)
             for n in sizes}
    print("done")
    print(json.dumps({
        "device": name, "int8_exact": exact,
        "ms_per_chain": {str(n): v for n, v in timed.items()},
        "what": "torch._int_mm (a library call), not a kernel of the port",
        "timing": ("device-time slope (torch.profiler)"
                   if dev.type == "cuda" else "host clock"),
    }))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
