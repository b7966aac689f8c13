"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the NVIDIA cards the cell
asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, with ``--trace 1``, ``breakdown``; last, ``checks``, each
number the correctness check compared beside its limit, which also close
standard error.  Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits 1.

Build and kernel caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Top-level modules that must not be loaded in the measured process.
FORBIDDEN = ("jax", "jaxlib", "flax", "gstreamer_vit_tracker_tpu")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is a forbidden one (whole
    names: the port's package name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _caches() -> None:
    """Fixed cache directories inside the checkout for any builder that
    reads one (the port builds its kernels into ``build/torch_kernels``)."""
    base = os.path.join(ROOT, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    from benchmark import spec

    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    from benchmark import harness

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START, root=ROOT)
    found = forbidden_loaded()
    if found:
        print(f"error: loaded in the measured process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    out.pop("readings")
    out.pop("sample")
    checks = out.pop("checks")
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
