"""Run a function on n ranks of one host, each in a process of its own.

What ``torchrun --nproc-per-node n`` does for a script, for a function:
:func:`run_ranks` spawns n processes, each joins one group of n ranks
(``parallel/mesh.py::init_group``, rendezvous through a file in a fresh
temporary directory, so concurrent callers never share a port), runs
``fn(rank, n, *args)`` on one intra-op thread, and sends back what ``fn``
returns.  A rank that raises fails the call with its traceback; a call
that outlives ``timeout`` (a collective that hangs) raises, and the ranks
still running are killed.  ``fn`` and its arguments cross by pickle, so
``fn`` is a module-level function.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List

__all__ = ["run_ranks"]


def _rank_main(fn, rank, n, device, init_method, args, out) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import init_group

    try:
        # Every rank is on this host: gloo talks over the loopback device.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        init_group(device, rank=rank, world_size=n, init_method=init_method)
        out.put((rank, True, fn(rank, n, *args)))
    except BaseException:                          # reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], n: int, *args: Any, device="cuda",
              timeout: float = 600.0) -> List[Any]:
    """``[fn(0, n, *args), ..., fn(n - 1, n, *args)]``, each run in its
    own process in one group of ``n`` ranks on ``device``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, str(device), init, args, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        results = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < n:
                left = deadline - time.monotonic()
                try:
                    rank, ok, value = out.get(timeout=max(left, 0.0))
                except queue.Empty:
                    raise TimeoutError(
                        f"{n} ranks of {fn.__name__}: "
                        f"{sorted(set(range(n)) - set(results))} did not "
                        f"finish in {timeout:.0f} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                       f"failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(n)]
