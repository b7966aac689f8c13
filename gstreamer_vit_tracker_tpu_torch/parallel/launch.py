"""Run a function on n ranks of one host, each in a process of its own.

What ``torchrun --nproc-per-node n`` does for a script, for a function:
:func:`run_ranks` spawns n processes, each joins one group of n ranks
(``parallel/mesh.py::init_group``, rendezvous through a file in a fresh
temporary directory, so concurrent callers never share a port), runs
``fn(rank, n, *args)`` on one intra-op thread, and sends back what ``fn``
returns.  A rank that raises fails the call with its traceback, a rank
whose process ends without a result fails it within a second; a call that
outlives ``timeout`` (a collective that hangs) raises, and the ranks still
running are killed.  ``fn`` and its arguments cross by pickle, so
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

# Seconds a rank's failure waits for another rank to be seen dead (the
# likelier cause) before the call raises it.
FAILURE_GRACE = 2.0


def _rank_main(fn, rank, n, device, init_method, args, out) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import init_group

    try:
        # Every rank is on this host: gloo talks over the loopback device.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        init_group(device, rank=rank, world_size=n, init_method=init_method)
        message = (rank, True, fn(rank, n, *args))
    except BaseException:                          # reported to the parent
        message = (rank, False, traceback.format_exc())
    # In the pipe before the group is torn down: a teardown that kills the
    # process (a peer gone) cannot lose what the rank sent.
    out.put(message)
    out.close()
    out.join_thread()
    if dist.is_initialized():
        dist.destroy_process_group()


def _collect(procs, results, failed, out, fn, grace: float) -> None:
    """Read what the ranks sent, then raise if a rank's process ended
    without sending anything (it died before ``fn`` could return or raise,
    e.g. in its start-up), else if a rank failed.  A message still in flight
    is waited for, and each live rank gets up to ``grace`` seconds to be seen
    ending: a rank that fails because a peer died (a connection closed in
    its set-up) reports at about the moment the peer's process ends, and the
    death, the cause, is what the call raises, with the failures after
    it."""
    deadline = time.monotonic() + grace
    while True:
        try:
            rank, ok, value = out.get(timeout=0.1)
        except queue.Empty:
            if time.monotonic() >= deadline or all(
                    p.exitcode is not None for p in procs):
                break
            continue
        (results if ok else failed)[rank] = value
    dead = {r: p.exitcode for r, p in enumerate(procs)
            if p.exitcode is not None and r not in results and r not in failed}
    notes = "".join(f"\nrank {r} of {fn.__name__} failed:\n{tb}"
                    for r, tb in sorted(failed.items()))
    if dead:
        raise RuntimeError(f"ranks of {fn.__name__} ended without a result "
                           f"(rank: exit code) {dead}{notes}")
    if failed:
        raise RuntimeError(notes.lstrip("\n"))


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
        results, failed = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{n} ranks of {fn.__name__}: "
                        f"{sorted(set(range(n)) - set(results))} did not "
                        f"finish in {timeout:.0f} s")
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    if any(p.exitcode is not None and r not in results
                           for r, p in enumerate(procs)):
                        _collect(procs, results, failed, out, fn, 0.0)
                    continue
                if ok:
                    results[rank] = value
                else:
                    failed[rank] = value
                    _collect(procs, results, failed, out, fn, FAILURE_GRACE)
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(n)]
