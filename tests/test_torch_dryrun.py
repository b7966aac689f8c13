"""PyTorch port: ``entry.dryrun_multichip``, the counterpart of
``__graft_entry__.py::dryrun_multichip``, on four gloo ranks on the CPU
(a 2x2 mesh: tp=2 over the flagship width's 3 heads).

It runs JAX's three parts through the compiled programs
(``utils/graph.py``: on the CPU their plumbing, the bodies called
eagerly), says so on a first line, then prints JAX's lines
(``MULTICHIP_r05.json`` holds JAX's own), each reading within its bound:
the mesh train loss within 1e-4 relative of one process, the pure-data
serving tick and the Megatron serving forward within rtol / atol 1e-4 of
one engine.  Without a card the default ``device="cuda"`` raises before
any rank starts.
"""

import json
import os
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu_torch import entry  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.parallel.launch import run_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(line: str) -> str:
    """A line with its numbers blanked."""
    return re.sub(r"\d+(\.\d+)?(e[-+]\d+)?", "#", line.split(" (bound")[0])


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    res = entry.dryrun_multichip(4, device="cpu", timeout=600)
    route, *lines = capsys.readouterr().out.strip().splitlines()
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        jax_lines = json.load(f)["tail"].strip().splitlines()
    # The route, then JAX's five lines in its order (the port adds each
    # reading's bound).
    assert route == "dryrun route: compiled programs on 4 gloo ranks (cpu)"
    assert res["route"] == "compiled" and res["backend"] == "gloo"
    assert [_shape(ln) for ln in lines] == [_shape(ln) for ln in jax_lines]
    assert lines[0].startswith("dryrun flagship train OK: mesh 2x2, D=192 "
                               "depth=12")
    assert lines[-1].startswith("dryrun_multichip OK: mesh 2x2")
    assert res["mesh"] == [2, 2]
    assert np.isfinite(res["loss"])
    assert res["d_loss"] <= 1e-4 * max(1.0, abs(res["loss_single"]))
    assert res["d_serve"] <= 1e-4 and res["d_tp"] <= 1e-4
    # Four ranks reported; on the CPU no kernel launches.
    assert len(res["launches"]) == 4
    assert all(v == 0 for r in res["launches"] for c in r.values()
               for v in c.values())


def test_dryrun_ranks_get_the_device_type_not_an_index(monkeypatch):
    """Each rank takes its own card (``init_group``): handing every rank
    ``cuda:0`` put them all on card 0, which NCCL refuses."""
    seen = {}

    def ranks(fn, n, *args, device, timeout):
        seen.update(n=n, args=args)
        return [{"route": "compiled", "backend": "nccl", "lines": [],
                 "mesh": [2, 2]}] * n

    monkeypatch.setattr(entry, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr("gstreamer_vit_tracker_tpu_torch.parallel.launch."
                        "run_ranks", ranks)
    entry.dryrun_multichip(4, device="cuda:0")
    assert seen == {"n": 4, "args": ("cuda",)}


def test_dryrun_multichip_needs_cuda_without_a_device():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(2)


def _rank_one_dies(rank, n):
    """Rank 1's process ends without a result; rank 0 returns.  Rank 1
    leaves after a barrier, so that what fails is the call and not rank 0's
    set-up (a peer gone while its connections were still being made)."""
    import torch.distributed as dist

    dist.barrier()
    if rank == 1:
        os._exit(3)
    return rank


def test_a_rank_that_dies_without_a_result_fails_the_call_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"without a result .*\{1: 3\}"):
        run_ranks(_rank_one_dies, 2, device="cpu", timeout=600)
    assert time.monotonic() - t0 < 120


def _rank_zero_fails_after_one_dies(rank, n):
    """Rank 1's process ends without a result; rank 0 then raises, as a
    rank whose peer left in the middle of a collective does."""
    if rank == 1:
        os._exit(5)
    time.sleep(0.2)
    raise ConnectionError("peer gone")


def test_a_death_is_reported_before_the_failure_it_caused():
    # Rank 0's failure reaches the parent while rank 1's exit may not be
    # seen yet; the call waits its grace for the dead rank and raises the
    # death first, rank 0's traceback after it.
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(_rank_zero_fails_after_one_dies, 2, device="cpu", timeout=600)
    first, rest = str(err.value).split("\n", 1)
    assert re.search(r"without a result .*\{1: 5\}$", first), first
    assert "rank 0 of _rank_zero_fails_after_one_dies failed" in rest
    assert "ConnectionError: peer gone" in rest
    assert time.monotonic() - t0 < 120
