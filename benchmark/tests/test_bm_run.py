"""``benchmark.run`` needs a card: without one it exits non-zero and
prints no result, never falling back to the CPU."""

import subprocess
import sys

import pytest

from benchmark import spec


def test_exits_without_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "vittrack-t.live-1080p", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "CUDA" in p.stderr
