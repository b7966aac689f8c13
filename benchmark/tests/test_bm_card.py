"""On the card (marked ``cuda``; skips without one): a short run of each
cell at its own size is correct, and the control (the reference in
float8 in the program's place) on the same steps is not."""

import pytest

from benchmark import check, control, harness, spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_and_control(card, name):
    c = spec.cell(spec.load(), name)
    out = harness.run_cell(c, 2 ** 31 + 31, 1.0, False, device=card)
    assert out["correct"], out["checks"]
    low, _ = control.read(out["sample"])
    assert not check.verdict(low, c.limits, True), low
