"""The reference against the port's eager path on the CPU: in float32
every number the check compares reads (all but) 0 on both routes (the
banded unbatched step with the grouped head, the batched step with the
three towers), and a tracked run in the configured bf16 is correct."""

import pytest

from benchmark import harness, spec

from .cells import tiny

CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_float32_agrees(name):
    out = harness.run_cell(tiny(name, "float32"), 2 ** 31 + 11, 0.3, False,
                           device="cpu")
    r = out["readings"]
    assert r["template_err"] < 1e-5
    assert r["conf_err"] < 1e-5
    assert r.get("box_err_px", 0.0) < 1e-3


@pytest.mark.parametrize("name", CELLS)
def test_bf16_correct(name):
    out = harness.run_cell(tiny(name), 2 ** 31 + 12, 0.3, False,
                           device="cpu")
    assert out["correct"], out["checks"]
