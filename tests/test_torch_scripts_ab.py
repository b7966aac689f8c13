"""PyTorch port: the four A/B and probe scripts of
``gstreamer_vit_tracker_tpu_torch/scripts/``, each through ``main(argv)``
with ``--cpu`` at a tiny size, printing the JAX script's lines and one JSON
line; without a card (no ``--cpu``) each exits 1 with a message.

``ab_fused_prep`` and ``ab_grouped_head`` are cut from the flagship on
1080p frames to the ``small`` preset on 160x128 (their module constants).
``probe_int8``'s exactness check (``torch._int_mm`` against numpy's int32
product) must hold.
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu_torch.scripts import (  # noqa: E402
    ab_fused_prep, ab_grouped_head, probe_int8, probe_relay_fetch)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    for mod in (ab_fused_prep, ab_grouped_head):
        monkeypatch.setattr(mod, "PRESET", "small")
        monkeypatch.setattr(mod, "FRAME_HW", (128, 160))
        monkeypatch.setattr(mod, "POOL", 4)


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_ab_fused_prep_on_the_cpu(tiny, capsys):
    assert ab_fused_prep.main(["--cpu", "--reps", "2", "--reps-hi", "3"]) == 0
    out = capsys.readouterr().out
    for arm in ("plain", "fused"):
        assert re.search(rf"^full step ms \({arm}\): -?\d+\.\d{{4}}$", out,
                         re.M), arm
        assert re.search(rf"^prep\+embed stage ms \({arm}\): -?\d+\.\d{{4}}$",
                         out, re.M), arm
    res = _json_line(out)
    assert res["reps"] == [2, 3] and res["timing"] == "host clock"
    for key in ("full_plain_ms", "full_fused_ms", "stage_plain_ms",
                "stage_fused_ms"):
        assert np.isfinite(res[key]), key


def test_ab_grouped_head_on_the_cpu(tiny, capsys):
    assert ab_grouped_head.main(["--cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^tower head:   -?\d+\.\d{4} ms/step  \(", out, re.M)
    assert re.search(r"^grouped head: -?\d+\.\d{4} ms/step  \(", out, re.M)
    assert re.search(r"^delta: [-+]\d+\.\d{4} ms/step$", out, re.M)
    res = _json_line(out)
    assert res["reps"] == [1, 5]
    assert res["delta_ms"] == pytest.approx(res["tower_ms"] - res["grouped_ms"])


def test_probe_int8_on_the_cpu(capsys):
    assert probe_int8.main(["--cpu", "--reps", "1", "--sizes", "320"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("backend: cpu")
    assert "int8 matmul exact: True" in lines
    for name in ("bf16", "int8"):
        assert re.search(rf"^N=320 {name}: -?\d+\.\d{{4}} ms per 12x\(mlp\) "
                         r"chain \(", out, re.M), name
    assert "done" in lines
    res = _json_line(out)
    assert res["int8_exact"] is True
    assert set(res["ms_per_chain"]["320"]) == {"bf16", "int8"}
    assert "not a kernel of the port" in res["what"]


def test_probe_int8_quantised_chain_tracks_bf16():
    # The W8A8 product against the float one on the probe's own shapes:
    # per-row / per-channel scales keep it within a few percent.
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((320, probe_int8.D), generator=gen)
    w = torch.randn((probe_int8.D, probe_int8.HID), generator=gen) * 0.05
    got = probe_int8.qdq_matmul(x, *probe_int8.quant_w(w))
    want = x @ w
    assert (got - want).abs().max() <= 0.02 * want.abs().max()


def test_probe_relay_fetch_on_the_cpu(capsys):
    assert probe_relay_fetch.main(["--cpu", "--samples", "3"]) == 0
    res = _json_line(capsys.readouterr().out)
    assert {"sync_ms", "serial2_ms", "conc2_ms", "overlap"} <= set(res)
    assert res["metric"] == "relay_fetch_overlap" and res["backend"] == "cpu"
    # A ratio of host times: beside busy workers anything from ~0 up.
    assert res["value"] == res["overlap"] >= 0
    assert 0 < res["sync_ms"] and 0 < res["serial2_ms"] and 0 < res["conc2_ms"]


@pytest.mark.parametrize("mod", [ab_fused_prep, ab_grouped_head, probe_int8,
                                 probe_relay_fetch])
def test_without_a_card_the_scripts_exit_1(mod, capsys):
    assert not torch.cuda.is_available()
    assert mod.main([]) == 1
    assert "pass --cpu" in capsys.readouterr().err
