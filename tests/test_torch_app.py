"""PyTorch port: the tracker app, headless, beside the JAX package's app.

Both apps run in this process through ``main(argv)`` on the CPU with the
same argv and ``--record-track``; every row's state must be equal, boxes
within 1e-2 px and scores within 1e-4 (the rows round scores to 4 places,
so two scores 1e-4 apart may differ by one step of that rounding).  corr-tiny
runs on JAX's ``init_params(PRNGKey(0))`` carried across by its
``save_npz`` and ``--checkpoint``; ``small`` on its shipped weights.  Each
case runs once per module.  Then the port alone: every preset in every frame
format, its fault soak (the counterpart of ``test_media_app.py``'s), a
recording read back at the display size, and the exits: a missing card
without ``--cpu``, a bad ``--init-bbox``.
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu.app import main as japp  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.app import main as tapp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media.source import FileSource  # noqa: E402

BASE = ["--headless", "--cpu", "--no-pace", "--source", "synthetic",
        "--width", "320", "--height", "256"]
CASES = {
    "corr-tiny-rgb": ["--model", "corr-tiny", "--frames", "15"],
    "small-nv12": ["--model", "small", "--format", "nv12", "--frames", "15"],
    "corr-tiny-yuy2": ["--model", "corr-tiny", "--format", "yuy2",
                       "--frames", "15"],
    "corr-tiny-objects": ["--model", "corr-tiny", "--objects", "3",
                          "--exclusive", "--frames", "15"],
    "corr-tiny-pipelined": ["--model", "corr-tiny", "--pipelined",
                            "--frames", "15"],
}


@pytest.fixture(scope="module")
def corr_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "corr_tiny_jax.npz")
    jweights.save_npz(path, jvittrack.init_params(
        jax.random.PRNGKey(0), japp.PRESETS["corr-tiny"]))
    return path


def _run(main, argv):
    """``main(argv)`` with its prints captured: (return, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request, corr_ckpt, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    argv = BASE + CASES[request.param]
    if "corr-tiny" in argv:
        argv += ["--checkpoint", corr_ckpt]
    res = {}
    for name, main in (("jax", japp.main), ("port", tapp.main)):
        track = str(d / f"{name}.jsonl")
        rc, out = _run(main, argv + ["--record-track", track])
        res[name] = (rc, out, _rows(track))
    return request.param, res


def _objects(row):
    return row.get("objects") or [row]


def test_app_rows_match_jax(both):
    case, res = both
    (jrc, _, jrows), (trc, tout, trows) = res["jax"], res["port"]
    assert jrc == trc == 0
    assert len(trows) == len(jrows) == 15
    assert [r["frame"] for r in trows] == list(range(15))
    for j, t in zip(jrows, trows):
        assert t["state"] == j["state"], (case, t["frame"])
        jo, to = _objects(j), _objects(t)
        assert [o.get("id") for o in to] == [o.get("id") for o in jo]
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0,
                                       atol=1e-2, err_msg=f"{case} {t}")
            assert abs(a["score"] - b["score"]) <= 1e-4 + 1e-9, (case, t, j)
    assert trows[-1]["state"].startswith("TRACKING")
    if case == "corr-tiny-objects":
        assert trows[-1]["state"] == "TRACKING 3 OF 3"
    assert "final state TRACKING" in tout


def test_app_prints_like_jax(both):
    """The same console lines, but for timings and the device line."""
    _, res = both

    def shape(out):
        return [line.split(":")[0].split("(")[0] for line in out.splitlines()
                if line and not line.startswith(("backend", "Done"))]

    assert shape(res["port"][1]) == shape(res["jax"][1])


@pytest.mark.parametrize("fmt", ("rgb", "nv12", "yuy2"))
@pytest.mark.parametrize("model", ("corr-tiny", "small", "vittrack-t"))
def test_every_preset_runs_in_every_format(model, fmt, tmp_path):
    track = str(tmp_path / "t.jsonl")
    report = tapp.run(BASE + ["--model", model, "--format", fmt, "--frames",
                              "3", "--record-track", track])
    rows = _rows(track)
    assert report.rc == 0 and report.frames == 3 and len(rows) == 3
    assert all(np.isfinite(r["bbox"]).all() and 0 <= r["score"] <= 1
               for r in rows)
    assert report.final_state == rows[-1]["state"]
    assert report.track_ms_p50 > 0 and report.draw_ms > 0


def test_fault_injection_soak():
    """--inject-source-fault / --inject-device-fault (the counterpart of
    ``test_media_app.py::test_headless_fault_injection_soak_flags``):
    transport faults ride the reopen path, device faults the session's
    recover + re-seed path, and the run ends with the target TRACKING."""
    rc, out = _run(tapp.main, [
        "--headless", "--cpu", "--model", "corr-tiny", "--width", "320",
        "--height", "256", "--frames", "150", "--no-pace", "--format", "nv12",
        "--inject-source-fault", "40", "--inject-device-fault", "45",
        "--inject-corrupt", "0"])
    assert rc == 0, out
    assert "injected transport fault" in out           # source faults fired
    assert "reopens 3" in out, out                     # ...and all recovered
    assert "Tracker error" in out                      # device faults fired
    assert "re-acquired" in out or "faults" in out
    assert "Unrecoverable" not in out
    assert "final state TRACKING" in out, out


def test_multi_object_device_faults_recreate_the_backend():
    """In multi-object mode a device fault escapes the session to the app's
    loop, which re-creates the backend and re-seeds every tracked slot."""
    report = tapp.run([
        "--headless", "--cpu", "--model", "corr-tiny", "--width", "320",
        "--height", "256", "--frames", "100", "--no-pace", "--format", "nv12",
        "--objects", "3", "--exclusive", "--inject-device-fault", "45"])
    assert report.rc == 0 and report.backend_recreates >= 1
    assert report.faults == report.backend_recreates
    assert report.final_state == "TRACKING 3 OF 3"


def test_record_and_display_scale(tmp_path):
    path = str(tmp_path / "out.y4m")
    report = tapp.run(BASE + ["--model", "corr-tiny", "--frames", "4",
                              "--record", path, "--display-scale"])
    assert report.rc == 0
    fs = FileSource(path)
    assert (fs.num_frames, fs.width, fs.height) == (4, 1280, 1024)
    y, _ = fs.frame(3)
    assert y.shape == (1024, 1280) and y.std() > 0


def test_no_card_without_cpu_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in BASE if a != "--cpu"] + ["--frames", "2"]
    assert tapp.main(argv) != 0
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--cpu" in err


@pytest.mark.parametrize("bad", ("1,2,3", "10,10,10,10"))
def test_bad_init_bbox_exits_2(bad, capsys):
    assert tapp.main(BASE + ["--model", "corr-tiny", "--frames", "2",
                             "--init-bbox", bad]) == 2
    assert "error: --init-bbox" in capsys.readouterr().out


def test_flags_and_defaults_equal_jax():
    def table(ap):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       tuple(a.choices) if a.choices else None, a.type,
                       a.nargs, a.const) for a in ap._actions)

    assert table(tapp.build_argparser()) == table(japp.build_argparser())
