"""PyTorch port, ``scripts/eval_tracking.py`` on the CPU (``--cpu``) against
the JAX package's script, on the shipped ``small`` weights, one sequence of
20 frames at 320x256:

* on ``--world independent`` and ``--world family``, the port's per-frame
  boxes (recorded from inside its ``main`` run) are within 1 px of JAX's
  ``run_sequence`` on the same source, and its confidences within 0.01.
  The two float32 runs are held free-running (no near-tie parts them
  here: they stay within 4.2e-5 px and 1.9e-6 of each other over the 20
  frames);
* the ``--json`` summary's keys equal JAX's ``summarize`` of its rows, the
  values within 1e-3, and the printed lines are JAX's;
* ``--objects 2`` goes through the port's multi-object path and agrees with
  JAX's ``run_sequence_multi`` within 1e-3;
* flags, defaults, scenarios and presets are the JAX script's; the exits
  (no card, bad combinations) are its codes.
"""

import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.scripts import eval_tracking as teval  # noqa: E402
from scripts import eval_tracking as jeval  # noqa: E402

W, H, FRAMES = 320, 256, 20
BASE = ["--cpu", "--preset", "small", "--seqs", "1", "--frames", str(FRAMES),
        "--width", str(W), "--height", str(H)]
BOX_TOL, CONF_TOL, SUMMARY_TOL = 1.0, 0.01, 1e-3


@pytest.fixture(scope="module")
def jax_small():
    """JAX's config, the shipped ``small`` weights in a JAX tree, and its
    jitted update (one compile for every 320x256 case)."""
    jcfg = jeval.PRESETS["small"]
    tparams = weights.load_npz(weights.checkpoint_path("small"),
                               teval.PRESETS["small"], device="cpu")
    jparams = jweights.load_npz(weights.checkpoint_path("small"),
                                weights.tree_to_numpy(tparams))
    upd = jax.jit(lambda p, s, f: jcore.update(p, s, f, jcfg))
    return jcfg, jparams, upd


def _recorder(fn, out):
    def rec(*a, **kw):
        st, bbox, conf = fn(*a, **kw)
        out.append((np.asarray(bbox, np.float64).copy(), float(conf)))
        return st, bbox, conf
    return rec


@pytest.mark.parametrize("world", ["independent", "family"])
def test_rows_and_summary_match_jax(world, jax_small, tmp_path, monkeypatch,
                                    capsys):
    jcfg, jparams, upd = jax_small
    path = str(tmp_path / "s.json")
    ours = []
    monkeypatch.setattr(teval.core, "update",
                        _recorder(teval.core.update, ours))
    report = teval.run(BASE + ["--world", world, "--json", path])
    monkeypatch.undo()
    assert report.rc == 0 and report.updates == FRAMES
    text = capsys.readouterr().out

    args = argparse.Namespace(speed=3.0, width=W, height=H, frames=FRAMES,
                              world=world)
    src = jeval.make_source("basic", 0, args)
    theirs = []
    rows = jeval.run_sequence(_recorder(upd, theirs), jparams, jcfg, src,
                              FRAMES)
    assert len(ours) == len(theirs) == FRAMES
    d_box = max(np.abs(a[0] - b[0]).max() for a, b in zip(ours, theirs))
    d_conf = max(abs(a[1] - b[1]) for a, b in zip(ours, theirs))
    assert d_box <= BOX_TOL and d_conf <= CONF_TOL, (d_box, d_conf)

    want = jeval.summarize("basic", rows, 0.25)
    with open(path) as f:
        got = json.load(f)
    assert got["mode"] == "ours" and got["preset"] == "small"
    s = got["scenarios"]["basic"]
    assert set(s) == set(want)
    for k, v in want.items():
        assert abs(s[k] - v) <= SUMMARY_TOL, k
    assert (f"seq 0 (obj 40px): mean IoU {want['mean_iou']:.3f} min "
            f"{want['min_iou']:.3f} conf {want['mean_conf']:.2f} lost "
            f"{want['lost_frames']}") in text
    assert (f"basic: overall mean IoU {want['mean_iou']:.3f}, "
            f"precision@20px {want['precision_20px']:.3f}") in text
    assert f"summary written to {path}" in text


def test_objects_2_matches_jax_multi(jax_small, tmp_path):
    jcfg, jparams, _ = jax_small
    path = str(tmp_path / "m.json")
    frames = 10
    report = teval.run(["--cpu", "--preset", "small", "--seqs", "1",
                        "--frames", str(frames), "--width", str(W),
                        "--height", str(H), "--objects", "2", "--json", path])
    assert report.rc == 0 and report.updates == frames
    with open(path) as f:
        got = json.load(f)
    src = jeval.SyntheticSource(W, H, obj_size=40, seed=0, speed=3.0,
                                n_distractors=1)
    mi, _mc, cov = jeval.run_sequence_multi(jparams, jcfg, src, frames, 2)
    want = {"mode": "multi-object", "objects": 2, "scenario": "basic",
            "mean_iou": float(mi.mean()), "min_object_iou": float(mi.min()),
            "coverage": float(cov)}
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= SUMMARY_TOL, k
        else:
            assert got[k] == v


def test_scenario_all_prints_the_table(tmp_path, capsys):
    path = str(tmp_path / "a.json")
    report = teval.run(BASE[:5] + ["--frames", "2", "--width", str(W),
                                   "--height", str(H), "--scenario", "all",
                                   "--world", "independent", "--json", path])
    assert report.rc == 0 and report.updates == 2 * len(teval.SCENARIOS)
    text = capsys.readouterr().out
    assert "scenario        mean_iou  min_iou  lost  prec@20  nprec@0.2" in text
    with open(path) as f:
        assert list(json.load(f)["scenarios"]) == list(teval.SCENARIOS)


@pytest.mark.parametrize("tracker", ["cv2", "matched"])
def test_cv2_trackers_run_the_flagship(tracker, tmp_path):
    pytest.importorskip("cv2", reason="cv2 is not installed")
    path = str(tmp_path / "c.json")
    report = teval.run(["--cpu", "--preset", "vittrack-t", "--seqs", "1",
                        "--frames", "3", "--width", str(W), "--height",
                        str(H), "--tracker", tracker, "--json", path])
    assert report.rc == 0
    with open(path) as f:
        s = json.load(f)
    assert s["mode"] == tracker
    assert 0.0 <= s["scenarios"]["basic"]["mean_iou"] <= 1.0


@pytest.mark.parametrize("argv,code", [
    (["--tracker", "cv2", "--objects", "2"], 2),
    (["--tracker", "matched"], 2),                 # small: not the flagship
    (["--objects", "2", "--scenario", "heldout"], 2),
])
def test_exit_codes_equal_jax(argv, code, capsys):
    assert teval.main(BASE + argv) == code
    assert capsys.readouterr().err


def test_unknown_scenario_part_exits():
    with pytest.raises(SystemExit, match="unknown scenario part"):
        teval.main(BASE + ["--scenario", "basic+bogus"])


def test_no_card_without_cpu_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert teval.main(BASE[1:]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--cpu" in err


def test_flags_defaults_scenarios_equal_jax(monkeypatch):
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["ap"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jeval.main([])
    monkeypatch.undo()

    def table(ap):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       tuple(a.choices) if a.choices else None, a.type,
                       a.nargs, a.const) for a in ap._actions)

    assert table(teval.build_argparser()) == table(seen["ap"])
    assert teval.SCENARIOS == jeval.SCENARIOS
    assert sorted(teval.PRESETS) == sorted(jeval.PRESETS)


def test_the_loop_runs_the_compiled_update(tmp_path, capsys, monkeypatch):
    # The per-frame update is compiled (JAX jits core.update): one capture
    # for the run, and the summary and the printed lines bit-equal to the
    # loop on the eager body.
    traces = teval.update.traces
    paths = [str(tmp_path / f"{k}.json") for k in ("c", "e")]
    assert teval.run(BASE + ["--json", paths[0]]).rc == 0
    assert teval.update.traces == traces + 1
    compiled = capsys.readouterr().out
    monkeypatch.setattr(teval, "update", teval.update.__wrapped__)
    assert teval.run(BASE + ["--json", paths[1]]).rc == 0
    assert capsys.readouterr().out.replace(paths[1], paths[0]) == compiled
    with open(paths[0]) as c, open(paths[1]) as e:
        assert json.load(c) == json.load(e)
