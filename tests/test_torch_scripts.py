"""PyTorch port: the scripts of ``gstreamer_vit_tracker_tpu_torch/scripts/``
that this slice adds, each through ``main(argv)`` with ``--cpu`` at a tiny
size, and without a card (no ``--cpu``) each exits 1 with a message.

``profile_scan`` and ``profile_streams`` are cut from the flagship on 1080p
frames to the ``small`` preset on 160x128 (their module constants); their
JSON lines carry every stage's ms.  ``bench_serve``'s JSON line has the
JAX script's keys, for the same arguments.  ``soak`` drives the app as a
subprocess through faults and passes its checks.  The exported graph holds
every parameter's values, and a torch-layout ONNX file of the shipped
``small`` weights imports to the same arrays.  ``agreement_cv2``'s replica
rung reads 1.000, as JAX's does.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import import_onnx, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.scripts import (  # noqa: E402
    agreement_cv2, bench_serve, export_vittrack_onnx, import_vittrack_onnx,
    profile_scan, profile_streams, soak)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in the soak's app process: the suite
    runs beside other workers, and oversubscribed thread pools spin."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.fixture
def tiny_profiles(monkeypatch):
    for mod in (profile_scan, profile_streams):
        monkeypatch.setattr(mod, "PRESET", "small")
        monkeypatch.setattr(mod, "FRAME_HW", (128, 160))
    monkeypatch.setattr(profile_scan, "POOL", 4)


def test_profile_scan_on_the_cpu(tiny_profiles, capsys):
    rc = profile_scan.main(["--cpu", "--streams", "2", "--reps", "2",
                            "--reps-hi", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "headline marginal ms/step: full=" in out
    assert "2-stream aggregate (scan_pool):" in out
    res = _json_line(out)
    for key in ("full_ms", "prep_vit_heads_ms", "prep_ms", "vit_heads_ms",
                "decode_state_ms", "scan_pool_gather_ms", "scan_fixed_ms",
                "python_loop_ms", "aggregate_fps"):
        assert np.isfinite(res[key]), key
    assert res["reps"] == [2, 3] and res["device_ms"] is None
    assert res["device"] == "cpu" and res["timing"] == "host clock"


def test_profile_streams_on_the_cpu(tiny_profiles, capsys):
    rc = profile_streams.main(["--cpu", "--streams", "2", "--reps", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "full 16-stream step" in out and "\ntotal " in out
    res = _json_line(out)
    assert res["streams"] == 2 and res["device_ms"] is None
    assert res["flops"] > 0
    np.testing.assert_allclose(res["full_ms"], res["prep_ms"] + res["vit_ms"]
                               + res["other_ms"], rtol=1e-9)


@pytest.mark.parametrize("mod", [profile_scan, profile_streams, bench_serve,
                                 agreement_cv2])
def test_without_a_card_the_scripts_exit_1(mod, capsys):
    assert not torch.cuda.is_available()
    assert mod.main([]) == 1
    assert "pass --cpu" in capsys.readouterr().err


def test_onnx_scripts_without_a_card_exit_1(tmp_path, capsys):
    ckpt = weights.checkpoint_path("small")
    assert export_vittrack_onnx.main(["--checkpoint", ckpt]) == 1
    assert import_vittrack_onnx.main(["--onnx", ckpt, "--out", "x"]) == 1
    assert capsys.readouterr().err.count("pass --cpu") == 2


def test_bench_serve_json_line_has_jax_keys(monkeypatch, capsys):
    from scripts import bench_serve as jbench

    argv = ["--streams", "2", "--frames", "3", "--cpu"]
    assert bench_serve.main(argv) == 0
    ours = _json_line(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["bench_serve.py"] + argv)
    assert jbench.main() == 0
    theirs = _json_line(capsys.readouterr().out)
    assert set(ours) == set(theirs) | {"device"}
    for key in ("metric", "unit", "streams", "frames_per_stream", "format",
                "model", "backend"):
        assert ours[key] == theirs[key], key
    assert ours["value"] > 0 and ours["ticks"] >= 1


def test_soak_recovers_and_holds_steady(capsys):
    rc = soak.main(["--cpu", "--model", "corr-tiny", "--frames", "900",
                    "--width", "160", "--height", "128",
                    "--source-fault-every", "397",
                    "--device-fault-every", "301", "--corrupt-every", "251",
                    "--sample-s", "0.2"])
    res = _json_line(capsys.readouterr().out)
    # fps_steady compares the app's wall-clock fps between two quarters of
    # the run; beside other busy test workers it measures them (176 -> 66
    # fps in one whole run), so here it must be computed, and its rule is
    # held by the tests of soak.fps_steady below.  The card's smoke run
    # requires every check, fps_steady included.
    assert res["fps_first"] is not None and res["fps_last"] is not None
    assert res["checks"]["fps_steady"] == soak.fps_steady(
        [(0.0, res["fps_first"])] * 8 + [(1.0, res["fps_last"])] * 8,
        0.5)[2]
    others = {k: v for k, v in res["checks"].items() if k != "fps_steady"}
    assert all(others.values()), res
    assert res["ok"] == all(res["checks"].values())
    assert rc == (0 if res["ok"] else 1), res
    assert res["value"] == 900 and res["source_reopens"] == 2
    # Warm-up ended after the first of each fault's recovery.
    assert 0 < res["warm_up_s"] < res["wall_s"]
    assert res["session_tracker_errors"] >= 1 and res["reacquired"] >= 1
    assert res["kernel_builds_2nd_half"] == 0


def _series(values):
    return [(0.1 * i, float(v)) for i, v in enumerate(values)]


@pytest.mark.parametrize("drop,steady", [(0.0, True), (0.3, True),
                                         (0.49, True), (0.51, False),
                                         (0.9, False)])
def test_fps_steady_bounds_a_collapse(drop, steady):
    # 40 prints: a warm-up quarter, then steady at 100 fps, then the last
    # quarter fallen by `drop` of it.
    fps = [20.0] * 10 + [100.0] * 20 + [100.0 * (1 - drop)] * 10
    first, last, ok = soak.fps_steady(_series(fps), 0.5)
    assert first == 100.0 and last == pytest.approx(100.0 * (1 - drop))
    assert ok is steady


def test_fps_steady_ignores_jitter_and_warm_up():
    rng = np.random.default_rng(0)
    fps = np.concatenate([np.full(10, 5.0), 100 + 10 * rng.standard_normal(30)])
    assert soak.fps_steady(_series(fps), 0.5)[2]
    # Too few prints decide nothing: the check fails rather than passes.
    assert soak.fps_steady(_series([100.0] * 7), 0.5) == (None, None, False)


def test_export_holds_every_parameter(tmp_path, capsys):
    ckpt = weights.checkpoint_path("vittrack-t")
    out = str(tmp_path / "g.onnx")
    assert export_vittrack_onnx.main(["--cpu", "--checkpoint", ckpt,
                                      "--out", out]) == 0
    assert capsys.readouterr().out.startswith(f"exported {out} (")
    graph = {}
    for arr in import_onnx.read_onnx_tensors(out).values():
        graph.setdefault(arr.size, []).append(np.sort(arr.ravel()))
    with np.load(ckpt) as data:
        for key in data.files:
            want = np.sort(data[key].astype(np.float32).ravel())
            assert any(np.array_equal(want, g)
                       for g in graph.get(want.size, [])), key


def test_import_gives_back_the_tensors(tmp_path, capsys):
    cfg = PRESETS["small"]
    params = weights.load_npz(weights.checkpoint_path("small"), cfg,
                              device="cpu")
    back = {import_onnx._t: lambda a: a.T,
            import_onnx._conv: lambda a: a.transpose(3, 2, 0, 1),
            import_onnx._patch: lambda a: a.reshape(
                cfg.patch_size, cfg.patch_size, 3, -1).transpose(3, 2, 0, 1),
            import_onnx._pos: lambda a: a[None],
            import_onnx._ident: lambda a: a}
    tensors, seen = {}, set()
    for name, (path, conv) in import_onnx.default_name_map(params).items():
        if path not in seen:
            seen.add(path)
            leaf = import_onnx._get_path(params, path).numpy()
            tensors[name] = np.ascontiguousarray(back[conv](leaf))
    src = str(tmp_path / "torch_layout.onnx")
    import_onnx.write_onnx_tensors(src, tensors)
    out = str(tmp_path / "w.npz")
    assert import_vittrack_onnx.main(["--cpu", "--onnx", src, "--out", out,
                                      "--preset", "small"]) == 0
    assert capsys.readouterr().out.startswith("imported ")
    with np.load(out) as got, np.load(weights.checkpoint_path("small")) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_agreement_replica_rung_reads_one(capsys):
    pytest.importorskip("cv2")
    rc = agreement_cv2.main(["--cpu", "--frames", "4", "--seeds", "5",
                             "--rungs", "replica"])
    res = _json_line(capsys.readouterr().out)
    assert rc == 0
    assert res["per_rung"]["replica"] == {"mean_iou": 1.0, "min_iou": 1.0}


def test_agreement_without_cv2_runs_no_rung(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert agreement_cv2.main(["--cpu", "--frames", "4"]) == 1
    captured = capsys.readouterr()
    assert "needs cv2" in captured.err and "seed" not in captured.out


@pytest.fixture
def programs(monkeypatch):
    """The compiled programs the scripts make (``scan.scanned``), by
    name."""
    from gstreamer_vit_tracker_tpu_torch.tracker import scan

    made, real = {}, scan.scanned

    def record(step, name):
        run = real(step, name)
        made[name] = run.program
        return run

    monkeypatch.setattr(scan, "scanned", record)
    return made


def test_profile_variants_are_compiled_programs(tiny_profiles, programs,
                                                capsys):
    # Each variant's rep loop is one compiled program (JAX's scanned
    # programs), captured once for both rep counts.
    assert profile_scan.main(["--cpu", "--streams", "2", "--reps", "2",
                              "--reps-hi", "3"]) == 0
    assert profile_streams.main(["--cpu", "--streams", "2", "--reps",
                                 "2"]) == 0
    capsys.readouterr()
    assert sorted(programs) == sorted(
        [f"profile_scan.{k}" for k in ("full", "prep_vit_heads", "prep",
                                       "scan_fixed")]
        + [f"profile_streams.{k}" for k in ("full", "prep", "vit")])
    assert {k: p.traces for k, p in programs.items()} == {
        k: 1 for k in programs}


def test_agreement_production_rung_is_the_compiled_plain_route(
        monkeypatch, capsys):
    # JAX's production rung jits core.update(..., use_pallas=False,
    # fused=False): the port's compiles the same plain per-block route.
    pytest.importorskip("cv2")
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    routes, real = [], core.update

    def record(*a, **kw):
        routes.append((kw.get("use_kernel"), kw.get("fused")))
        return real(*a, **kw)

    monkeypatch.setattr(core, "update", record)
    traces = agreement_cv2.update.traces
    rc = agreement_cv2.main(["--cpu", "--frames", "3", "--seeds", "5",
                             "--rungs", "production"])
    res = _json_line(capsys.readouterr().out)
    assert rc == 0 and res["frames"] == 3
    assert set(res["per_rung"]) == {"production"}
    assert routes == [(False, False)] * 3
    assert agreement_cv2.update.traces == traces + 1
