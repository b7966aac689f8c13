"""PyTorch port: ``gstreamer_vit_tracker_tpu_torch/bench.py``, the port of
the root ``bench.py``, on the CPU at full width (the flagship on 1080p and
4K noise frames) with the counts cut to 2.

Its JSON line carries exactly the JAX bench's keys (read from the root
``bench.py`` by ``ast``) with the substitutions its docstring states; no
kernel launches on the CPU; a failing config is recorded under
``<name>_error`` and the run exits 1; without ``--cpu`` and without a card
it exits 1 with a message; the noise pools are the JAX bench's draws; and
the init watchdog prints the error line and exits 1.
"""

import ast
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu.utils import flops as jax_flops  # noqa: E402
from gstreamer_vit_tracker_tpu_torch import bench  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = ["--cpu", "--frames", "2", "--pool", "2", "--loop-frames", "2",
       "--streams", "2", "--objects", "2", "--serve-slots", "2"]
CONFIGS = {"headline", "loop", "stream", "object", "uhd", "rgb", "yuy2",
           "serve", "ingest"}
# The port's line against JAX's (bench.py's module docstring).
DROPPED = {"vs_baseline", "baseline_is", "window_degraded"}
ADDED = {"gpu_name", "gpu_power_limit", "runs_s", "launches"}


@contextlib.contextmanager
def one_thread():
    """One intra-op thread: the suite runs beside other workers, and
    oversubscribed thread pools spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _run(argv):
    out = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(out):
        rc, res = bench.run(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, res, lines


@pytest.fixture(scope="module")
def cpu_run():
    rc, res, lines = _run(CUT)
    assert rc == 0
    assert len(lines) == 1
    assert json.loads(lines[0]) == json.loads(json.dumps(res))
    return res


def _mfu_prefix(call: ast.Call):
    """The ``prefix`` of a ``flops_mod.mfu_fields(...)`` call, or None if
    ``call`` is another call."""
    if not (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "mfu_fields"):
        return None
    for kw in call.keywords:
        if kw.arg == "prefix":
            return kw.value.value
    return ""


def jax_bench_keys() -> set:
    """Every key root ``bench.py`` writes into ``result``: the literal's, the
    ``result["..."] =`` assignments', and ``mfu_fields``' under each prefix
    (the JAX package's own function names them)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys, prefixes = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id == "result"
                    and isinstance(node.value, ast.Dict)):
                for k, v in zip(node.value.keys, node.value.values):
                    if k is None:
                        prefixes.append(_mfu_prefix(v))
                    else:
                        keys.add(k.value)
            elif (isinstance(t, ast.Subscript)
                  and isinstance(t.value, ast.Name) and t.value.id == "result"
                  and isinstance(t.slice, ast.Constant)):
                keys.add(t.slice.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "result"):
            prefixes.append(_mfu_prefix(node.args[0]))
    assert sorted(prefixes) == ["", "stream_", "uhd_"]
    for p in prefixes:
        keys |= set(jax_flops.mfu_fields(1.0, 1.0, prefix=p))
    return keys


def test_line_has_the_jax_benchs_keys_with_the_stated_substitutions(cpu_run):
    jax_keys = jax_bench_keys()
    assert DROPPED <= jax_keys and "value" in jax_keys
    want = {k.replace("mfu_vs_v5e_bf16", "mfu_vs_h100_bf16")
            for k in jax_keys - DROPPED} | ADDED
    assert set(cpu_run) == want
    assert cpu_run["metric"] == "tracked_fps_per_chip_1080p_nv12"
    assert cpu_run["backend"] == "cpu"
    assert cpu_run["model"].endswith(" trained")
    assert cpu_run["gpu_name"] is None and cpu_run["gpu_power_limit"] is None
    assert (cpu_run["streams"], cpu_run["objects"],
            cpu_run["serve_slots"]) == (2, 2, 2)


def test_every_config_runs_and_launches_no_kernel_on_the_cpu(cpu_run):
    assert set(cpu_run["launches"]) == CONFIGS
    for counts in cpu_run["launches"].values():
        assert set(counts) == {"vit_encoder", "vit_block", "attention_single",
                               "attention_flash", "fused_prep_embed"}
        assert not any(counts.values())
    runs = cpu_run["runs_s"]
    assert set(runs) == CONFIGS | {"serve_pipelined", "h2d"}
    for name, walls in runs.items():
        assert len(walls) == (1 if name in ("loop", "ingest", "h2d") else 2)
        assert all(w > 0 for w in walls)
    # Every number finite; every rate and time positive (the MFU keys are
    # rounded for a card and may read 0 on a CPU).
    for k, v in cpu_run.items():
        if isinstance(v, (int, float)):
            assert math.isfinite(v) and v >= 0, k
            if k.endswith(("fps", "fps_total", "_per_s", "_mb_s", "_ms")):
                assert v > 0, k


@pytest.mark.parametrize("name,argv", [
    ("ingest", ["--headline-only"]),
    ("rgb", ["--streams", "0", "--objects", "0", "--serve-slots", "0"]),
])
def test_a_failing_config_is_recorded_and_the_run_exits_1(monkeypatch, name,
                                                         argv):
    def boom(b):
        raise RuntimeError("injected")

    monkeypatch.setattr(bench, f"_config_{name}", boom)
    rc, res, lines = _run(["--cpu", "--frames", "2", "--pool", "2",
                           "--loop-frames", "2"] + argv)
    assert rc == 1
    line = json.loads(lines[-1])
    assert line[f"{name}_error"] == "RuntimeError: injected"
    assert line["value"] > 0
    # The configs after it still ran.
    if name == "rgb":
        assert line["yuy2_640x512_fps"] > 0 and line["ingest_fps"] > 0
        assert line["uhd_fps"] > 0


def test_without_a_card_it_exits_1_with_a_message(capsys):
    assert not torch.cuda.is_available()
    assert bench.main(["--frames", "2"]) == 1
    out, err = capsys.readouterr()
    assert "--cpu" in err and "CUDA" in err
    assert out == ""


@pytest.mark.parametrize("argv", [[], ["--headline-only"], ["--no-ingest"],
                                  ["--no-ingest", "--ingest"]])
def test_noise_pools_are_the_jax_benchs_draws(argv):
    """Root ``bench.py``'s calls in its order: the NV12 pool (:143-147), the
    4K pool (:345-348), RGB (:385), YUY2 (:410), ingest (:436-440).  Root
    ``bench.py``'s argv passes unchanged: its hidden ``--ingest`` (the old
    spelling, :60-61) turns the ingest config back on."""
    args = bench.build_argparser().parse_args(["--pool", "2"] + argv)
    assert args.ingest == (argv[-1:] != ["--no-ingest"])
    got = bench.draw_pools(np.random.default_rng(0), args)
    rng = np.random.default_rng(0)
    h, w = 1080, 1920
    frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2, 2), dtype=np.uint8))
              for _ in range(2)]
    np.testing.assert_array_equal(got["nv12"][0],
                                  np.stack([f[0] for f in frames]))
    np.testing.assert_array_equal(got["nv12"][1],
                                  np.stack([f[1] for f in frames]))
    if "--headline-only" in argv:
        assert set(got) == {"nv12", "ingest"}
    else:
        ys4 = rng.integers(0, 256, (4, 2160, 3840), dtype=np.uint8)
        uvs4 = rng.integers(0, 256, (4, 1080, 1920, 2), dtype=np.uint8)
        np.testing.assert_array_equal(got["uhd"][0], ys4)
        np.testing.assert_array_equal(got["uhd"][1], uvs4)
        np.testing.assert_array_equal(
            got["rgb"], rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
        np.testing.assert_array_equal(
            got["yuy2"], rng.integers(0, 256, (2, 512, 1280), dtype=np.uint8))
    if argv[-1:] == ["--no-ingest"]:
        assert "ingest" not in got
        return
    for y, uv in got["ingest"]:
        np.testing.assert_array_equal(
            y, rng.integers(0, 256, (h, w), dtype=np.uint8))
        np.testing.assert_array_equal(
            uv, rng.integers(0, 256, (h // 2, w // 2, 2), dtype=np.uint8))


def test_a_hung_card_init_prints_the_error_line_and_exits_1():
    code = ("import time, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.init = lambda: time.sleep(120)\n"
            "from gstreamer_vit_tracker_tpu_torch import bench\n"
            "bench.main(['--init-timeout', '1'])\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["metric"] == bench.METRIC
    assert "unreachable after 1s" in line["error"]
