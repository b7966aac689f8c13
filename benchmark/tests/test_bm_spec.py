"""Every cell's files are found by the names in ``BENCHMARK.json``, and a
new configuration, mix and metric are taken as added files and entries
with no file edited."""

import json
import os
import shutil

import pytest

from benchmark import spec

BENCH = spec.load()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found(name):
    c = spec.cell(BENCH, name)
    assert c.config["model"]["dtype"] == "bfloat16"
    assert "conf_err" in c.limits
    assert set(c.limits) <= {"template_err", "conf_err", "box_err_px",
                             "cell_slack"}
    assert ("box_err_px" in c.limits) == ("cell_slack" in c.limits)
    assert hasattr(spec.driver(c.traffic), "Driver")
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]).read)
    assert {m["name"] for m in c.end_to_end} == {
        "tracked_fps", "frame_p95_ms", "setup_s"}


def test_per_layer_metrics_by_cell():
    live = spec.cell(BENCH, "vittrack-t.live-1080p")
    serve = spec.cell(BENCH, "ostrack-256.serve-16")
    names = lambda c: {m["name"] for m in c.per_layer}  # noqa: E731
    assert names(live) == {"device_idle_pct", "step_mfu_pct",
                           "k1_roofline_pct", "host_call_ms", "upload_ms"}
    assert names(serve) == {"device_idle_pct", "step_mfu_pct",
                            "k3_roofline_pct", "host_call_ms"}


def test_added_files_and_entries_are_taken(tmp_path):
    root = tmp_path / "co"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bm = root / "benchmark"
    conf = json.loads((bm / "configs" / "vittrack-t.json").read_text())
    conf["model"]["depth"] = 6
    (bm / "configs" / "vittrack-t-d6.json").write_text(json.dumps(conf))
    mix = json.loads((bm / "traffic" / "serve-16.json").read_text())
    mix["streams"] = 8
    (bm / "traffic" / "serve-8.json").write_text(json.dumps(mix))
    (bm / "limits" / "vittrack-t-d6.serve-8.json").write_text(
        (bm / "limits" / "vittrack-t.serve-16.json").read_text())
    (bm / "metrics" / "dispatch_ms.serve.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    bench["configs"].append(dict(bench["configs"][0], name="vittrack-t-d6",
                                 file="benchmark/configs/vittrack-t-d6.json"))
    bench["workloads"].append({"name": "vittrack-t-d6.serve-8",
                               "config": "vittrack-t-d6", "traffic": "serve-8",
                               "chips": 1, "why": "an added cell"})
    bench["per_layer"].append({"name": "dispatch_ms.serve", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine", "moves": "frame_p95_ms",
                               "workloads": ["vittrack-t-d6.serve-8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in bm.rglob("*") if p.is_file()}
    c = spec.cell(spec.load(str(root)), "vittrack-t-d6.serve-8", str(root))
    assert c.config["model"]["depth"] == 6 and c.traffic["streams"] == 8
    assert "dispatch_ms.serve" in {m["name"] for m in c.per_layer}
    assert spec.reader("dispatch_ms.serve", str(root)).read(None) == 1.5
    assert {p: p.read_bytes() for p in bm.rglob("*") if p.is_file()} == before
