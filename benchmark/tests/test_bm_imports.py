"""Nothing the benchmark runs imports JAX or the JAX package (whole
top-level names), and the reference imports nothing of the port."""

import ast
import os

import pytest

from benchmark import run, spec

BM = os.path.join(spec.ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "gstreamer_vit_tracker_tpu"}


def _sources(sub=""):
    for d, _dirs, files in os.walk(os.path.join(BM, sub)):
        if os.path.basename(d) in ("tests", "__pycache__"):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def _tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_jax(path):
    assert not JAX.intersection(_tops(path)), path


@pytest.mark.parametrize("path", sorted(_sources("reference")))
def test_reference_imports_no_port(path):
    assert "gstreamer_vit_tracker_tpu_torch" not in set(_tops(path)), path


def test_forbidden_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "gstreamer_vit_tracker_tpu_torch",
                        types.ModuleType("gstreamer_vit_tracker_tpu_torch"))
    assert "gstreamer_vit_tracker_tpu" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert "jaxlib" in run.forbidden_loaded()
