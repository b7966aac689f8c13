"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<mix>`` reads

* ``benchmark/configs/<config>.json``: the model (``model``: the tracker's
  configuration fields), its ``source``, ``weights``, ``reduced`` and
  ``assumed``;
* ``benchmark/traffic/<mix>.json``: the ``driver`` module under
  ``benchmark/drivers/`` that runs it and that module's parameters;
* ``benchmark/limits/<cell>.json``: the limit of each number the
  correctness check compares;
* ``benchmark/metrics/<metric>.py`` for each per-layer metric that applies
  to it: a module with ``read(ctx)``.

A later cell, mix or metric is a file and an entry: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List, NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> Dict[str, Any]:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: Dict[str, Any], cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell(bench: Dict[str, Any], name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its files read; raises KeyError if
    ``BENCHMARK.json`` has no such cell."""
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    here = os.path.join(root, "benchmark")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(work["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(here, "traffic",
                                   work["traffic"] + ".json")),
        limits=_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if _applies(m, name, reported)])


def _module(kind: str, name: str, root: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded from its path (a
    name may hold dots)."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: Dict[str, Any], root: str = ROOT):
    """The module that runs a mix."""
    return _module("drivers", traffic["driver"], root)


def reader(metric: str, root: str = ROOT):
    """The module that reads a per-layer metric."""
    return _module("metrics", metric, root)
