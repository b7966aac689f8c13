"""One run of one cell: set-up, the measured window, the traced slice, the
correctness check, and the result.

The window is a closed loop of the mix's driver steps for ``seconds``
seconds of the host clock; each step ends with its boxes on the host, so
the window's length covers all of its work.  The loop's thread is held
to one core and the garbage collector off in it (:func:`_steady`), so the
host's scheduler and collections move it less from run to run.  With
``trace`` the window is followed by the mix's ``trace_steps`` steps under
the profiler, which the per-layer readers reduce.  Then the peak memory
is read, the program's state dropped, and the reference run over a sample
of the window's steps drawn from the seed (``benchmark/check.py``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import check, counts, spec, trace as trace_mod, weights
from .reference.tracker import Reference


def model_config(fields: Dict[str, Any]):
    """The program's configuration object from a configuration file's
    ``model`` fields."""
    from gstreamer_vit_tracker_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})


def _set_up(cell: spec.Cell, seed: int, device, root: str, t_start: float):
    from gstreamer_vit_tracker_tpu_torch.device import true_float32

    dev = torch.device(device)
    true_float32(dev)
    _sync(dev)
    t_dev = time.perf_counter()
    fields = cell.config["model"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = weights.make(fields, cell.config["weights"], root, gen, dev)
    ctx = SimpleNamespace(device=dev, fields=fields, cfg=model_config(fields),
                          traffic=cell.traffic, flat=flat,
                          params=weights.nest(flat), gen=gen, seed=seed)
    _sync(dev)
    t_weights = time.perf_counter()
    drv = spec.driver(cell.traffic, root).Driver(ctx)
    _sync(dev)
    t_end = time.perf_counter()
    print(f"set-up: start to device {t_dev - t_start:.3f} s, weights "
          f"{t_weights - t_dev:.3f} s, driver {t_end - t_weights:.3f} s",
          file=sys.stderr)
    return ctx, drv


@contextlib.contextmanager
def _steady():
    """The calling thread on one core (the last it may use) and the
    garbage collector off, the objects made so far frozen out of its
    reach; both undone on exit."""
    pinned = hasattr(os, "sched_setaffinity")
    if pinned:
        cores = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {max(cores)})
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
        if pinned:
            os.sched_setaffinity(0, cores)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             root: str = spec.ROOT) -> Dict[str, Any]:
    """Run ``cell`` once.  Returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
    with ``trace``, ``checks``), the numbers the check compared under
    ``readings``, and under ``sample`` what it compared them on (the
    weights, the tracks, the sampled steps with their served rows), which
    ``benchmark/control.py`` judges the control on."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx, drv = _set_up(cell, seed, device, root, t_start)
    dev = ctx.device

    # The measured window.
    k0, n0 = drv.k, len(drv.lat)
    attempted = failed = 0
    with _steady():
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while time.perf_counter() - t0 < seconds:
            attempted += drv.frames_per_step
            try:
                drv.step()
            except Exception:   # noqa: BLE001 - counted, reported, judged
                failed += drv.frames_per_step
                traceback.print_exc(file=sys.stderr)
        window_s = time.perf_counter() - t0
    k1 = drv.k
    ends = np.cumsum(drv.lat[n0:])
    print("window: steps a second", np.bincount(ends.astype(int)).tolist(),
          file=sys.stderr)
    lat = np.asarray(drv.lat[n0:])
    calls = np.asarray(drv.calls[n0:])
    done = (k1 - k0) * drv.frames_per_step

    tr = None
    if trace:
        steps = int(cell.traffic["trace_steps"])
        tr = trace_mod.record(lambda mark: [drv.step(mark)
                                            for _ in range(steps)])
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The check, on a sample of the window's steps drawn from the seed.
    rng = np.random.default_rng(seed & (2 ** 64 - 1))
    n_check = min(int(cell.traffic["check_steps"]), k1 - k0)
    ks = sorted(rng.choice(np.arange(k0, k1), size=n_check,
                           replace=False).tolist()) if n_check else []
    tracks, steps_, served_tpl = drv.tracks(), drv.steps(ks), \
        drv.served_template()
    finite = drv.finite()
    band, frame_wh = drv.band, drv.frame_wh
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gold = Reference(ctx.fields, ctx.flat, dev)
    limits = cell.limits
    sample = SimpleNamespace(fields=ctx.fields, flat=ctx.flat, device=dev,
                             tracks=tracks, steps=steps_, frame_wh=frame_wh,
                             band=band, slack=limits.get("cell_slack"))
    tpl = check.template_errs(gold, tracks, served_tpl, band)
    judged = check.judge_steps(gold, gold, tracks, steps_, frame_wh, band,
                               sample.slack)
    readings = check.summarize(tpl, judged)
    sample.judged = dict(judged, template=tpl)
    correct = (check.verdict(readings, limits, finite) and failed == 0
               and n_check > 0)

    metrics: Dict[str, Dict[str, Any]] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        e2e = {"tracked_fps": done / window_s,
               "frame_p95_ms": float(np.percentile(lat, 95) * 1e3)
               if len(lat) else None,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        rctx = SimpleNamespace(trace=tr, fields=ctx.fields, counts=counts,
                               frames_per_step=drv.frames_per_step,
                               trace_steps=int(cell.traffic["trace_steps"]),
                               frames=done, window_s=window_s, calls_s=calls)
        for m in cell.per_layer:
            value = spec.reader(m["name"], root).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}

    out: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(attempted),
        "failed": int(failed), "metrics": metrics,
        "device": device_record(dev, cell.chips, peak)}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = trace_mod.breakdown(tr)
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                     for k in check.compared(limits)}
    out["readings"] = readings
    out["sample"] = sample
    return out


def device_record(dev: torch.device, count: int, peak: int) -> Dict[str, Any]:
    """The ``device`` field: platform, the card's name, the cards used,
    the peak memory, and nvidia-smi's power limit."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit": _power_limit()}


def _power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
