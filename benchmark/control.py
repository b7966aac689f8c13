"""The control, and the readings a cell's limits are set from, in one
process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \
        [--seconds 2] [--out FILE]

For each seed: one run of the cell with a short window at the cell's own
load, the program's readings (what the correctness check compares), and,
on the same sampled steps, the control's: the float8 reference in the
program's place (``benchmark/reference/tracker.py``).  Prints a JSON line
a seed and, last, the lower reading (the largest of the program's) and the
upper one (the smallest of the control's) of each number.  The
benchmark's own runs never run the control.  Needs a card, as
``benchmark.run`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import check, run
from benchmark.reference.tracker import Reference


def read(sample: SimpleNamespace) -> Tuple[Dict[str, float],
                                           Dict[str, np.ndarray]]:
    """The control's numbers on the steps of a run's ``sample`` (what
    ``harness.run_cell`` returns under ``sample``), and its per-step
    readings."""
    dev, band = sample.device, sample.band
    gold = Reference(sample.fields, sample.flat, dev)
    low = Reference(sample.fields, sample.flat, dev, precision="float8")
    served = torch.stack([
        low.template(t.y[None].to(dev), t.uv[None].to(dev),
                     torch.tensor([t.box], dtype=torch.float32, device=dev),
                     band)[0]
        for t in sample.tracks])
    tpl = check.template_errs(gold, sample.tracks, served, band)
    judged = check.judge_steps(
        low, gold, sample.tracks, [s._replace(row=None) for s in sample.steps],
        sample.frame_wh, band, sample.slack)
    return check.summarize(tpl, judged), dict(judged, template=tpl)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    run._caches()
    from benchmark import harness, spec

    cell = spec.cell(spec.load(run.ROOT), args.workload, run.ROOT)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 1
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False,
                               root=run.ROOT)
        control, judged = read(out["sample"])
        row = {"seed": seed, "program": out["readings"], "control": control,
               "correct": out["correct"], "metrics": out["metrics"],
               "device": out["device"]}
        rows.append(dict(row, samples={
            side: {k: v.tolist() for k, v in d.items()}
            for side, d in (("program", out["sample"].judged),
                            ("control", judged))}))
        print(json.dumps(row), flush=True)
    names = [k for k in check.NAMES if k in rows[0]["program"]]
    summary = {"workload": cell.name,
               "lower": {k: max(r["program"][k] for r in rows)
                         for k in names},
               "upper": {k: min(r["control"][k] for r in rows)
                         for k in names}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
