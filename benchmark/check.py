"""The comparison that decides a run's ``correct``.

A run's timed path hands back, for every frame, the packed row [x, y, w, h,
score] it served, and keeps its template tokens in its state.  The
reference cannot run free beside it: two correct trackers in different
precisions drift apart over a clip.  So it follows the program step by
step: a sampled step starts from the box the program served for the frame
before it (its init box for the first), with the low-confidence count that
the served scores give, on the same frame, with template tokens the
reference makes itself from the clip's first frame and the init box.  The
served rows chain the steps, so a program that does not carry its state
from one step to the next serves rows the reference does not give.

Numbers compared:

* ``template_err``: the template tokens the program keeps against the
  reference's, |difference| over |reference| (norms over all tokens),
  the largest over the tracks (the start: crop, resample, embed);
* ``conf_err``: over the sampled steps, the ``quantile(S)`` of |served
  score - the reference's best penalised score| (the best is a max, so it
  moves smoothly with the maps even where the peak changes cells);
* ``box_err_px``: the ``quantile(S)`` over the sampled steps of the
  distance (larger coordinate, in pixels of the search crop) from the
  served box's centre to the nearest centre of a box that a cell gives in
  the reference, among the cells whose penalised score there lies within
  ``cell_slack`` (a constant of the cell's limits, above any one step's
  score error of a sound run) of the served score.  A correct program's
  own peak is such a cell, so near-ties between cells cost nothing, while
  a box no cell near the served score gives counts its distance (without
  a cell at all, the step reads the crop's side).  The centre carries the
  offset map, the window, the decode and the box rules; the size map
  moves it only through the clamp to the frame, so a size error alone is
  for a later number.  The reference's boxes take their score-gated rules
  (the freezes) at the reference's own best score, so a box served under
  a wrong gate counts.

``quantile(S)``, for S tracks sampled alike, is the upper quartile for
one track and the 1 - 1 / (2 S) quantile for more: a reading at or under
its limit says that at most a quarter of one track's steps, or of S
tracks' steps at most as many as half of one track's, lie above the
limit.  So a fault on the last slot of a tick of sixteen lifts the
reading, as a fault on every step does.  Such a quantile over some
hundreds of steps, and norms over all tokens, are steady from seed to
seed where the largest single gap is not: it sits on the rare step whose
score is mid-range, and moves with the seed more than with the
precision; a mean moves with the share of a run spent with the target
lost, where every score is mid-range; and the largest over the tracks of
each track's upper quartile moves with the one track that is lost.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .reference.tracker import Reference

NAMES = ("template_err", "conf_err", "box_err_px")


class Track(NamedTuple):
    """One tracked target: its first frame's planes (H, W) / (H/2, W/2, 2)
    and the box it was started on."""

    y: torch.Tensor
    uv: torch.Tensor
    box: Sequence[float]


class Step(NamedTuple):
    """One sampled update: its track, its frame, the box it started from,
    its low-confidence count before it, and the row it served."""

    track: int
    y: torch.Tensor
    uv: torch.Tensor
    prev: Sequence[float]
    lost: int
    row: Sequence[float]


def lost_counts(scores: np.ndarray, threshold: float) -> np.ndarray:
    """Low-confidence count before each step, from the served scores
    (T,) of one track: 0 after a score above ``threshold``, else one more."""
    out = np.zeros(len(scores), np.int64)
    n = 0
    for i, s in enumerate(scores):
        out[i] = n
        n = 0 if s > threshold else n + 1
    return out


def template_errs(ref: Reference, tracks: List[Track],
                  served: torch.Tensor, band: Optional[int]) -> np.ndarray:
    """Per track: |served - reference| / |reference| over its tokens."""
    dev = ref.dev
    out = []
    for i, t in enumerate(tracks):
        z = ref.template(t.y[None].to(dev), t.uv[None].to(dev),
                         torch.tensor([t.box], dtype=torch.float32,
                                      device=dev), band)[0]
        s = served[i].to(dev, torch.float32)
        out.append(float(torch.linalg.vector_norm(s - z)
                         / torch.linalg.vector_norm(z)))
    return np.asarray(out)


def judge_steps(ref: Reference, gold: Reference, tracks: List[Track],
                steps: List[Step], frame_wh, band: Optional[int],
                slack: Optional[float], block: int = 32
                ) -> Dict[str, np.ndarray]:
    """Per step against ``gold``, the float32 reference: ``track``,
    ``conf`` (the served score's gap to the reference's best) and, with a
    ``slack``, ``box`` (the distance to the nearest box centre of a cell
    within ``slack`` of the served score), each an array over ``steps``.
    Where the rows are ``None``, ``ref`` (the control, a reference put in
    the program's place) serves them: its own peak's box at its own
    score."""
    dev = gold.dev
    search = float(gold.f["search_size"])

    def templates(model):
        return [model.template(t.y[None].to(dev), t.uv[None].to(dev),
                               torch.tensor([t.box], dtype=torch.float32,
                                            device=dev), band)[0]
                for t in tracks]

    zs = templates(gold)
    zr = zs if ref is gold else templates(ref)
    out = {"conf": []}
    if slack is not None:
        out["box"] = []
    for b0 in range(0, len(steps), block):
        part = steps[b0:b0 + block]
        y = torch.stack([s.y for s in part]).to(dev)
        uv = torch.stack([s.uv for s in part]).to(dev)
        prev = torch.tensor([list(s.prev) for s in part], dtype=torch.float32,
                            device=dev)
        lost = torch.tensor([s.lost for s in part], device=dev)
        maps = gold.step(y, uv, prev, lost,
                         torch.stack([zs[s.track] for s in part]), band)
        if part[0].row is None:
            own = ref.step(y, uv, prev, lost,
                           torch.stack([zr[s.track] for s in part]), band)
            conf, cell = own.penalised.max(-1)
            boxes = ref.cell_boxes(own, prev, conf, frame_wh)
            served = boxes[torch.arange(len(part), device=dev), cell]
        else:
            rows = torch.tensor([list(s.row) for s in part],
                                dtype=torch.float32, device=dev)
            served, conf = rows[:, :4], rows[:, 4]
        best = maps.penalised.max(-1).values
        out["conf"].append((conf - best).abs().cpu())
        if slack is None:
            continue
        cand = gold.cell_boxes(maps, prev, best, frame_wh)
        centre = cand[..., :2] + 0.5 * cand[..., 2:]
        served_c = served[:, None, :2] + 0.5 * served[:, None, 2:]
        dist = (centre - served_c).abs().amax(-1) \
            / maps.window.size[:, None] * search                  # (N, C)
        near = maps.penalised >= (conf - slack)[:, None]
        d = torch.where(near, dist, torch.full_like(dist, search))
        out["box"].append(d.min(-1).values.cpu())
    judged = {k: torch.cat(v).numpy() if v else np.zeros(0)
              for k, v in out.items()}
    judged["track"] = np.asarray([s.track for s in steps], np.int64)
    return judged


def quantile(tracks: int) -> float:
    """The percentile a per-step number is read at, for ``tracks`` tracks
    sampled alike (see the module's docstring)."""
    return max(75.0, 100.0 * (1.0 - 1.0 / (2 * tracks)))


def summarize(templates: np.ndarray, steps: Dict[str, np.ndarray]
              ) -> Dict[str, float]:
    """The numbers, from the per-track and per-step readings
    (``box_err_px`` where the steps were judged with a slack; NaN, which
    no limit passes, without a step)."""
    q = quantile(len(np.unique(steps["track"])))

    def read(values):
        return float(np.percentile(values, q)) if len(values) else \
            float("nan")

    out = {"template_err": float(templates.max()),
           "conf_err": read(steps["conf"])}
    if "box" in steps:
        out["box_err_px"] = read(steps["box"])
    return out


def compared(limits: Dict[str, float]) -> List[str]:
    """The numbers a cell compares: those its limits file gives a limit
    (a number whose control reading does not stand three times clear of
    the program's has none)."""
    return [k for k in NAMES if k in limits]


def verdict(readings: Dict[str, float], limits: Dict[str, float],
            finite: bool) -> bool:
    """Correct when every served number is finite and every compared
    reading is at or under its limit."""
    return finite and all(readings[k] <= limits[k] for k in compared(limits))
