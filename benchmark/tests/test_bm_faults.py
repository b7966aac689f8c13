"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have: a step that returns its state
unchanged, half the batch left out, an answer altered where it is made (a
box moved by its own size), and in a tick the last of eight slots' boxes
moved alone.  The cells run on one card, with no exchange between cards to
leave out.  And the control, the reference in float8 in the program's
place, reads apart from the program."""

import pytest
import torch

from benchmark import check, control, harness, spec

from .cells import tiny

SEED = 2 ** 31 + 21
LIVE = [w["name"] for w in spec.load()["workloads"] if "live" in w["name"]]
SERVE = [w["name"] for w in spec.load()["workloads"] if "serve" in w["name"]]


def _run(name, seconds=0.3, streams=3):
    return harness.run_cell(tiny(name, streams=streams), SEED, seconds,
                            False, device="cpu")


def _moved(rows: torch.Tensor) -> torch.Tensor:
    """The boxes of ``rows`` (..., >= 4) moved right and down by their own
    width and height."""
    out = rows.clone()
    out[..., :2] += rows[..., 2:4]
    return out


def _live_fault(monkeypatch, fault):
    from gstreamer_vit_tracker_tpu_torch.tracker import core

    real_update, real_packed = core.update, core.update_packed
    if fault == "state_unchanged":
        def update(params, state, *a, **k):
            _, bbox, conf = real_update(params, state, *a, **k)
            return state, bbox, conf
        monkeypatch.setattr(core, "update", update)
    else:
        def update_packed(*a, **k):
            state, packed = real_packed(*a, **k)
            return state, _moved(packed)
        monkeypatch.setattr(core, "update_packed", update_packed)


def _serve_fault(monkeypatch, fault):
    from gstreamer_vit_tracker_tpu_torch.tracker import multi

    real = multi.update_streams

    def update_streams(params, state, frames, active, *a, **k):
        new, bboxes, scores = real(params, state, frames, active, *a, **k)
        if fault == "state_unchanged":
            return state, bboxes, scores
        if fault == "half_batch":
            h = bboxes.shape[0] // 2
            keep = torch.arange(bboxes.shape[0]) < h
            new = type(new)(*(torch.where(
                keep.reshape(-1, *[1] * (n.dim() - 1)), n, o)
                for n, o in zip(new, state)))
            bboxes = torch.where(keep[:, None, None], bboxes, state.bbox)
            scores = torch.where(keep[:, None], scores, state.score)
            return new, bboxes, scores
        if fault == "last_slot_moved":
            last = torch.arange(bboxes.shape[0]) == bboxes.shape[0] - 1
            return new, torch.where(last[:, None, None], _moved(bboxes),
                                    bboxes), scores
        return new, _moved(bboxes), scores
    monkeypatch.setattr(multi, "update_streams", update_streams)


@pytest.mark.parametrize("name", LIVE)
@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_live_fault_fails(monkeypatch, name, fault):
    _live_fault(monkeypatch, fault)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_serve_fault_fails(monkeypatch, name, fault):
    _serve_fault(monkeypatch, fault)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_one_slot_of_eight_fails(monkeypatch, name):
    """One slot in eight served wrong on every tick is an eighth of the
    sampled steps: the worst track's reading still sees it."""
    _serve_fault(monkeypatch, "last_slot_moved")
    out = _run(name, streams=8)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", LIVE + SERVE)
def test_control_reads_apart(name):
    """At this size the float8 control reads at least three times the
    program on one of the cell's compared numbers, on the same steps (at
    the cell's own size it fails the limits: ``test_bm_card.py``).  The
    control's reading wants some tens of steps: a longer window."""
    out = _run(name, seconds=1.5)
    assert out["correct"], out["checks"]
    low, _ = control.read(out["sample"])
    c = spec.cell(spec.load(), name)
    assert any(low[k] >= 3 * out["readings"][k]
               for k in check.compared(c.limits)), (low, out["readings"])
