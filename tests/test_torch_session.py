"""PyTorch port: the session machines and the torch tracker backends.

One command sequence, with one scripted stub backend each, drives the JAX
package's and the port's ``TrackerSession`` and ``MultiObjectSession``;
state names, boxes, scores, Lost counters and the selection must agree
frame by frame.  Then ``TorchTrackerBackend`` and
``TorchMultiTrackerBackend`` beside the JAX backends on the float32
``small`` preset (shipped weights, seeded synthetic frames): bbox 1e-2 px,
score 1e-4.  Pipelined ``update`` returns frame i-1's result at frame i,
and ``recover()`` followed by a re-init carries the track on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.config import SessionConfig as JaxSessionConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.session import commands as jcommands  # noqa: E402
from gstreamer_vit_tracker_tpu.session import machine as jmachine  # noqa: E402
from gstreamer_vit_tracker_tpu.session import multi as jmulti  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS, SessionConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media.source import SyntheticSource  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.session import commands as tcommands  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.session import machine as tmachine  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.session import multi as tmulti  # noqa: E402

CPU = torch.device("cpu")
W, H = 320, 256


# ---------------------------------------------------------------------------
# The machines, with stub backends
# ---------------------------------------------------------------------------

class StubTracker:
    """Scripted single-object backend: frame t's result is ``script(t)``,
    a (bbox, score, success) triple or an exception to raise."""

    def __init__(self, script):
        self.script, self.t = script, 0
        self.inits, self.recovers = [], 0

    def init(self, frame, bbox):
        self.inits.append(tuple(bbox))

    def update(self, frame):
        self.t += 1
        r = self.script(self.t)
        if isinstance(r, Exception):
            raise r
        return r

    def recover(self):
        self.recovers += 1


def _single_script(t):
    if t in (9, 40):
        return RuntimeError("injected device fault")
    score = 0.1 if 14 <= t < 20 or 45 <= t < 120 else 0.8 - 0.001 * t
    return (10.0 + t, 20.0 + 0.5 * t, 40.0, 30.0), score, t % 17 != 0


def _command_plan(mod):
    """Frame -> commands: move (slow and fast), confirm twice, cancel, and
    a second selection after the Lost countdown resets the session."""
    K, C = mod.Kind, mod.UserCommand
    return {0: [C(K.MOVE_LEFT), C(K.MOVE_UP, fast=True)],
            1: [C(K.CONFIRM)],
            2: [C(K.MOVE_RIGHT, fast=True), C(K.MOVE_DOWN)] * 2,
            3: [C(K.CONFIRM)],
            30: [C(K.CANCEL)],
            31: [C(K.CONFIRM)],
            32: [C(K.MOVE_RIGHT)] * 3 + [C(K.MOVE_DOWN, fast=True)],
            33: [C(K.CONFIRM), C(K.QUIT)],
            200: [C(K.CONFIRM)], 201: [C(K.MOVE_LEFT, fast=True)] * 9,
            202: [C(K.CONFIRM)]}


def _run_single(mod_machine, mod_cmds, cfg, frames=220):
    tracker = StubTracker(_single_script)
    sess = mod_machine.TrackerSession(tracker, W, H, cfg, log=lambda m: None)
    plan = _command_plan(mod_cmds)
    rows = []
    for t in range(frames):
        for cmd in plan.get(t, []):
            sess.handle_command(cmd)
        out = sess.process_frame(None)
        sel = sess.selection
        rows.append((sess.state_name(), out, sess.current_bbox,
                     sess.current_score, sess.lost.frames, sel.cursor_x,
                     sel.cursor_y, sel.start_x, sel.start_y, sel.phase.value))
    return rows, tracker.inits, tracker.recovers


def test_tracker_session_matches_jax_frame_by_frame():
    want = _run_single(jmachine, jcommands, JaxSessionConfig())
    got = _run_single(tmachine, tcommands, SessionConfig())
    for t, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, (t, g, w)
    assert got[1:] == want[1:]
    names = {r[0] for r in got[0]}
    assert {"SELECT START", "SELECT END", "TRACKING", "LOST"} <= names
    assert got[2] >= 1                       # a device fault was recovered


class StubMulti:
    """Scripted batched backend: scores from a per-slot schedule, boxes
    drifting from the init box; raises on scripted ticks."""

    def __init__(self, n):
        self.n, self.state, self.tick = n, None, 0
        self.active = np.zeros(n, bool)
        self.boxes = np.zeros((n, 4), np.float32)
        self.recovers = 0

    def _scores(self, ks):
        out = np.zeros(self.n, np.float32)
        for k in ks:
            low = (10 + 5 * k <= self.tick < 18 + 5 * k
                   or (k == 1 and 30 <= self.tick < 110))
            out[k] = 0.1 if low else 0.9 - 0.01 * k
        return out

    def init_slot(self, frame, k, bbox):
        self.state = "live"
        self.active[k] = True
        self.boxes[k] = bbox

    def deactivate(self, k):
        self.active[k] = False

    def update(self, frame):
        self.tick += 1
        if self.tick == 25:
            raise RuntimeError("injected device fault")
        self.boxes[self.active] += (1.0, 0.5, 0.0, 0.0)
        return self.boxes.copy(), self._scores(np.flatnonzero(self.active))

    def update_slot(self, frame, k):
        return self.boxes.copy(), self._scores([k])

    def recover(self):
        self.recovers += 1
        self.state = None


def _run_multi(mod_multi, mod_cmds, cfg, frames=150):
    be = StubMulti(3)
    sess = mod_multi.MultiObjectSession(be, W, H, cfg, log=lambda m: None)
    K, C = mod_cmds.Kind, mod_cmds.UserCommand
    plan = {}
    for i, t0 in enumerate((0, 4, 8, 60, 64)):
        plan[t0] = [C(K.MOVE_LEFT, fast=True)] * (i + 1) + [C(K.CONFIRM)]
        plan[t0 + 2] = [C(K.MOVE_DOWN, fast=True), C(K.CONFIRM)]
    plan[40] = [C(K.CANCEL)]
    rows = []
    for t in range(frames):
        for cmd in plan.get(t, []):
            sess.handle_command(cmd)
        try:
            sess.process_frame(None)
        except RuntimeError:            # the app's loop recovers these
            sess.force_lost()
        rows.append((sess.state_name(), list(sess.slots), list(sess.boxes),
                     list(sess.scores), list(sess.lost_counts),
                     sess.current_score, sess.current_bbox,
                     sess.tracked_boxes()))
    return rows


def test_multi_object_session_matches_jax_frame_by_frame():
    want = _run_multi(jmulti, jcommands, JaxSessionConfig())
    got = _run_multi(tmulti, tcommands, SessionConfig())
    for t, (g, w) in enumerate(zip(got, want)):
        assert g == w, (t, g, w)
    names = {r[0] for r in got}
    assert {"SELECT END 1 OF 3", "TRACKING 3 OF 3", "LOST"} <= names
    assert any("lost" in r[1] and "tracking" in r[1] for r in got)


# ---------------------------------------------------------------------------
# The torch backends against the JAX backends, small f32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_params():
    path = tweights.checkpoint_path("small")
    like = jax.eval_shape(lambda: jvittrack.init_params(
        jax.random.PRNGKey(0), JAX_PRESETS["small"]))
    return (jweights.load_npz(path, like),
            tweights.load_npz(path, PRESETS["small"], device=CPU))


def _clip(fmt, n, n_distractors=0):
    src = SyntheticSource(W, H, seed=4, fmt=fmt, n_distractors=n_distractors)
    return src, [src.frame(i) for i in range(n)]


def _close(got, want):
    (gb, gs, gok), (wb, ws, wok) = got, want
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-2)
    assert abs(gs - ws) <= 1e-4 and gok == wok


@pytest.mark.parametrize("fmt", ("rgb", "nv12"))
def test_torch_backend_matches_jax_backend(small_params, fmt):
    jparams, tparams = small_params
    src, frames = _clip(fmt, 9)
    jb = jmachine.JaxTrackerBackend(jparams, JAX_PRESETS["small"], fmt)
    tb = tmachine.TorchTrackerBackend(tparams, PRESETS["small"], fmt,
                                      device=CPU)
    with pytest.raises(RuntimeError, match="not initialised"):
        tb.update(frames[0])
    bbox = src.bbox_at(0)
    jb.init(frames[0], bbox)
    tb.init(frames[0], bbox)
    for f in frames[1:]:
        got = tb.update(f)
        _close(got, jb.update(f))
        assert isinstance(got[1], float) and len(got[0]) == 4
    assert got[1] > 0.5


def test_pipelined_update_returns_the_previous_frame(small_params):
    _, tparams = small_params
    src, frames = _clip("rgb", 8)
    plain = tmachine.TorchTrackerBackend(tparams, PRESETS["small"], device=CPU)
    piped = tmachine.TorchTrackerBackend(tparams, PRESETS["small"],
                                         pipelined=True, device=CPU)
    for b in (plain, piped):
        b.init(frames[0], src.bbox_at(0))
    direct = [plain.update(f) for f in frames[1:]]
    lagged = [piped.update(f) for f in frames[1:]]
    assert lagged[0] == direct[0]            # no previous result yet
    assert lagged[1:] == direct[:-1]
    # A re-init drops the pending result: the next update is its own.
    piped.init(frames[3], src.bbox_at(3))
    plain.init(frames[3], src.bbox_at(3))
    assert piped.update(frames[4]) == plain.update(frames[4])


def test_recover_then_reinit_continues_the_track(small_params):
    jparams, tparams = small_params
    src, frames = _clip("nv12", 10)
    jb = jmachine.JaxTrackerBackend(jparams, JAX_PRESETS["small"], "nv12")
    tb = tmachine.TorchTrackerBackend(tparams, PRESETS["small"], "nv12",
                                      device=CPU)
    before = {k: v.clone() for k, v in
              tweights.flatten(tb.params).items()}
    for b in (jb, tb):
        b.init(frames[0], src.bbox_at(0))
    for f in frames[1:5]:
        last = tb.update(f)
        _close(last, jb.update(f))
    for b in (jb, tb):
        b.recover()
    assert tb.state is None
    after = tweights.flatten(tb.params)
    assert all(torch.equal(after[k], v) and after[k] is not before[k]
               for k, v in before.items())
    with pytest.raises(RuntimeError, match="not initialised"):
        tb.update(frames[5])
    for b in (jb, tb):
        b.init(frames[5], last[0])
    for i, f in enumerate(frames[6:], 6):
        got = tb.update(f)
        _close(got, jb.update(f))
    from gstreamer_vit_tracker_tpu_torch.tracker.multi import _pairwise_iou
    iou = _pairwise_iou(torch.tensor([got[0], src.bbox_at(9)]))[0, 1]
    assert got[1] > 0.5 and float(iou) > 0.5


def test_multi_backend_matches_jax_backend(small_params):
    jparams, tparams = small_params
    src, frames = _clip("rgb", 8, n_distractors=2)
    jb = jmulti.JaxMultiTrackerBackend(jparams, JAX_PRESETS["small"], 3,
                                       exclusive=True)
    tb = tmulti.TorchMultiTrackerBackend(tparams, PRESETS["small"], 3,
                                         exclusive=True, device=CPU)
    boxes = [src.bbox_at(0)] + [src.object_bbox_at(k, 0) for k in (1, 2)]
    for b in (jb, tb):
        b.init_slot(frames[0], 0, boxes[0])
        b.init_slot(frames[0], 2, boxes[2])
    for got, want in ((tb.update_slot(frames[0], 2), jb.update_slot(frames[0], 2)),
                      (tb.update(frames[1]), jb.update(frames[1]))):
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-2)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    for b in (jb, tb):
        b.init_slot(frames[1], 1, boxes[1])
    for f in frames[2:]:
        got, want = tb.update(f), jb.update(f)
        assert got[0].shape == (3, 4) and got[1].shape == (3,)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-2)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    tb.deactivate(1)
    jb.deactivate(1)
    got, want = tb.update(frames[-1]), jb.update(frames[-1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-2)
    tb.recover()
    assert tb.state is None and not tb.active.any()
    with pytest.raises(RuntimeError, match="no slot initialised"):
        tb.update(frames[0])


# ---------------------------------------------------------------------------
# Keys, telemetry and the trace hook
# ---------------------------------------------------------------------------

def test_key_decode_table_equals_jax():
    from gstreamer_vit_tracker_tpu.app import keyboard as jkeyboard
    from gstreamer_vit_tracker_tpu_torch.app import keyboard as tkeyboard

    for b in range(256):
        j, t = jcommands.decode_key(b), tcommands.decode_key(b)
        assert (None if j is None else (j.kind.value, j.fast)) == \
            (None if t is None else (t.kind.value, t.fast)), b
    assert tkeyboard.BANNER == jkeyboard.BANNER


def test_timing_stats_and_phase_timer_equal_jax(tmp_path):
    from gstreamer_vit_tracker_tpu.utils import timing as jtiming
    from gstreamer_vit_tracker_tpu_torch.utils import profiling, timing

    j, t = jtiming.TimingStats(window=7), timing.TimingStats(window=7)
    rng = np.random.default_rng(0)
    for us in rng.uniform(1e3, 2e4, 20):
        for s in (j, t):
            s.add_interval(us)
            s.add_times(0.5 * us, 0.25 * us)
    for name in ("fps", "avg_conv_ms", "avg_track_ms", "p50_track_ms",
                 "p99_track_ms"):
        assert getattr(t, name)() == getattr(j, name)(), name
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("draw"):
            pass
    assert timer.counts == {"draw": 3} and timer.avg_ms("map") == 0.0
    assert timer.summary().startswith("draw:")
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
