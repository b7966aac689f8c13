"""PyTorch port: the compiled entry points (``utils/graph.py``) against the
JAX package's jitted functions, and the wrapper's own contract, on the CPU.

Seeded NV12 frames go through JAX's ``core.init_jit`` / ``update_packed_jit``,
``multi.update_streams_jit`` / ``update_objects_jit``, the scan pools and
the engine tick, and through the port's compiled counterparts on the CPU
(the same static-buffer plumbing as on the card, the body called eagerly
in place of a replay).  The float32 ``small`` preset with its shipped
weights, and the flagship's widths (D=192, 3 heads, 128/256 crops) at
depth 2 in float32 from the shipped flagship's first blocks.  Tolerances
are those of ``tests/test_torch_scan.py`` and ``test_torch_multi.py``:
scores 1e-4, bbox 1e-2 px; against the port's own eager functions the
compiled ones are held bit for bit.  The scan pools run more reps than
the pool has frames, so the device index wraps.

The wrapper: a second call with the returned state makes no new trace and
copies nothing of it; a new frame of the same shape makes no new trace; an
in-place parameter update does; a state passed in from elsewhere is left
untouched, and a result handed out earlier keeps its values when another
state comes in; ``packed`` and a ``PackedTick`` held from call N keep
their values after call N+1; three slot writes trace once; the cache
stays bounded over repeated ``recover`` and new parameter sets; two meshes
in context (a one-rank gloo group in this process) give two keys, and the
same mesh the same key.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import font as jfont  # noqa: E402
from gstreamer_vit_tracker_tpu.serve import SlotEngine as JSlotEngine  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import multi as jmulti  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import scan as jscan  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import font as tfont  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import multi as tmulti  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import scan as tscan  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.utils import graph  # noqa: E402

CPU = torch.device("cpu")
H, W = 128, 160
BOX = (60.0, 40.0, 32.0, 32.0)
BOX_TOL, SCORE_TOL = 1e-2, 1e-4      # against JAX (the scan and multi tests)
HUD = ("TRACKING", 12), ("FPS: 60.0", 16), ("trk: 0.3ms", 16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs beside other workers, and
    oversubscribed thread pools spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nv12_pool(n, seed=0):
    """n NV12 frames, stacked: a bright checker target moving 2, 1 px a
    frame from BOX over a dim noisy background."""
    rng = np.random.default_rng(seed)
    ys, uvs = [], []
    x0, y0, bw, bh = (int(v) for v in BOX)
    ty, tx = np.mgrid[0:bh, 0:bw]
    tex = (190 + 50 * (((tx // 6) + (ty // 6)) % 2)).astype(np.uint8)
    for t in range(n):
        y = (70 + rng.normal(0, 5, (H, W))).clip(0, 255).astype(np.uint8)
        uv = np.full((H // 2, W // 2, 2), 128, np.uint8)
        x, yy = x0 + 2 * t, y0 + t // 2
        y[yy:yy + bh, x:x + bw] = tex
        uv[yy // 2:(yy + bh) // 2, x // 2:(x + bw) // 2] = (90, 200)
        ys.append(y)
        uvs.append(uv)
    return np.stack(ys), np.stack(uvs)


def _model(name):
    """(JAX cfg, JAX params, port cfg, port params) from the shipped
    weights: ``small``, or ``flagship2`` (vittrack-t's widths, depth 2,
    float32)."""
    if name == "small":
        jcfg, tcfg, ckpt = JAX_PRESETS["small"], PRESETS["small"], "small"
    else:
        cut = dict(depth=2, dtype="float32")
        jcfg = dataclasses.replace(JAX_PRESETS["vittrack-t"], **cut)
        tcfg = dataclasses.replace(PRESETS["vittrack-t"], **cut)
        ckpt = "vittrack-t"
    path = tweights.checkpoint_path(ckpt)
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), jcfg))
    return (jcfg, jweights.load_npz(path, like), tcfg,
            tweights.load_npz(path, tcfg, device=CPU))


@pytest.fixture(scope="module")
def small():
    return _model("small")


@pytest.fixture(scope="module")
def flagship2():
    return _model("flagship2")


def _j(frame):
    return tuple(jnp.asarray(p) for p in frame)


def _close(t, j, box_cols=4):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t[..., :box_cols], j[..., :box_cols],
                               atol=BOX_TOL, rtol=0)
    np.testing.assert_allclose(t[..., box_cols:], j[..., box_cols:],
                               atol=SCORE_TOL, rtol=0)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Against JAX's jitted functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["small", "flagship2"])
def test_core_jit_matches_jax_and_the_eager_step(model, request):
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(model)
    ys, uvs = nv12_pool(4)
    jst = jcore.init_jit(jparams, _j((ys[0], uvs[0])), jnp.asarray(BOX),
                         jcfg, "nv12")
    n0 = tcore.init_jit.traces, tcore.update_packed_jit.traces
    tst = tcore.init_jit(tparams, (ys[0], uvs[0]), BOX, tcfg, "nv12", CPU)
    est = tcore.init(tparams, (ys[0], uvs[0]), BOX, tcfg, "nv12", CPU)
    _equal(tst, est)
    for i in range(1, 4):
        jst, jp = jcore.update_packed_jit(jparams, jst, _j((ys[i], uvs[i])),
                                          jcfg, "nv12")
        tst, tp = tcore.update_packed_jit(tparams, tst, (ys[i], uvs[i]),
                                          tcfg, "nv12", CPU)
        est, ep = tcore.update_packed(tparams, est, (ys[i], uvs[i]), tcfg,
                                      "nv12", CPU)
        assert tp.shape == (5,)
        _close(tp, jp)
        assert torch.equal(tp, ep)
    _equal(tst, est)
    assert int(tst.frame_idx) == int(jst.frame_idx) == 3
    assert (tcore.init_jit.traces - n0[0],
            tcore.update_packed_jit.traces - n0[1]) == (1, 1)
    # update_jit: (state, bbox, conf), the same step.
    s, b, c = tcore.update_jit(tparams, est, (ys[1], uvs[1]), tcfg, "nv12",
                               CPU)
    _, eb, ec = tcore.update(tparams, est, (ys[1], uvs[1]), tcfg, "nv12",
                             CPU)
    assert torch.equal(b, eb) and torch.equal(c, ec)


def test_streams_jit_matches_jax(small):
    jcfg, jparams, tcfg, tparams = small
    ys, uvs = nv12_pool(5)
    bbs = np.tile(np.asarray(BOX, np.float32), (2, 2, 1))
    bbs[:, 1] += (3.0, 1.0, 0.0, 0.0)
    active = np.asarray([[True, True], [True, False]])
    idx0 = np.asarray([0, 1])
    jst = jmulti.init_streams_jit(jparams, _j((ys[idx0], uvs[idx0])),
                                  jnp.asarray(bbs), jcfg, "nv12")
    tst = tmulti.init_streams_jit(tparams, (ys[idx0], uvs[idx0]), bbs, tcfg,
                                  "nv12", CPU)
    est = tmulti.init_streams(tparams, (ys[idx0], uvs[idx0]), bbs, tcfg,
                              "nv12", CPU)
    held = [t.clone() for t in tst]
    for i in range(1, 4):
        idx = np.asarray([i, i + 1])
        jst, jb, jsc = jmulti.update_streams_jit(
            jparams, jst, _j((ys[idx], uvs[idx])), jnp.asarray(active), jcfg,
            "nv12", exclusive=True)
        tst, tb, tsc = tmulti.update_streams_jit(
            tparams, tst, (ys[idx], uvs[idx]), active, tcfg, "nv12",
            exclusive=True, device=CPU)
        est, eb, esc = tmulti.update_streams(
            tparams, est, (ys[idx], uvs[idx]), active, tcfg, "nv12",
            exclusive=True, device=CPU)
        assert tb.shape == (2, 2, 4) and tsc.shape == (2, 2)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_TOL,
                                   rtol=0)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                   atol=SCORE_TOL, rtol=0)
        assert torch.equal(tb, eb) and torch.equal(tsc, esc)
    _equal(tst, est)
    # The inactive slot kept its state bit for bit.
    for a, b in zip(held, tst):
        assert torch.equal(a[1, 1], b[1, 1])


def test_objects_jit_matches_jax(small):
    jcfg, jparams, tcfg, tparams = small
    jcfg = dataclasses.replace(jcfg, template_update_enabled=True,
                               template_update_interval=2)
    tcfg = dataclasses.replace(tcfg, template_update_enabled=True,
                               template_update_interval=2)
    ys, uvs = nv12_pool(5)
    bbs = np.stack([np.asarray(BOX, np.float32),
                    np.asarray(BOX, np.float32) + [2, 1, 0, 0],
                    np.asarray(BOX, np.float32) + [40, 30, 0, 0]])
    active = np.asarray([True, True, False])
    jst = jmulti.init_objects_jit(jparams, _j((ys[0], uvs[0])),
                                  jnp.asarray(bbs), jcfg, "nv12")
    tst = tmulti.init_objects_jit(tparams, (ys[0], uvs[0]), bbs, tcfg, "nv12",
                                  CPU)
    est = tmulti.init_objects(tparams, (ys[0], uvs[0]), bbs, tcfg, "nv12", CPU)
    for i in range(1, 5):
        jst, jb, jsc = jmulti.update_objects_jit(
            jparams, jst, _j((ys[i], uvs[i])), jnp.asarray(active), jcfg,
            "nv12", exclusive=True)
        tst, tb, tsc = tmulti.update_objects_jit(
            tparams, tst, (ys[i], uvs[i]), active, tcfg, "nv12",
            exclusive=True, device=CPU)
        est, eb, esc = tmulti.update_objects(
            tparams, est, (ys[i], uvs[i]), active, tcfg, "nv12",
            exclusive=True, device=CPU)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_TOL,
                                   rtol=0)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                   atol=SCORE_TOL, rtol=0)
        assert torch.equal(tb, eb) and torch.equal(tsc, esc)
    _equal(tst, est)
    np.testing.assert_allclose(tst.z_tok.numpy(), np.asarray(jst.z_tok),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("pool_fn", ["single", "streams", "hud"])
def test_scan_pools_wrap_and_match_jax(small, pool_fn):
    jcfg, jparams, tcfg, tparams = small
    ys, uvs = nv12_pool(3)
    reps = 7                                   # > the pool: the index wraps
    jpool = (jnp.asarray(ys), jnp.asarray(uvs))
    if pool_fn == "streams":
        idx0 = np.asarray([0, 1])
        bbs = np.tile(np.asarray(BOX, np.float32), (2, 1, 1))
        active = np.ones((2, 1), bool)
        st0 = tmulti.init_streams(tparams, (ys[idx0], uvs[idx0]), bbs, tcfg,
                                  "nv12", CPU)
        jst = jmulti.init_streams(jparams, _j((ys[idx0], uvs[idx0])),
                                  jnp.asarray(bbs), jcfg, "nv12")
        jst, jsc = jscan.update_streams_scan_pool(
            jparams, jst, jpool, jnp.asarray(active), reps, jcfg, "nv12")
        tst, tsc = tscan.update_streams_scan_pool(
            tparams, st0, (ys, uvs), active, reps, tcfg, device=CPU)
        s, want = st0, []
        for i in range(reps):
            idx = (i + np.arange(2)) % 3
            s, _, sc = tmulti.update_streams(tparams, s, (ys[idx], uvs[idx]),
                                             active, tcfg, "nv12", device=CPU)
            want.append(sc)
        assert tsc.shape == (reps, 2, 1)
    else:
        st0 = tcore.init(tparams, (ys[0], uvs[0]), BOX, tcfg, "nv12", CPU)
        jst = jcore.init(jparams, _j((ys[0], uvs[0])), jnp.asarray(BOX),
                         jcfg, "nv12")
        s, want, disp = st0, [], torch.zeros_like(torch.from_numpy(ys[0]))
        glyphs = tscan.hud_glyphs(tuple(tfont.encode_text(t, n)
                                        for t, n in HUD), CPU)
        for i in range(reps):
            f = (torch.from_numpy(ys[i % 3]), torch.from_numpy(uvs[i % 3]))
            s, b, c = tcore.update(tparams, s, f, tcfg, "nv12", CPU)
            tscan.composite_hud(disp, f[0], b, c, glyphs)
            want.append(c)
        if pool_fn == "single":
            jst, jsc = jscan.update_scan_pool(jparams, jst, jpool, reps, jcfg,
                                              "nv12")
            tst, tsc = tscan.update_scan_pool(tparams, st0, (ys, uvs), reps,
                                              tcfg, device=CPU)
        else:
            jst, jdisp, jsc = jscan.update_scan_hud_pool(
                jparams, jst, jpool, tuple(jfont.encode_text(t, n)
                                           for t, n in HUD), reps, jcfg)
            tst, tdisp, tsc = tscan.update_scan_hud_pool(
                tparams, st0, (ys, uvs), tuple(tfont.encode_text(t, n)
                                               for t, n in HUD), reps, tcfg,
                device=CPU)
            np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
            assert torch.equal(tdisp, disp)
        assert tsc.shape == (reps,)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=SCORE_TOL,
                               rtol=0)
    np.testing.assert_allclose(tst.bbox.numpy(), np.asarray(jst.bbox),
                               atol=BOX_TOL, rtol=0)
    assert torch.equal(tsc, torch.stack(want))
    _equal(tst, s)
    assert int(st0.frame_idx.max()) == 0           # the caller's state


def test_engine_tick_matches_jax(small):
    jcfg, jparams, tcfg, tparams = small
    ys, uvs = nv12_pool(5)
    slots = 3
    jeng = JSlotEngine(jparams, jcfg, slots, "nv12", snapshot_every=0)
    teng = SlotEngine(tparams, tcfg, slots, "nv12", snapshot_every=0,
                      device=CPU)
    for eng in (jeng, teng):
        for k in (0, 2):
            eng.init_slot(k, (ys[k], uvs[k]),
                          np.asarray(BOX, np.float32) + [k, 0, 0, 0])
    assert teng._write.traces == 1
    active = np.asarray([True, False, True])
    for t in range(1, 4):
        idx = (np.arange(slots) + t) % 5
        jp = np.asarray(jeng.step((ys[idx], uvs[idx]), active))
        tp = teng.step((ys[idx], uvs[idx]), active)
        assert tp.shape == (slots, 5)
        _close(tp, jp)
    assert teng._tick.traces == 1


# ---------------------------------------------------------------------------
# The wrapper's contract
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(small):
    """``small`` cut to depth 1: the contract tests need a model, not a
    good one."""
    _, _, tcfg, tparams = small
    cfg = dataclasses.replace(tcfg, depth=1)
    params = dict(tparams)
    params["backbone"] = dict(tparams["backbone"],
                              blocks=tparams["backbone"]["blocks"][:1])
    return cfg, params


def test_the_chain_copies_nothing_and_a_new_frame_does_not_retrace(tiny):
    cfg, params = tiny
    ys, uvs = nv12_pool(4)
    fn = graph.Compiled(tcore.update_packed_jit.fn, "test.chain",
                        static=("cfg", "frame_format"),
                        donate={"state": (0,)})
    st0 = tcore.init(params, (ys[0], uvs[0]), BOX, cfg, "nv12", CPU)
    s1, _ = fn(params, st0, (ys[1], uvs[1]), cfg, "nv12", CPU)
    assert fn.traces == 1 and fn.copies == 6 + 2     # the state, the frame
    s2, _ = fn(params, s1, (ys[2], uvs[2]), cfg, "nv12", CPU)
    assert fn.traces == 1 and fn.copies == 8 + 2     # the frame only
    assert all(a is b for a, b in zip(s1, s2))       # the same buffers
    s3, p3 = fn(params, s2, (torch.from_numpy(ys[3]),
                             torch.from_numpy(uvs[3])), cfg, "nv12", CPU)
    assert fn.traces == 1 and int(s3.frame_idx) == 3
    e = st0
    for i in (1, 2, 3):
        e, ep = tcore.update_packed(params, e, (ys[i], uvs[i]), cfg, "nv12",
                                    CPU)
    _equal(s3, e)
    assert torch.equal(p3, ep)
    # Another frame shape is another key.
    fn(params, s3, (ys[3][:64], uvs[3][:32]), cfg, "nv12", CPU)
    assert fn.traces == 2


def test_an_in_place_parameter_update_retraces(tiny):
    cfg, params = tiny
    params = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in params.items()}
    params["backbone"]["pos_embed_x"] = params["backbone"][
        "pos_embed_x"].clone()
    ys, uvs = nv12_pool(2)
    fn = graph.Compiled(tcore.update_packed_jit.fn, "test.version",
                        static=("cfg", "frame_format"),
                        donate={"state": (0,)})
    st0 = tcore.init(params, (ys[0], uvs[0]), BOX, cfg, "nv12", CPU)
    fn(params, st0, (ys[1], uvs[1]), cfg, "nv12", CPU)
    fn(params, st0, (ys[1], uvs[1]), cfg, "nv12", CPU)
    assert fn.traces == 1
    params["backbone"]["pos_embed_x"].mul_(1.5)      # moves _version
    _, got = fn(params, st0, (ys[1], uvs[1]), cfg, "nv12", CPU)
    assert fn.traces == 2
    _, want = tcore.update_packed(params, st0, (ys[1], uvs[1]), cfg, "nv12",
                                  CPU)
    assert torch.equal(got, want)


def test_a_state_from_elsewhere_is_left_untouched_and_results_kept(tiny):
    cfg, params = tiny
    ys, uvs = nv12_pool(3)
    a0 = tcore.init(params, (ys[0], uvs[0]), BOX, cfg, "nv12", CPU)
    b0 = tcore.init(params, (ys[1], uvs[1]), (70.0, 40.0, 30.0, 30.0), cfg,
                    "nv12", CPU)
    kept = [t.clone() for t in a0]
    a1, pa = tcore.update_packed_jit(params, a0, (ys[1], uvs[1]), cfg,
                                     "nv12", CPU)
    _equal(a0, kept)
    assert not any(x is y for x, y in zip(a0, a1))
    a1_values = [t.clone() for t in a1]
    pa_values = pa.clone()
    # Another tracker's state through the same key: a1, still held, keeps
    # its values (it is given storage of its own), as does pa.
    b1, pb = tcore.update_packed_jit(params, b0, (ys[2], uvs[2]), cfg,
                                     "nv12", CPU)
    _equal(a1, a1_values)
    assert torch.equal(pa, pa_values) and not torch.equal(pa, pb)
    _, want = tcore.update_packed(params, b0, (ys[2], uvs[2]), cfg, "nv12",
                                  CPU)
    assert torch.equal(pb, want)
    # And a1 goes on from where it was.
    a2, pa2 = tcore.update_packed_jit(params, a1, (ys[2], uvs[2]), cfg,
                                      "nv12", CPU)
    _, want = tcore.update_packed(params, tcore.TrackState(*a1_values),
                                  (ys[2], uvs[2]), cfg, "nv12", CPU)
    assert torch.equal(pa2, want)


def test_engine_ticks_held_slot_writes_and_a_bounded_cache(tiny):
    cfg, params = tiny
    ys, uvs = nv12_pool(4)
    eng = SlotEngine(params, cfg, 4, "nv12", snapshot_every=0, device=CPU)
    for k in (0, 1, 3):                      # three slots, one write graph
        eng.init_slot(eng.alloc() if k != 3 else 3, (ys[k], uvs[k]), BOX)
    assert eng._write.traces == 1
    active = np.asarray([True, True, False, True])
    tick1 = eng.step_async((ys, uvs), active)
    held = np.asarray(tick1).copy()
    tick2 = eng.step_async((ys[::-1].copy(), uvs[::-1].copy()), active)
    np.testing.assert_array_equal(np.asarray(tick1), held)
    assert not np.array_equal(np.asarray(tick2), held)
    assert eng._tick.traces == 1
    for _ in range(6):
        eng.snapshot()
        assert eng.recover() == []
        eng.step((ys, uvs), active)
    assert len(eng._tick) <= 1 and len(eng._write) == 0
    assert eng._tick.traces == 7
    # New parameter sets through one wrapper: at most `sets` keys.
    fn = graph.Compiled(tcore.init_jit.fn, "test.sets",
                        static=("cfg", "frame_format"))
    for _ in range(graph.SETS + 2):
        p = dict(params, backbone=dict(params["backbone"]))
        p["backbone"]["pos_embed_z"] = p["backbone"]["pos_embed_z"].clone()
        fn(p, (ys[0], uvs[0]), BOX, cfg, "nv12", CPU)
    assert fn.traces == graph.SETS + 2 and len(fn) <= graph.SETS


def test_a_capture_failure_raises_naming_the_entry_point_and_the_op(
        monkeypatch):
    """No eager fallback: the capture is stood in for on the CPU (CUDA's
    stream and graph objects replaced), and a body that fails only while
    it is captured makes the call raise, naming the entry point and the
    op, with the launch counters as they were."""
    capturing = []

    class Stream:
        def wait_stream(self, other):
            pass

    class Capture:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            capturing.append(True)

        def __exit__(self, *exc):
            capturing.clear()
            return False

    def body(params, x, device):
        # An op of the package that fails under capture.
        return tcore._frame_on(x, "bgr" if capturing else "rgb", device)[0]

    import contextlib

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(graph, "_side_stream", lambda dev: Stream())
    fn = graph.Compiled(body, "test.capture")
    leaves, spec = graph.flatten(torch.ones(3))
    g = fn._new(CPU, [], {"x": (leaves, spec)})
    before = graph._read_counts()
    call = {"params": {}, "x": g.tree("x"), "device": CPU}
    with pytest.raises(RuntimeError) as err:
        fn._capture(g, call)
    msg = str(err.value)
    assert msg.startswith("test.capture: the CUDA graph capture failed at")
    assert "tracker/core.py" in msg and "_frame_on" in msg
    assert "unknown frame format" in msg
    assert g.graph is None and graph._read_counts() == before


def test_a_static_buffer_keeps_its_source_layout():
    """A transposed leaf (the shipped weights hold some) is copied into a
    buffer of the same strides, so the body computes on the layout the
    eager function sees; another layout of the same shape is another
    key."""
    seen = []

    def body(x, device):
        seen.append(x.stride())
        return x @ x.t()

    fn = graph.Compiled(body, "test.layout")
    a = torch.arange(12.0).reshape(3, 4).t()          # (4, 3), strides (1, 4)
    assert torch.equal(fn(a, CPU), a @ a.t())
    assert seen == [(1, 4)] and fn.traces == 1
    fn(a.contiguous(), CPU)
    assert seen[-1] == (3, 1) and fn.traces == 2
    fn(a.clone(), CPU)                                # the first layout again
    assert seen[-1] == (1, 4) and fn.traces == 2


def test_two_meshes_give_two_keys():
    """The mesh in context is part of the key: its shape and axis names,
    this rank's coordinates and each axis group's backend and name."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from gstreamer_vit_tracker_tpu_torch.parallel import make_mesh
    from gstreamer_vit_tracker_tpu_torch.parallel.mesh import (init_group,
                                                               use_mesh)

    assert init_group("cpu") == "gloo"
    try:
        square = make_mesh((1, 1), device="cpu")
        line = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        fn = graph.Compiled(lambda x, device: x * 2, "test.mesh")
        x = torch.ones(3)
        fn(x, CPU)
        for mesh, traces in ((square, 2), (line, 3), (square, 3), (None, 3)):
            with use_mesh(mesh):
                assert torch.equal(fn(x, CPU), x * 2)
            assert fn.traces == traces
        key = graph._mesh_key(square)
        assert key[:3] == ((1, 1), ("data", "model"), (0, 0))
        assert [b for b, _name in key[3]] == ["gloo", "gloo"]
        assert graph._mesh_key(line) != key
        assert graph.compiles_under(square, CPU)
    finally:
        dist.destroy_process_group()
