"""PyTorch port: the serving tier (``serve/``) on the CPU.

``SlotEngine`` against the JAX package's ``SlotEngine`` on the same seeded
NV12 frames (float32 ``small`` preset, shipped weights: bbox 1e-2 px, score
1e-4), its slot lifecycle, pipelined ticks and snapshot recovery; then a
``TrackServer`` with ``device="cpu"`` on loopback with real ``TrackClient``
sockets.  Every socket has a timeout and every wait a bound, so no test
can hang the suite.
"""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.serve import SlotEngine as JaxSlotEngine  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import (  # noqa: E402
    PackedTick, SlotEngine, TrackClient, TrackServer, TrackServiceError)
from gstreamer_vit_tracker_tpu_torch.serve import __main__ as serve_main  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker.multi import _batched_cfg  # noqa: E402

CPU = torch.device("cpu")
H, W = 128, 160
CFG = PRESETS["small"]
TIMEOUT_S = 30.0


class Stream:
    """A seeded NV12 stream: one bright checker target that moves (dx, dy)
    px a frame over a dim noisy background."""

    def __init__(self, seed, box=(60, 40, 32, 32), step=(2, 1)):
        self.seed, self.box, self.step = seed, box, step

    def bbox_at(self, t):
        x0, y0, bw, bh = self.box
        x, y = x0 + self.step[0] * t, y0 + self.step[1] * t
        return (float(x - x % 2), float(y - y % 2), float(bw), float(bh))

    def frame(self, t):
        rng = np.random.default_rng(1000 * self.seed + t)
        x, y, bw, bh = (int(v) for v in self.bbox_at(t))
        ty, tx = np.mgrid[0:bh, 0:bw]
        yp = (70 + rng.normal(0, 5, (H, W))).clip(0, 255).astype(np.uint8)
        yp[y:y + bh, x:x + bw] = 190 + 50 * (((tx // 6) + (ty // 6)) % 2)
        uv = np.full((H // 2, W // 2, 2), 128, np.uint8)
        uv[y // 2:(y + bh) // 2, x // 2:(x + bw) // 2] = (90, 200)
        return yp, uv


def iou(a, b):
    ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def _batch(streams, t, slots):
    ys = np.zeros((slots, H, W), np.uint8)
    uvs = np.zeros((slots, H // 2, W // 2, 2), np.uint8)
    for i, s in enumerate(streams):
        ys[i], uvs[i] = s.frame(t)
    return ys, uvs


@pytest.fixture(scope="module")
def params():
    return tweights.load_npz(tweights.checkpoint_path("small"), CFG, device=CPU)


def _engine(params, slots=3, **kw):
    kw.setdefault("snapshot_every", 1000)
    return SlotEngine(params, CFG, slots=slots, device=CPU, **kw)


@pytest.fixture()
def server(params):
    srv = TrackServer(_engine(params), H, W, port=0, batch_window_ms=1.0,
                      update_timeout_s=TIMEOUT_S)
    srv.start()
    yield srv
    srv.stop()


def _client(srv):
    return TrackClient(srv.host, srv.port, timeout_s=TIMEOUT_S)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def test_engine_step_matches_jax_engine(params):
    cfg_j = JAX_PRESETS["small"]
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg_j))
    jparams = jweights.load_npz(tweights.checkpoint_path("small"), like)
    jeng = JaxSlotEngine(jparams, cfg_j, slots=3, frame_format="nv12",
                         snapshot_every=0)
    teng = _engine(params, snapshot_every=0)
    streams = [Stream(1), Stream(2, box=(30, 60, 36, 28), step=(3, -1))]
    for s in streams:
        js, ts = jeng.alloc(), teng.alloc()
        assert js == ts
        jeng.init_slot(js, s.frame(0), s.bbox_at(0))
        teng.init_slot(ts, s.frame(0), s.bbox_at(0))
    active = np.asarray([True, True, True])          # slot 2 is unoccupied
    for t in range(1, 5):
        fr = _batch(streams, t, 3)
        want = jeng.step(fr, active)
        got = teng.step(fr, active)
        assert got.shape == (3, 5) and got.dtype == np.float32
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-2, rtol=0)
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[2], np.zeros(5, np.float32))
    for i, s in enumerate(streams):
        assert iou(got[i, :4], s.bbox_at(4)) > 0.6


def test_engine_inactive_slot_held_bitexact(params):
    eng = _engine(params, slots=2)
    s = Stream(1)
    eng.init_slot(eng.alloc(), s.frame(0), s.bbox_at(0))
    eng.init_slot(eng.alloc(), s.frame(0), s.bbox_at(0))
    before = [t.clone() for t in eng.state]
    packed = eng.step(_batch([s, s], 1, 2), np.array([True, False]))
    # Slot 1 saw no fresh frame: every leaf held bit for bit.
    for b, a in zip(before, eng.state):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b[1].numpy(), a[1].numpy())
        assert a.shape[:2] == (2, 1)
    assert int(eng.state.frame_idx[0, 0]) == 1
    assert packed.shape == (2, 5) and np.isfinite(packed).all()
    np.testing.assert_array_equal(packed[1, :4],
                                  np.asarray(s.bbox_at(0), np.float32))


def test_engine_alloc_exhaustion_and_reuse(params):
    eng = _engine(params, slots=2)
    s0, s1 = eng.alloc(), eng.alloc()
    assert {s0, s1} == {0, 1}
    with pytest.raises(RuntimeError, match="slots busy"):
        eng.alloc()
    eng.release(s0)
    assert eng.alloc() == s0


def test_engine_init_slot_copies_and_matches_core_init(params):
    eng = _engine(params, slots=2)
    s = Stream(3)
    frame, bbox = s.frame(0), np.asarray(s.bbox_at(0), np.float32)
    eng.init_slot(1, frame, bbox)
    want = tcore.init(params, frame, bbox, _batched_cfg(CFG), device=CPU,
                      frame_format="nv12")
    for leaf, w in zip(eng.state, want):
        np.testing.assert_array_equal(leaf[1, 0].numpy(), w.numpy())
        assert not leaf[0].any()                     # row 0 untouched
    bbox += 50.0                                     # the caller's buffer
    np.testing.assert_array_equal(eng.state.bbox[1, 0].numpy(),
                                  np.asarray(s.bbox_at(0), np.float32))
    assert eng.occupied.tolist() == [False, True]


def test_step_async_chain_matches_sync_steps(params):
    streams = [Stream(i) for i in range(2)]

    def mk():
        eng = _engine(params, slots=2, snapshot_every=0)
        for s in streams:
            eng.init_slot(eng.alloc(), s.frame(0), s.bbox_at(0))
        return eng

    frames = [_batch(streams, t, 2) for t in range(1, 5)]
    active = np.ones(2, bool)
    sync = mk()
    sync_rows = [sync.step(f, active) for f in frames]
    pipe = mk()
    ticks = [pipe.step_async(f, active) for f in frames]   # none read yet
    assert all(isinstance(t, PackedTick) for t in ticks)
    assert ticks[0].packed.shape == (2, 5)
    for a, t in zip(sync_rows, ticks):
        np.testing.assert_array_equal(a, np.asarray(t))


def test_engine_snapshot_and_recover(params):
    eng = _engine(params, slots=3)
    a, b = Stream(1), Stream(2, box=(30, 60, 36, 28))
    eng.init_slot(eng.alloc(), a.frame(0), a.bbox_at(0))   # first-init snapshot
    eng.step(_batch([a], 1, 3), np.array([True, False, False]))
    eng.snapshot()
    snap = [t.clone() for t in eng.state]
    eng.init_slot(eng.alloc(), b.frame(0), b.bbox_at(0))   # after the snapshot
    eng.step(_batch([a, b], 2, 3), np.array([True, True, False]))
    eng.params["backbone"]["norm"]["scale"].fill_(float("nan"))   # "fault"
    lost = eng.recover()
    assert lost == [1]
    assert eng.occupied.tolist() == [True, False, False]
    for s, t in zip(snap, eng.state):
        np.testing.assert_array_equal(s.numpy(), t.numpy())
    packed = eng.step(_batch([a], 2, 3), np.array([True, False, False]))
    assert np.isfinite(packed).all()                # params came back too
    assert iou(packed[0, :4], a.bbox_at(2)) > 0.6
    # Recovered state is the engine's own: a later init does not touch the
    # snapshot.
    eng.init_slot(1, b.frame(0), b.bbox_at(0))
    assert not eng._snapshot[0].bbox[1].any()


def test_engine_recover_without_snapshot_loses_everything(params):
    eng = _engine(params, slots=2)
    eng.alloc()
    assert eng.recover() == [0]
    assert not eng.occupied.any()


def test_engine_casts_the_blocks_once_and_keeps_f32_masters(params):
    import dataclasses

    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    eng = SlotEngine(params, cfg, slots=2, device=CPU)

    def dtypes(tree):
        if isinstance(tree, dict):
            return {d for v in tree.values() for d in dtypes(v)}
        if isinstance(tree, list):
            return {d for v in tree for d in dtypes(v)}
        return {tree.dtype}

    for _ in range(2):                               # as built, as recovered
        assert dtypes(eng.params["backbone"]["blocks"]) == {torch.bfloat16}
        assert dtypes(eng.params["backbone"]["norm"]) == {torch.float32}
        assert dtypes(eng.params["head"]) == {torch.float32}
        assert dtypes(eng._host_params) == {torch.float32}
        eng.recover()
    # The engine holds copies: the caller's params are not its storage.
    mine = params["backbone"]["norm"]["scale"]
    assert eng.params["backbone"]["norm"]["scale"].data_ptr() != mine.data_ptr()
    assert eng._host_params["backbone"]["norm"]["scale"].data_ptr() != mine.data_ptr()
    # One tick in bf16 runs and is finite.
    s = Stream(1)
    eng.init_slot(eng.alloc(), s.frame(0), s.bbox_at(0))
    packed = eng.step(_batch([s], 1, 2), np.array([True, False]))
    assert np.isfinite(packed).all() and eng.state.z_tok.dtype == torch.bfloat16


def test_engine_frame_formats(params):
    with pytest.raises(ValueError, match="unknown frame format"):
        SlotEngine(params, CFG, 2, frame_format="bgr", device=CPU)
    # Every format of the protocol has an engine (the trajectories are
    # held against JAX in tests/test_torch_formats.py).
    for fmt in ("rgb", "yuy2", "nv12"):
        eng = SlotEngine(params, CFG, 2, frame_format=fmt, device=CPU)
        assert eng.frame_format == fmt and eng.state.bbox.shape == (2, 1, 4)
    assert SlotEngine(params, CFG, 2, device=CPU).frame_format == "nv12"


def test_engine_needs_cuda_without_a_device(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlotEngine(params, CFG, 2)


# ---------------------------------------------------------------------------
# Server end to end
# ---------------------------------------------------------------------------

def test_hello_reports_geometry(server):
    with _client(server) as c:
        assert c.info["format"] == "nv12"
        assert (c.info["height"], c.info["width"]) == (H, W)
        assert c.info["slots"] == 3 and c.info["free"] == 3
        assert c.info["frame_nbytes"] == H * W * 3 // 2


def test_served_stream_matches_direct_tracker(server, params):
    s = Stream(3)
    cfg = _batched_cfg(CFG)
    st = tcore.init(params, s.frame(0), s.bbox_at(0), cfg, device=CPU,
                    frame_format="nv12")
    with _client(server) as c:
        c.init(s.frame(0), s.bbox_at(0))
        for t in range(1, 8):
            got_bbox, got_score = c.update(s.frame(t))
            st, want_bbox, want_score = tcore.update(
                params, st, s.frame(t), cfg, device=CPU, fused=False,
                                                     frame_format="nv12")
            # One slot of a batch of 3 against a batch of 1: float32 sums
            # in other GEMM shapes.
            np.testing.assert_allclose(got_bbox, want_bbox.numpy(), atol=1e-3)
            assert abs(got_score - float(want_score)) < 1e-5
        c.release()
    assert iou(got_bbox, s.bbox_at(7)) > 0.6


def test_two_clients_track_concurrently(server):
    results, errors = {}, []

    def run(seed, box, step):
        try:
            s = Stream(seed, box=box, step=step)
            with _client(server) as c:
                c.init(s.frame(0), s.bbox_at(0))
                ious = [iou(c.update(s.frame(t))[0], s.bbox_at(t))
                        for t in range(1, 13)]
                results[seed] = float(np.mean(ious))
                c.release()
        except Exception as e:      # noqa: BLE001 - reported by the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(5, (60, 40, 32, 32), (2, 1))),
               threading.Thread(target=run, args=(9, (30, 60, 36, 28), (3, -1)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S * 2)
    assert not errors and set(results) == {5, 9}, (errors, results)
    for seed, mean_iou in results.items():
        assert mean_iou > 0.6, f"seed {seed}: mean IoU {mean_iou:.3f}"
    with _client(server) as c:
        stats = c.stats()
    assert stats["ticks"] >= 12 and stats["faults"] == 0
    assert stats["active"] == 0


def test_slot_exhaustion_then_release_reuse(server):
    s = Stream(1)
    f0, b0 = s.frame(0), s.bbox_at(0)
    clients = [_client(server) for _ in range(3)]
    try:
        for c in clients:
            c.init(f0, b0)
        with _client(server) as extra:
            with pytest.raises(TrackServiceError, match="slots busy"):
                extra.init(f0, b0)
            clients[0].release()
            assert extra.init(f0, b0) in range(3)
    finally:
        for c in clients:
            c.close()


def test_disconnect_frees_slots(server):
    s = Stream(1)
    c = _client(server)
    c.init(s.frame(0), s.bbox_at(0))
    c.close()
    for _ in range(100):       # the handler releases on disconnect; poll
        with _client(server) as probe:
            if probe.info["free"] == 3:
                return
        time.sleep(0.05)
    pytest.fail("slot not freed after client disconnect")


def test_malformed_header_closes_that_connection_only(server):
    bad = socket.create_connection((server.host, server.port), timeout=10)
    try:
        bad.sendall(b"\xff\xff\xff\xff" + b"junk")
        try:
            assert bad.recv(1) == b""       # closed: EOF, or RST
        except ConnectionResetError:
            pass
    finally:
        bad.close()
    s = Stream(1)
    with _client(server) as c:              # others are still served
        c.init(s.frame(0), s.bbox_at(0))
        bbox, score = c.update(s.frame(1))
        assert np.isfinite(bbox).all() and np.isfinite(score)
        c.release()


def test_bad_requests_get_structured_errors(server):
    s = Stream(1)
    with _client(server) as c:
        with pytest.raises(TrackServiceError, match="init first"):
            c.update(s.frame(0))
        with pytest.raises(TrackServiceError, match="bad bbox"):
            c.init(s.frame(0), (10, 10, 0, 5))
        with pytest.raises(TrackServiceError, match="payload"):
            c._rpc({"op": "init", "bbox": [1, 1, 8, 8]}, b"\0" * 10)
        with pytest.raises(TrackServiceError, match="not owned"):
            c._rpc({"op": "update", "slot": 2}, b"")
        with pytest.raises(TrackServiceError, match="unknown op"):
            c._rpc({"op": "dance"})
        assert c.info["free"] == 3
        c.init(s.frame(0), s.bbox_at(0))    # the connection still works
        c.release()


def test_pipelined_server_results_match_depth1(params):
    s = Stream(11)
    trajs = []
    for depth in (1, 3):
        srv = TrackServer(_engine(params, slots=2), H, W, port=0,
                          batch_window_ms=0.5, pipeline_depth=depth,
                          update_timeout_s=TIMEOUT_S)
        srv.start()
        try:
            with _client(srv) as c:
                c.init(s.frame(0), s.bbox_at(0))
                trajs.append(np.asarray(
                    [np.append(*c.update(s.frame(t))) for t in range(1, 7)]))
        finally:
            srv.stop()
    np.testing.assert_array_equal(trajs[0], trajs[1])


# ---------------------------------------------------------------------------
# Fault recovery through the server
# ---------------------------------------------------------------------------

def _inject_one_fault(engine):
    real_step = engine.step_async
    fired = {"n": 0}

    def step_async(frames, active):
        if fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("injected device fault")
        return real_step(frames, active)

    engine.step_async = step_async


def test_fault_recovers_snapshotted_slot(server):
    s = Stream(7)
    with _client(server) as c:
        c.init(s.frame(0), s.bbox_at(0))    # first-init snapshot
        c.update(s.frame(1))
        _inject_one_fault(server.engine)
        with pytest.raises(TrackServiceError, match="device fault") as ei:
            c.update(s.frame(2))
        assert not ei.value.reinit          # the slot was in the snapshot
        for t in range(3, 9):
            bbox, score = c.update(s.frame(t))
        assert np.isfinite(score) and iou(bbox, s.bbox_at(8)) > 0.5
        assert c.stats()["faults"] == 1


def test_fault_marks_unsnapshotted_slot_for_reinit(server):
    sa, sb = Stream(7), Stream(8, box=(30, 60, 36, 28))
    with _client(server) as ca, _client(server) as cb:
        ca.init(sa.frame(0), sa.bbox_at(0))     # the snapshot covers A
        cb.init(sb.frame(0), sb.bbox_at(0))     # ...but not B
        _inject_one_fault(server.engine)
        with pytest.raises(TrackServiceError):
            cb.update(sb.frame(1))
        with pytest.raises(TrackServiceError) as ei:
            cb.update(sb.frame(1))
        assert ei.value.reinit
        cb.init(sb.frame(1), sb.bbox_at(1))
        bbox, _ = cb.update(sb.frame(2))
        assert iou(bbox, sb.bbox_at(2)) > 0.5
        bbox_a, _ = ca.update(sa.frame(1))      # A survived throughout
        assert iou(bbox_a, sa.bbox_at(1)) > 0.5


def test_pipelined_fetch_fault_recovers(server):
    s = Stream(13)
    real = server.engine.step_async
    fired = {"n": 0}

    class _PoisonFetch:
        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("injected fetch-time fault")

    def step_async(frames, active):
        if fired["n"] == 0:
            fired["n"] = 1
            real(frames, active)        # the state advances like a real tick
            return _PoisonFetch()
        return real(frames, active)

    server.engine.step_async = step_async
    with _client(server) as c:
        c.init(s.frame(0), s.bbox_at(0))
        with pytest.raises(TrackServiceError, match="device fault"):
            c.update(s.frame(1))
        for t in range(2, 8):
            bbox, score = c.update(s.frame(t))
        assert np.isfinite(score) and iou(bbox, s.bbox_at(7)) > 0.5


def test_serve_cli_rejects_an_unknown_model(capsys):
    assert serve_main.main(["--model", "nope", "--cpu"]) == 2
    assert "unknown model" in capsys.readouterr().err


def test_serve_cli_runs_corr_tiny(monkeypatch):
    """``--model corr-tiny`` has no shipped checkpoint: the server starts on
    seeded weights (``init_params``), as JAX's does, and serves a stream."""
    started = []

    def start_only(self):           # serve_forever without the wait loop
        self.start()
        started.append(self)

    monkeypatch.setattr(TrackServer, "serve_forever", start_only)
    assert serve_main.main(["--model", "corr-tiny", "--cpu", "--slots", "2",
                            "--width", str(W), "--height", str(H),
                            "--port", "0", "--format", "nv12"]) == 0
    (srv,) = started
    try:
        s = Stream(7)
        with _client(srv) as c:
            assert c.info["slots"] == 2
            c.init(s.frame(0), s.bbox_at(0))
            for t in range(1, 6):
                bbox, score = c.update(s.frame(t))
        assert np.isfinite(bbox).all() and np.isfinite(score)
        assert iou(bbox, s.bbox_at(5)) > 0.5
    finally:
        srv.stop()
