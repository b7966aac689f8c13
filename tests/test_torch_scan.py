"""PyTorch port: ``tracker/scan.py`` against per-step loops and against the
JAX package's scanned programs, on the CPU.

The float32 ``small`` preset with its shipped weights on seeded NV12
frames.  Against the port's own loop a scan is the same calls in the same
order, so it is held exactly; against JAX: scores 1e-4, bbox 1e-2 px.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import scan as jscan  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker.state import TrackState as JTrackState  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import multi as tmulti  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import scan as tscan  # noqa: E402

CPU = torch.device("cpu")
H, W = 128, 160
BOX = (60.0, 40.0, 32.0, 32.0)


def nv12_pool(n, seed=0):
    """n NV12 frames, stacked, of one bright checker target moving 2, 1 px
    a frame from BOX over a dim noisy background."""
    rng = np.random.default_rng(seed)
    ys, uvs = [], []
    x0, y0, bw, bh = (int(v) for v in BOX)
    ty, tx = np.mgrid[0:bh, 0:bw]
    tex = (190 + 50 * (((tx // 6) + (ty // 6)) % 2)).astype(np.uint8)
    for t in range(n):
        y = (70 + rng.normal(0, 5, (H, W))).clip(0, 255).astype(np.uint8)
        uv = np.full((H // 2, W // 2, 2), 128, np.uint8)
        x, yy = x0 + 2 * t, y0 + 2 * (t // 2)
        y[yy:yy + bh, x:x + bw] = tex
        uv[yy // 2:(yy + bh) // 2, x // 2:(x + bw) // 2] = (90, 200)
        ys.append(y)
        uvs.append(uv)
    return np.stack(ys), np.stack(uvs)


@pytest.fixture(scope="module")
def small():
    cfg_j, cfg_t = JAX_PRESETS["small"], PRESETS["small"]
    path = tweights.checkpoint_path("small")
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg_j))
    return (cfg_j, jweights.load_npz(path, like),
            cfg_t, tweights.load_npz(path, cfg_t, device=CPU))


def _jstate(tstate):
    return JTrackState(*map(jnp.asarray, tweights.state_to_numpy(tstate)))


def test_update_scan_equals_a_loop_of_update(small):
    _, _, cfg, params = small
    ys, uvs = nv12_pool(7)
    st0 = tcore.init(params, (ys[0], uvs[0]), BOX, cfg, device=CPU,
                     frame_format="nv12")
    st, boxes, scores = [], [], []
    s = st0
    for i in range(1, 7):
        s, b, c = tcore.update(params, s, (ys[i], uvs[i]), cfg, device=CPU,
                               frame_format="nv12")
        boxes.append(b.numpy())
        scores.append(float(c))
    s2, b2, c2 = tscan.update_scan(params, st0, (ys[1:], uvs[1:]), cfg,
                                   device=CPU, frame_format="nv12")
    assert b2.shape == (6, 4) and c2.shape == (6,)
    np.testing.assert_array_equal(b2.numpy(), np.stack(boxes))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(scores, np.float32))
    for a, b in zip(s, s2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(s2.frame_idx) == 6 and int(st0.frame_idx) == 0
    assert min(scores) > 0.25


def test_update_scan_matches_jax(small):
    cfg_j, jparams, cfg_t, tparams = small
    ys, uvs = nv12_pool(6)
    st0 = tcore.init(tparams, (ys[0], uvs[0]), BOX, cfg_t, device=CPU,
                     frame_format="nv12")
    jst, jb, jc = jscan.update_scan(
        jparams, _jstate(st0), (jnp.asarray(ys[1:]), jnp.asarray(uvs[1:])),
        cfg_j, "nv12")
    tst, tb, tc = tscan.update_scan(tparams, st0, (ys[1:], uvs[1:]), cfg_t,
                                    device=CPU, frame_format="nv12")
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tst.bbox.numpy(), np.asarray(jst.bbox),
                               atol=1e-2, rtol=0)
    assert int(tst.lost_frames) == int(jst.lost_frames)


def test_update_scan_pool_cycles_the_pool(small):
    cfg_j, jparams, cfg_t, tparams = small
    ys, uvs = nv12_pool(3)
    st0 = tcore.init(tparams, (ys[0], uvs[0]), BOX, cfg_t, device=CPU,
                     frame_format="nv12")
    tst, tc = tscan.update_scan_pool(tparams, st0, (ys, uvs), 7, cfg_t,
                                     device=CPU)
    assert tc.shape == (7,) and int(tst.frame_idx) == 7
    s, want = st0, []
    for i in range(7):
        s, _, c = tcore.update(tparams, s, (ys[i % 3], uvs[i % 3]), cfg_t,
                               device=CPU, frame_format="nv12")
        want.append(float(c))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(want, np.float32))
    jst, jc = jscan.update_scan_pool(
        jparams, _jstate(st0), (jnp.asarray(ys), jnp.asarray(uvs)), 7, cfg_j,
        "nv12")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    # fused_prep routes every step through nv12_search_tokens (on the CPU
    # its plain version): the same scores as the unfused chain, float32.
    _, fc = tscan.update_scan_pool(tparams, st0, (ys, uvs), 7, cfg_t,
                                   fused_prep=True, device=CPU)
    np.testing.assert_allclose(fc.numpy(), tc.numpy(), atol=1e-4, rtol=0)
    jst, jfc = jscan.update_scan_pool(
        jparams, _jstate(st0), (jnp.asarray(ys), jnp.asarray(uvs)), 7, cfg_j,
        "nv12", fused_prep=True)
    np.testing.assert_allclose(fc.numpy(), np.asarray(jfc), atol=1e-4, rtol=0)


@pytest.mark.parametrize("pool,streams", [(3, 2), (2, 5)])
def test_streams_scan_pool_matches_loop_and_jax(small, pool, streams):
    # (2, 5): more streams than pool frames, the cyclic extension must
    # still give stream s frame (i + s) % P.
    cfg_j, jparams, cfg_t, tparams = small
    ys, uvs = nv12_pool(pool)
    idx0 = np.arange(streams) % pool
    bbs = np.tile(np.asarray(BOX, np.float32), (streams, 1, 1))
    active = np.ones((streams, 1), bool)
    active[-1, 0] = False
    st0 = tmulti.init_streams(tparams, (ys[idx0], uvs[idx0]), bbs, cfg_t,
                              device=CPU, frame_format="nv12")
    reps = 4
    s, want = st0, []
    for i in range(reps):
        idx = np.asarray([(i + k) % pool for k in range(streams)])
        s, _, sc = tmulti.update_streams(tparams, s, (ys[idx], uvs[idx]),
                                         active, cfg_t, device=CPU,
                                         frame_format="nv12")
        want.append(sc.numpy())
    tst, tsc = tscan.update_streams_scan_pool(tparams, st0, (ys, uvs), active,
                                              reps, cfg_t, device=CPU)
    assert tsc.shape == (reps, streams, 1)
    np.testing.assert_array_equal(tsc.numpy(), np.stack(want))
    for a, b in zip(s, tst):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jst, jsc = jscan.update_streams_scan_pool(
        jparams, _jstate(st0), (jnp.asarray(ys), jnp.asarray(uvs)),
        jnp.asarray(active), reps, cfg_j, "nv12")
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tst.bbox.numpy(), np.asarray(jst.bbox),
                               atol=1e-2, rtol=0)
    # The inactive stream's state did not move.
    for a, b in zip(st0, tst):
        np.testing.assert_array_equal(a[-1].numpy(), b[-1].numpy())


def test_objects_scan_pool_matches_jax(small):
    cfg_j, jparams, cfg_t, tparams = small
    ys, uvs = nv12_pool(3)
    bb0 = np.asarray(BOX, np.float32)
    bbs = np.stack([bb0, bb0 + [4, 2, 0, 0]])
    active = np.ones(2, bool)
    st0 = tmulti.init_objects(tparams, (ys[0], uvs[0]), bbs, cfg_t, device=CPU,
                              frame_format="nv12")
    tst, tsc = tscan.update_objects_scan_pool(tparams, st0, (ys, uvs), active,
                                              5, cfg_t, device=CPU)
    assert tsc.shape == (5, 2) and np.isfinite(tsc.numpy()).all()
    assert tst.frame_idx.tolist() == [5, 5]
    jst, jsc = jscan.update_objects_scan_pool(
        jparams, _jstate(st0), (jnp.asarray(ys), jnp.asarray(uvs)),
        jnp.asarray(active), 5, cfg_j, "nv12")
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-4, rtol=0)


def test_reinit_after_a_scan_keeps_caller_buffers(small):
    # JAX donates the scanned state; the port returns new tensors.  Either
    # way the caller's frames and boxes must survive a scan and a re-init.
    _, _, cfg_t, tparams = small
    ys, uvs = nv12_pool(2)
    bbs = torch.from_numpy(np.tile(np.asarray(BOX, np.float32), (2, 1, 1)))
    keep = bbs.clone()
    pool = (torch.from_numpy(ys), torch.from_numpy(uvs))
    active = np.ones((2, 1), bool)
    st = tmulti.init_streams(tparams, pool, bbs, cfg_t, device=CPU,
                             frame_format="nv12")
    st, _ = tscan.update_streams_scan_pool(tparams, st, pool, active, 2, cfg_t,
                                           device=CPU)
    assert torch.equal(bbs, keep)
    np.testing.assert_array_equal(pool[0].numpy(), ys)
    st2 = tmulti.init_streams(tparams, pool, bbs, cfg_t, device=CPU,
                              frame_format="nv12")
    np.testing.assert_array_equal(st2.bbox.numpy(), keep.numpy())
