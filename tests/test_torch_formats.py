"""PyTorch port: RGB and YUY2 frames and the patch-major route against the
JAX package on the CPU.

Seeded numpy frames go to both sides.  ``preprocess_rgb`` /
``preprocess_yuy2`` (banded and band-less, batched) and their
``patch_major`` form: atol 1e-4 in float32, 0.05 in bf16 on the normalised
crop; ``embed_search_patches`` 1e-5; ``update(fused_embed=True)``, and RGB
and YUY2 through ``core``, ``multi``, ``update_scan`` and a
``SlotEngine(device="cpu")`` on the float32 ``small`` preset: bbox within
1e-2 px, score within 1e-4 per frame.  The defaults of the entry points
are held equal to the JAX package's by signature.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.media.source import rgb_to_yuy2  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vit as jvit  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import preprocess as jpp  # noqa: E402
from gstreamer_vit_tracker_tpu.serve.engine import SlotEngine as JaxSlotEngine  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import multi as jmulti  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import scan as jscan  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker.state import TrackState as JaxTrackState  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit as tvit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack as tvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import TrackClient, TrackServer  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import engine as tengine  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import multi as tmulti  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import scan as tscan  # noqa: E402

CPU = torch.device("cpu")
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}
JPREP = {"rgb": jpp.preprocess_rgb, "yuy2": jpp.preprocess_yuy2}
TPREP = {"rgb": tpp.preprocess_rgb, "yuy2": tpp.preprocess_yuy2}
H, W = 160, 224


def _frame(fmt, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    if fmt == "rgb":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return rng.integers(0, 256, (h, w * 2), dtype=np.uint8)


def _windows(bbox, factor=4.0):
    return (jpp.crop_window(jnp.asarray(bbox, jnp.float32), factor),
            tpp.crop_window(torch.tensor(bbox, dtype=torch.float32), factor))


# ---------------------------------------------------------------------------
# Preprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("band", [None, 96])
@pytest.mark.parametrize("fmt", ["rgb", "yuy2"])
@pytest.mark.parametrize("bbox", [[90.0, 60.0, 30.0, 24.0],
                                  [200.0, 140.0, 28.0, 30.0]])   # over the edge
def test_preprocess_matches_jax(fmt, band, dtype, bbox):
    jdt, tdt, tol = DTYPES[dtype]
    frame = _frame(fmt, 3)
    jw, tw = _windows(bbox)
    want = JPREP[fmt](jnp.asarray(frame), jw, 64, MEAN, STD, dtype=jdt,
                      band=band)
    got = TPREP[fmt](torch.from_numpy(frame), tw, 64, MEAN, STD, dtype=tdt,
                     band=band)
    assert got.shape == (64, 64, 3) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("fmt", ["rgb", "yuy2", "nv12"])
@pytest.mark.parametrize("band", [None, 96])
def test_patch_major_matches_jax_and_the_raster_crop(fmt, band):
    jw, tw = _windows([90.0, 60.0, 30.0, 24.0])
    if fmt == "nv12":
        rng = np.random.default_rng(4)
        frame = (rng.integers(0, 256, (H, W), dtype=np.uint8),
                 rng.integers(0, 256, (H // 2, W // 2, 2), dtype=np.uint8))
        jf, tf = tuple(map(jnp.asarray, frame)), tuple(map(torch.from_numpy, frame))
        jprep, tprep = jpp.preprocess_nv12, tpp.preprocess_nv12
    else:
        frame = _frame(fmt, 4)
        jf, tf = (jnp.asarray(frame),), (torch.from_numpy(frame),)
        jprep, tprep = JPREP[fmt], TPREP[fmt]
    want = jprep(*jf, jw, 64, MEAN, STD, band=band, patch_major=16)
    got = tprep(*tf, tw, 64, MEAN, STD, band=band, patch_major=16)
    assert got.shape == (16, 16, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # The same values as the raster crop, regrouped (p, (gh, gw), (q, c)).
    crop = tprep(*tf, tw, 64, MEAN, STD, band=band)
    regrouped = crop.reshape(4, 16, 4, 16, 3).permute(1, 0, 2, 3, 4).reshape(
        16, 16, 48)
    np.testing.assert_allclose(got.numpy(), regrouped.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fmt", ["rgb", "yuy2"])
def test_preprocess_batched_shares_the_frame(fmt):
    """(S, M) windows on (S,) frames = each window on its stream's frame."""
    frames = np.stack([_frame(fmt, 5), _frame(fmt, 6)])
    boxes = torch.tensor([[[90.0, 60.0, 30.0, 24.0], [20.0, 30.0, 40.0, 20.0]],
                          [[120.0, 80.0, 26.0, 26.0], [60.0, 10.0, 30.0, 36.0]]])
    win = tpp.crop_window(boxes, 4.0)
    got = TPREP[fmt](torch.from_numpy(frames), win, 32, MEAN, STD)
    assert got.shape == (2, 2, 32, 32, 3)
    pm = TPREP[fmt](torch.from_numpy(frames), win, 32, MEAN, STD, patch_major=16)
    assert pm.shape == (2, 2, 16, 4, 48)
    for s in range(2):
        for m in range(2):
            one = tpp.crop_window(boxes[s, m], 4.0)
            want = TPREP[fmt](torch.from_numpy(frames[s]), one, 32, MEAN, STD)
            np.testing.assert_allclose(got[s, m].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="frame batch"):
        TPREP[fmt](torch.from_numpy(frames[:1]), win, 32, MEAN, STD)
    with pytest.raises(ValueError, match="band"):
        TPREP[fmt](torch.from_numpy(frames), win, 32, MEAN, STD, band=64)


# ---------------------------------------------------------------------------
# The model side of the patch-major route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg_j, cfg_t = JAX_PRESETS["small"], PRESETS["small"]
    path = tweights.checkpoint_path("small")
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg_j))
    return (cfg_j, jweights.load_npz(path, like), cfg_t,
            tweights.load_npz(path, cfg_t, device=CPU))


def test_embed_search_patches_matches_jax_and_embed_search(small):
    cfg_j, jparams, cfg_t, tparams = small
    rng = np.random.default_rng(7)
    p, n = cfg_t.patch_size, cfg_t.num_search_tokens
    patches = rng.standard_normal((p, n, p * 3)).astype(np.float32)
    want = jvittrack.embed_search_patches(jparams, jnp.asarray(patches), cfg_j)
    got = tvittrack.embed_search_patches(tparams, torch.from_numpy(patches),
                                         cfg_t)
    assert got.shape == (n, cfg_t.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # = embed_search of the raster image the patches came from.
    g = cfg_t.feat_size
    img = torch.from_numpy(patches).reshape(p, g, g, p, 3).permute(
        1, 0, 2, 3, 4).reshape(1, g * p, g * p, 3)
    np.testing.assert_allclose(
        got.numpy(), tvit.embed_search(tparams["backbone"], img, cfg_t)[0].numpy(),
        atol=1e-5, rtol=0)
    # Batched patches give batched tokens.
    two = torch.from_numpy(np.stack([patches, 2 * patches]))
    out = tvittrack.embed_search_patches(tparams, two, cfg_t)
    assert out.shape == (2, n, cfg_t.embed_dim)
    np.testing.assert_allclose(out[0].numpy(), got.numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Trajectories: one moving target, in every format
# ---------------------------------------------------------------------------

def rgb_clip(n, seed=0, h=H, w=W, box=(80, 56, 36, 28), step=(3, 2)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg = (70 + 25 * np.sin(xx / 37.0) * np.cos(yy / 23.0))[..., None] \
        + rng.normal(0, 6, (h, w, 3))
    bg = bg.clip(0, 255).astype(np.uint8)
    bw, bh = box[2], box[3]
    ty, tx = np.mgrid[0:bh, 0:bw]
    tex = np.stack([230 - 90 * (((tx // 6) + (ty // 6)) % 2),
                    120 + 0 * tx, 60 + 120 * (((tx // 6) + (ty // 6)) % 2)],
                   -1).astype(np.uint8)
    frames, boxes = [], []
    for t in range(n):
        x0, y0 = box[0] + step[0] * t, box[1] + step[1] * t
        x0, y0 = x0 - x0 % 2, y0 - y0 % 2
        f = bg.copy()
        f[y0:y0 + bh, x0:x0 + bw] = tex
        frames.append(f)
        boxes.append([float(x0), float(y0), float(bw), float(bh)])
    return frames, boxes


def in_format(rgb, fmt):
    return rgb if fmt == "rgb" else rgb_to_yuy2(rgb)


def _jstate(st):
    return JaxTrackState(*(jnp.asarray(a) for a in tweights.state_to_numpy(st)))


def _assert_rows(got_b, got_c, want_b, want_c, what):
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(want_b), atol=1e-2,
                               rtol=0, err_msg=f"bbox, {what}")
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c), atol=1e-4,
                               rtol=0, err_msg=f"score, {what}")


@pytest.mark.parametrize("fused_embed", [False, True])
@pytest.mark.parametrize("fmt", ["rgb", "yuy2"])
def test_core_trajectory_matches_jax(small, fmt, fused_embed):
    cfg_j, jparams, cfg_t, tparams = small
    frames, boxes = rgb_clip(5)
    frames = [in_format(f, fmt) for f in frames]
    jst = jcore.init(jparams, jnp.asarray(frames[0]), jnp.asarray(boxes[0]),
                     cfg_j, frame_format=fmt)
    tst = tcore.init(tparams, frames[0], boxes[0], cfg_t, frame_format=fmt,
                     device=CPU)
    np.testing.assert_allclose(tst.z_tok.numpy(), np.asarray(jst.z_tok),
                               atol=1e-4, rtol=0)
    for i, f in enumerate(frames[1:], 1):
        jst, jb, jc = jcore.update(jparams, jst, jnp.asarray(f), cfg_j,
                                   frame_format=fmt, fused_embed=fused_embed)
        tst, tb, tc = tcore.update(tparams, tst, f, cfg_t, frame_format=fmt,
                                   device=CPU, fused_embed=fused_embed)
        _assert_rows(tb, tc, jb, jc, f"frame {i}")
        assert int(tst.lost_frames) == int(jst.lost_frames)
    assert float(tc) > 0.3


def test_fused_embed_nv12_matches_the_plain_route(small):
    _, _, cfg_t, tparams = small
    rng = np.random.default_rng(8)
    frame = (rng.integers(0, 256, (H, W), dtype=np.uint8),
             rng.integers(0, 256, (H // 2, W // 2, 2), dtype=np.uint8))
    st = tcore.init(tparams, frame, [80.0, 56.0, 36.0, 28.0], cfg_t, "nv12", CPU)
    _, b0, c0 = tcore.update(tparams, st, frame, cfg_t, "nv12", CPU)
    _, b1, c1 = tcore.update(tparams, st, frame, cfg_t, "nv12", CPU,
                             fused_embed=True)
    _assert_rows(b1, c1, b0, c0, "fused_embed vs plain")


@pytest.mark.parametrize("fmt", ["rgb", "yuy2"])
def test_update_scan_and_objects_match_jax(small, fmt):
    cfg_j, jparams, cfg_t, tparams = small
    frames, boxes = rgb_clip(4)
    clip = np.stack([in_format(f, fmt) for f in frames])
    st0 = tcore.init(tparams, clip[0], boxes[0], cfg_t, frame_format=fmt,
                     device=CPU)
    tst, tb, tc = tscan.update_scan(tparams, st0, clip[1:], cfg_t,
                                    frame_format=fmt, device=CPU)
    jst, jb, jc = jscan.update_scan(jparams, _jstate(st0),
                                    jnp.asarray(clip[1:]), cfg_j,
                                    frame_format=fmt)
    _assert_rows(tb, tc, jb, jc, "update_scan")
    # The pools take the format too.
    _, pc = tscan.update_scan_pool(tparams, st0, clip[1:], 4, cfg_t,
                                   frame_format=fmt, device=CPU)
    _, jpc = jscan.update_scan_pool(jparams, _jstate(st0),
                                    jnp.asarray(clip[1:]), 4, cfg_j, fmt)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jpc), atol=1e-4, rtol=0)

    # Two objects of one frame (the second a stationary patch of background).
    bbs = np.asarray([boxes[0], [20.0, 90.0, 30.0, 30.0]], np.float32)
    active = np.asarray([True, True])
    jso = jmulti.init_objects(jparams, jnp.asarray(clip[0]), jnp.asarray(bbs),
                              cfg_j, frame_format=fmt)
    tso = tmulti.init_objects(tparams, clip[0], bbs, cfg_t, frame_format=fmt,
                              device=CPU)
    for f in clip[1:3]:
        jso, jb, jc = jmulti.update_objects(jparams, jso, jnp.asarray(f),
                                            jnp.asarray(active), cfg_j,
                                            frame_format=fmt)
        tso, tb, tc = tmulti.update_objects(tparams, tso, f, active, cfg_t,
                                            frame_format=fmt, device=CPU)
        _assert_rows(tb, tc, jb, jc, "update_objects")


@pytest.mark.parametrize("fmt", ["rgb", "yuy2"])
def test_streams_and_engine_match_jax(small, fmt):
    cfg_j, jparams, cfg_t, tparams = small
    clips = [rgb_clip(4, seed=1), rgb_clip(4, seed=2, box=(40, 70, 30, 34),
                                           step=(-2, 1))]

    def batch(t):
        return np.stack([in_format(c[0][t], fmt) for c in clips])

    bbs = np.asarray([[c[1][0]] for c in clips], np.float32)        # (2, 1, 4)
    active = np.ones((2, 1), bool)
    jst = jmulti.init_streams(jparams, jnp.asarray(batch(0)), jnp.asarray(bbs),
                              cfg_j, frame_format=fmt)
    tst = tmulti.init_streams(tparams, batch(0), bbs, cfg_t, frame_format=fmt,
                              device=CPU)
    jeng = JaxSlotEngine(jparams, cfg_j, slots=2, frame_format=fmt,
                         snapshot_every=0)
    teng = SlotEngine(tparams, cfg_t, slots=2, frame_format=fmt,
                      snapshot_every=0, device=CPU)
    for k, c in enumerate(clips):
        assert jeng.alloc() == teng.alloc() == k
        jeng.init_slot(k, in_format(c[0][0], fmt), c[1][0])
        teng.init_slot(k, in_format(c[0][0], fmt), c[1][0])
    for t in range(1, 4):
        jst, jb, jc = jmulti.update_streams(jparams, jst, jnp.asarray(batch(t)),
                                            jnp.asarray(active), cfg_j,
                                            frame_format=fmt)
        tst, tb, tc = tmulti.update_streams(tparams, tst, batch(t), active,
                                            cfg_t, frame_format=fmt, device=CPU)
        _assert_rows(tb, tc, jb, jc, f"update_streams, frame {t}")
        want = jeng.step(batch(t), np.ones(2, bool))
        got = teng.step(batch(t), np.ones(2, bool))
        _assert_rows(got[:, :4], got[:, 4], want[:, :4], want[:, 4],
                     f"engine tick {t}")
        # The engine's tick is the streams' step.
        _assert_rows(got[:, :4], got[:, 4], tb[:, 0].numpy(), tc[:, 0].numpy(),
                     "engine vs update_streams")


@pytest.mark.parametrize("fmt", ["rgb", "yuy2"])
def test_server_serves_the_format(small, fmt):
    """A TrackServer(device="cpu") of the format over loopback answers what
    the engine computes directly."""
    _, _, cfg_t, tparams = small
    frames, boxes = rgb_clip(3)
    frames = [in_format(f, fmt) for f in frames]
    srv = TrackServer(SlotEngine(tparams, cfg_t, slots=2, frame_format=fmt,
                                 snapshot_every=0, device=CPU),
                      H, W, port=0, batch_window_ms=1.0, update_timeout_s=30.0)
    srv.start()
    try:
        with TrackClient(srv.host, srv.port, timeout_s=30.0) as c:
            assert c.info["format"] == fmt
            c.init(frames[0], boxes[0])
            served = [c.update(f) for f in frames[1:]]
            c.release()
    finally:
        srv.stop()
    st = tcore.init(tparams, frames[0], boxes[0], tengine._batched_cfg(cfg_t),
                    frame_format=fmt, device=CPU)
    for f, (bbox, score) in zip(frames[1:], served):
        st, b, s = tcore.update(tparams, st, f, tengine._batched_cfg(cfg_t),
                                frame_format=fmt, device=CPU, fused=False)
        _assert_rows(bbox, score, b.numpy(), float(s), "served vs direct")


# ---------------------------------------------------------------------------
# Defaults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jfn,tfn", [
    (jcore.init, tcore.init), (jcore.update, tcore.update),
    (jcore.update_packed_jit, tcore.update_packed),
    (jmulti.init_objects, tmulti.init_objects),
    (jmulti.update_objects, tmulti.update_objects),
    (jmulti.init_streams, tmulti.init_streams),
    (jmulti.update_streams, tmulti.update_streams),
    (jscan.update_scan, tscan.update_scan),
    (jscan.update_scan_pool, tscan.update_scan_pool),
    (jscan.update_streams_scan_pool, tscan.update_streams_scan_pool),
    (jscan.update_objects_scan_pool, tscan.update_objects_scan_pool),
    (JaxSlotEngine.__init__, SlotEngine.__init__),
], ids=lambda f: getattr(f, "__qualname__", str(f)))
def test_frame_format_defaults_equal_the_jax_package(jfn, tfn):
    jfn = getattr(jfn, "__wrapped__", jfn)
    want = inspect.signature(jfn).parameters["frame_format"].default
    got = inspect.signature(tfn).parameters["frame_format"].default
    assert got == want
