"""PyTorch port: ``tracker/scan.py::update_scan_hud_pool`` (BASELINE config
5, the luma HUD composited on every tracked frame) against the JAX
package's, on the CPU.

The pool runs on JAX's own test configuration (``tests/test_scan.py``: the
``CORR`` model, corr head, float32, seeded weights, a 256x192
``SyntheticSource`` NV12 pool of 3 frames, 5 reps) and on the float32
``small`` preset cut to depth 2 with its shipped weights, so an encoder
runs inside the pool: scores and the final state within 1e-4, the display
byte-equal to JAX's.  The per-frame composite, fed the same box and
confidence as JAX's body, is byte-equal to it: scores below, at and above
the 0.25 enable, half-way ties of ``round(conf * 1000)``, boxes partly or
wholly off the frame and with negative corners.  The pool frames are never
written, and the display is the last frame with the HUD on it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.media.source import SyntheticSource  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import font as jfont  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import overlay_nv12 as jol  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import scan as jscan  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import ModelConfig, PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import font as tfont  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import scan as tscan  # noqa: E402

CPU = torch.device("cpu")
CORR = dict(template_size=64, search_size=128, patch_size=8, embed_dim=64,
            depth=0, num_heads=2, head_mode="corr", dtype="float32")
POOL, REPS = 3, 5
HUD = ("TRACKING", 12), ("FPS: 60.0", 16), ("trk: 0.3ms", 16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs beside other workers, and
    oversubscribed thread pools spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hud_text(font):
    return tuple(font.encode_text(t, n) for t, n in HUD)


def _pool(w=256, h=192):
    src = SyntheticSource(w, h, obj_size=32, seed=1, fmt="nv12")
    ys = np.stack([src.frame(i)[0] for i in range(POOL)])
    uvs = np.stack([src.frame(i)[1] for i in range(POOL)])
    return ys, uvs, np.asarray(src.bbox_at(0), np.float32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(name -> (JAX cfg, JAX params, port cfg, port params)): CORR from
    JAX's seeded init (PRNGKey 42, as tests/test_scan.py) crossed through
    npz, and ``small`` at depth 2 from its shipped weights."""
    out = {}
    jcfg = JModelConfig(**CORR)
    jparams = jvittrack.init_params(jax.random.PRNGKey(42), jcfg)
    path = str(tmp_path_factory.mktemp("hud") / "corr.npz")
    jweights.save_npz(path, jparams)
    tcfg = ModelConfig(**CORR)
    out["corr"] = (jcfg, jparams, tcfg,
                   tweights.load_npz(path, tcfg, device=CPU))
    jcfg = dataclasses.replace(JAX_PRESETS["small"], depth=2)
    tcfg = dataclasses.replace(PRESETS["small"], depth=2)
    ckpt = tweights.checkpoint_path("small")
    like = jax.eval_shape(lambda: jvittrack.init_params(
        jax.random.PRNGKey(0), jcfg))
    out["small"] = (jcfg, jweights.load_npz(ckpt, like), tcfg,
                    tweights.load_npz(ckpt, tcfg, device=CPU))
    return out


@pytest.mark.parametrize("model", ["corr", "small"])
def test_hud_pool_matches_jax(models, model):
    jcfg, jparams, tcfg, tparams = models[model]
    ys, uvs, bb0 = _pool()
    kept = ys.copy(), uvs.copy()
    jst = jcore.init(jparams, (jnp.asarray(ys[0]), jnp.asarray(uvs[0])),
                     jnp.asarray(bb0), jcfg, frame_format="nv12")
    jst, jdisp, jsc = jscan.update_scan_hud_pool(
        jparams, jst, (jnp.asarray(ys), jnp.asarray(uvs)), _hud_text(jfont),
        REPS, jcfg)
    pool = (torch.from_numpy(ys), torch.from_numpy(uvs))
    tst = tcore.init(tparams, (ys[0], uvs[0]), bb0, tcfg, device=CPU,
                     frame_format="nv12")
    tst, tdisp, tsc = tscan.update_scan_hud_pool(
        tparams, tst, pool, _hud_text(tfont), REPS, tcfg, device=CPU)
    assert tsc.shape == (REPS,) and tdisp.shape == ys.shape[1:]
    assert tdisp.dtype == torch.uint8
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tst.bbox.numpy(), np.asarray(jst.bbox),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tst.score.numpy(), np.asarray(jst.score),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tst.z_tok.numpy(), np.asarray(jst.z_tok),
                               atol=1e-4, rtol=0)
    assert int(tst.frame_idx) == int(jst.frame_idx) == REPS
    assert int(tst.lost_frames) == int(jst.lost_frames)
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
    # The pool was read, never painted.
    np.testing.assert_array_equal(pool[0].numpy(), kept[0])
    np.testing.assert_array_equal(pool[1].numpy(), kept[1])
    # The display is the last frame (pool index (REPS - 1) % POOL) with the
    # last frame's HUD on it, and nothing else.
    last = torch.from_numpy(ys[(REPS - 1) % POOL])
    want = tscan.composite_hud(torch.empty_like(last), last, tst.bbox,
                               tsc[-1], tscan.hud_glyphs(_hud_text(tfont),
                                                         CPU))
    assert torch.equal(tdisp, want)
    diff = (tdisp != last).float().mean().item()
    assert 0.0 < diff < 0.05
    assert (tdisp.numpy()[15:29, 15:27] == 255).any()


def _jax_body(luma, bbox, conf):
    """The composite of JAX's ``update_scan_hud_pool`` body, step by step
    (JAX keeps it inside the scanned function)."""
    (sc, sn), (fc, fn), (tc, tn) = _hud_text(jfont)
    prefix, _ = jfont.encode_text("score: ", 7)
    dot = jnp.asarray(jfont.FONT_CHARS.index("."), jnp.int32)
    pct = jnp.asarray(jfont.FONT_CHARS.index("%"), jnp.int32)
    conf = jnp.asarray(conf, jnp.float32)
    v = jnp.clip(jnp.round(conf * 1000.0), 0, 999).astype(jnp.int32)
    digits = jnp.stack([v // 100, (v // 10) % 10])
    score_chars = jnp.concatenate(
        [jnp.asarray(prefix), digits, dot[None], v[None] % 10, pct[None]])
    luma = jnp.asarray(luma)
    luma = jol.draw_text_luma(luma, sc, sn, 15, 15, 2, 255)
    luma = jol.draw_text_luma(luma, fc, fn, 15, 40, 2, 255)
    luma = jol.draw_text_luma(luma, tc, tn, 15, 65, 1, 200)
    luma = jol.draw_text_luma(luma, score_chars, score_chars.shape[0],
                              200, 15, 2, 255, enable=conf > 0.25)
    bb = jnp.asarray(bbox, jnp.float32).astype(jnp.int32)
    luma = jol.draw_rect_luma_strips(luma, bb[0], bb[1], bb[2], bb[3], 3, 255)
    luma = jol.draw_crosshair_luma_strips(luma, bb[0] + bb[2] // 2,
                                          bb[1] + bb[3] // 2, 15, 255)
    return np.asarray(luma)


# Below, at and above the 0.25 enable; exact half-way ties of conf * 1000
# (312.5 -> 312, 687.5 -> 688, both half to even); clipped at 999.
CONFS = (0.1, 0.25, 0.2501, 0.3125, 0.6875, 0.873, 0.9995, 1.0)
# Inside; fractional with negative corners (truncated toward zero); over
# the right and bottom edges; wholly off the frame; thinner than the bands.
BOXES = ((100.6, 80.2, 40.9, 30.1), (-10.7, -3.2, 50.0, 40.0),
         (230.5, 170.0, 60.0, 50.0), (300.0, 250.0, 20.0, 20.0),
         (-80.0, -90.0, 30.0, 30.0), (50.0, 60.0, 2.0, 1.0))


@pytest.mark.parametrize("conf", CONFS)
@pytest.mark.parametrize("bbox", BOXES)
def test_composite_is_byte_equal_to_jax_body(bbox, conf):
    luma = np.random.default_rng(7).integers(0, 256, (192, 256), np.uint8)
    want = _jax_body(luma, bbox, conf)
    src = torch.from_numpy(luma.copy())
    got = tscan.composite_hud(
        torch.zeros_like(src), src, torch.tensor(bbox, dtype=torch.float32),
        torch.tensor(conf, dtype=torch.float32),
        tscan.hud_glyphs(_hud_text(tfont), CPU))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), luma)
