"""PyTorch port, the whole slice: ``tracker.core.init`` / ``update`` on
NV12 1080p frames with the shipped weights, against JAX's ``core.update``.

(a) ``small`` (float32): init + 8 updates; per-frame bbox within 1e-2 px,
    score within 1e-4, ``lost_frames`` exact.
(b) the flagship weights with ``dtype="float32"`` (full width, depth 12):
    3 updates, the same tolerances.
(c) the flagship in bf16, one step: the three maps within atol 0.05, the
    confidence within 0.02, the same peak cell (the peak's margin over the
    runner-up is asserted first, so the cell is well defined).
(d) no ``device`` on a machine without CUDA raises instead of running on
    the CPU.

The clip is a bright textured target moving a few px per frame over a dim
textured background, made with numpy from a seed and fed to both sides.
On the CPU the port's encoder is the CUDA kernel's plain twin.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import heads as jheads  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import preprocess as jpp  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch import entry as tentry  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import heads as theads  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack as tvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402

CPU = torch.device("cpu")


def nv12_clip(n, seed=0, h=1080, w=1920, box=(880, 480, 96, 72), step=(3, 2),
              hide_from=None):
    """n NV12 frames (Y, UV) with a bright textured target moving by
    ``step`` px per frame (absent from frame ``hide_from`` on), and the
    target's box in frame 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg_y = (70 + 25 * np.sin(xx / 97.0) * np.cos(yy / 61.0)
            + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.uint8)
    bg_uv = (128 + rng.normal(0, 3, (h // 2, w // 2, 2))).clip(
        0, 255).astype(np.uint8)
    bw, bh = box[2], box[3]
    ty, tx = np.mgrid[0:bh, 0:bw]
    tex = (185 + 60 * (((tx // 8) + (ty // 8)) % 2)
           + rng.normal(0, 5, (bh, bw))).clip(0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        x0, y0 = box[0] + step[0] * t, box[1] + step[1] * t
        x0, y0 = x0 - x0 % 2, y0 - y0 % 2
        y = bg_y.copy()
        uv = bg_uv.copy()
        if hide_from is None or t < hide_from:
            y[y0:y0 + bh, x0:x0 + bw] = tex
            uv[y0 // 2:(y0 + bh) // 2, x0 // 2:(x0 + bw) // 2] = (90, 200)
        frames.append((y, uv))
    return frames, [float(v) for v in box]


@pytest.fixture(scope="module")
def clip():
    return nv12_clip(9)


def _params(preset, cfg_j, cfg_t):
    path = tweights.checkpoint_path(preset)
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg_j))
    jparams = jvittrack.with_grouped_head(jweights.load_npz(path, like))
    tparams = tvittrack.with_grouped_head(
        tweights.load_npz(path, cfg_t, device=CPU))
    return jparams, tparams


def _trajectories(preset, dtype, clip, steps, z_atol=1e-4, **overrides):
    cfg_j = dataclasses.replace(JAX_PRESETS[preset], dtype=dtype, **overrides)
    cfg_t = dataclasses.replace(PRESETS[preset], dtype=dtype, **overrides)
    jparams, tparams = _params(preset, cfg_j, cfg_t)
    frames, bbox = clip
    jupd = jax.jit(functools.partial(jcore.update, cfg=cfg_j,
                                     frame_format="nv12"))
    jst = jcore.init(jparams, tuple(map(jnp.asarray, frames[0])),
                     jnp.asarray(bbox), cfg_j, frame_format="nv12")
    tst = tcore.init(tparams, frames[0], bbox, cfg_t, device=CPU,
                     frame_format="nv12")
    rows = []
    for f in frames[1:steps + 1]:
        jst, jb, jc = jupd(jparams, jst, tuple(map(jnp.asarray, f)))
        tst, tb, tc = tcore.update(tparams, tst, f, cfg_t, device=CPU,
                                   frame_format="nv12")
        rows.append((np.asarray(jb), float(jc), int(jst.lost_frames),
                     tb.numpy(), float(tc), int(tst.lost_frames)))
    np.testing.assert_allclose(tst.z_tok.float().numpy(),
                               np.asarray(jst.z_tok, np.float32),
                               atol=z_atol, rtol=0)
    return rows


def _assert_trajectory(rows):
    for i, (jb, jc, jl, tb, tc, tl) in enumerate(rows):
        np.testing.assert_allclose(tb, jb, atol=1e-2, rtol=0,
                                   err_msg=f"bbox, frame {i + 1}")
        assert abs(tc - jc) <= 1e-4, (i + 1, tc, jc)
        assert tl == jl, (i + 1, tl, jl)


def test_small_f32_trajectory_matches_jax(clip):
    rows = _trajectories("small", "float32", clip, 8)
    _assert_trajectory(rows)
    assert len(rows) == 8


def test_small_f32_lost_target_ramp_matches_jax():
    # The target vanishes after frame 2: the window freezes, lost_frames
    # counts up and the search window grows (the re-detection ramp).
    rows = _trajectories("small", "float32", nv12_clip(9, hide_from=3), 8)
    _assert_trajectory(rows)
    assert rows[-1][2] >= 2                       # the ramp was exercised


def test_small_f32_template_update_matches_jax(clip):
    # Each update re-embeds the template at the tracked box, which the two
    # sides agree on to ~1e-3 px; on the target's sharp checker edges that
    # moves template tokens by up to ~3e-3, and the differences feed back
    # into later frames, so the run is shorter and the tokens looser.
    rows = _trajectories("small", "float32", clip, 6, z_atol=1e-2,
                         template_update_enabled=True,
                         template_update_threshold=0.3,
                         template_update_interval=2)
    _assert_trajectory(rows)
    assert max(r[1] for r in rows) > 0.3         # an update was taken


def test_flagship_f32_trajectory_matches_jax(clip):
    rows = _trajectories("vittrack-t", "float32", clip, 3)
    _assert_trajectory(rows)
    assert min(r[1] for r in rows) > 0.25        # the target is tracked


def test_flagship_bf16_step_matches_jax(clip):
    cfg_j, cfg_t = JAX_PRESETS["vittrack-t"], PRESETS["vittrack-t"]
    jparams, tparams = _params("vittrack-t", cfg_j, cfg_t)
    frames, bbox = clip
    jst = jcore.init(jparams, tuple(map(jnp.asarray, frames[0])),
                     jnp.asarray(bbox), cfg_j, frame_format="nv12")
    tst = tcore.init(tparams, frames[0], bbox, cfg_t, device=CPU,
                     frame_format="nv12")
    np.testing.assert_allclose(tst.z_tok.float().numpy(),
                               np.asarray(jst.z_tok, np.float32),
                               atol=0.05, rtol=0)
    jwin = jpp.crop_window(jst.bbox, cfg_j.search_factor)
    twin = tpp.crop_window(tst.bbox, cfg_t.search_factor)
    jmaps = jax.jit(lambda p, z, f: jvittrack.forward(
        p, z[None], jcore._prep_nv12(f, jwin, cfg_j.search_size, cfg_j)[None],
        cfg_j))(jparams, jst.z_tok, tuple(map(jnp.asarray, frames[1])))
    tmaps = tvittrack.forward(
        tparams, tst.z_tok[None],
        tcore._prep_nv12(tcore._frame_on(frames[1], "nv12", CPU), twin,
                         cfg_t.search_size, cfg_t)[None], cfg_t)
    for name in ("score", "offset", "size"):
        np.testing.assert_allclose(getattr(tmaps, name).numpy(),
                                   np.asarray(getattr(jmaps, name)),
                                   atol=0.05, rtol=0, err_msg=name)

    fs = cfg_j.feat_size
    jpen = np.asarray(jmaps.score[0] * jheads.hanning_2d(fs)).ravel()
    tpen = (tmaps.score[0] * theads.hanning_2d(fs)).numpy().ravel()
    top2 = np.sort(jpen)[-2:]
    assert top2[1] - top2[0] > 0.05, top2      # a well-separated peak
    assert int(np.argmax(tpen)) == int(np.argmax(jpen))
    _, jconf = jheads.decode_maps(jmaps.score[0], jmaps.offset[0],
                                  jmaps.size[0], jheads.hanning_2d(fs),
                                  jst.bbox[2:4] / jwin.size)
    _, tconf = theads.decode_maps(tmaps.score[0], tmaps.offset[0],
                                  tmaps.size[0], theads.hanning_2d(fs),
                                  tst.bbox[2:4] / twin.size)
    assert abs(float(tconf) - float(jconf)) <= 0.02


def test_no_device_without_cuda_raises(clip, monkeypatch):
    cfg = PRESETS["small"]
    params = tvittrack.with_grouped_head(tweights.load_npz(
        tweights.checkpoint_path("small"), cfg, device=CPU))
    frames, bbox = clip
    state = tcore.init(params, frames[0], bbox, cfg, device="cpu",
                       frame_format="nv12")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.init(params, frames[0], bbox, cfg, frame_format="nv12")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.update(params, state, frames[1], cfg, frame_format="nv12")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.update_packed(params, state, frames[1], cfg, frame_format="nv12")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


def test_update_packed_is_bbox_and_score(clip):
    cfg = PRESETS["small"]
    params = tvittrack.with_grouped_head(tweights.load_npz(
        tweights.checkpoint_path("small"), cfg, device=CPU))
    frames, bbox = clip
    state = tcore.init(params, frames[0], bbox, cfg, device=CPU,
                       frame_format="nv12")
    s1, b1, c1 = tcore.update(params, state, frames[1], cfg, device=CPU,
                              frame_format="nv12")
    s2, packed = tcore.update_packed(params, state, frames[1], cfg, device=CPU,
                                     frame_format="nv12")
    assert packed.shape == (5,) and packed.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(),
                                  np.concatenate([b1.numpy(), [float(c1)]]))
    assert int(s2.frame_idx) == 1 and int(state.frame_idx) == 0


def test_other_frame_formats_wait_for_a_later_slice(clip):
    cfg = PRESETS["small"]
    params = tvittrack.with_grouped_head(tweights.load_npz(
        tweights.checkpoint_path("small"), cfg, device=CPU))
    # They no longer wait: RGB (the default, as in JAX) and YUY2 start a
    # track (held against JAX in tests/test_torch_formats.py); an unknown
    # format raises.
    rgb = np.zeros((64, 64, 3), np.uint8)
    st = tcore.init(params, rgb, [8.0, 8.0, 16.0, 16.0], cfg, device=CPU)
    assert st.z_tok.shape == (cfg.num_template_tokens, cfg.embed_dim)
    st = tcore.init(params, np.zeros((64, 128), np.uint8),
                    [8.0, 8.0, 16.0, 16.0], cfg, frame_format="yuy2",
                    device=CPU)
    assert torch.isfinite(st.z_tok).all()
    with pytest.raises(ValueError, match="unknown frame format"):
        tcore.init(params, rgb, [8.0, 8.0, 16.0, 16.0], cfg,
                   frame_format="bgr", device=CPU)


def test_entry_runs_one_flagship_update_on_cpu():
    fn, (params, state, frame) = tentry.entry(device="cpu")
    new_state, bbox, conf = fn(params, state, frame)
    assert frame[0].shape == (1080, 1920) and frame[1].shape == (540, 960, 2)
    assert state.z_tok.shape == (64, 192) and state.z_tok.dtype == torch.bfloat16
    assert bbox.shape == (4,) and np.isfinite(bbox.numpy()).all()
    assert 0.0 <= float(conf) <= 1.0
    assert int(new_state.frame_idx) == 1


def test_entry_main_runs_the_compiled_update(capsys):
    # __graft_entry__.py's __main__: entry()'s step jitted, the state
    # donated, "entry OK:" and the shapes of the box and the score.
    traces = tcore.update_jit.traces
    assert tentry.main(["--cpu"]) == 0
    assert capsys.readouterr().out == "entry OK: ((4,), ())\n"
    assert tcore.update_jit.traces == traces + 1
