"""PyTorch port: the HUD and the full-frame pixel ops the app draws with.

``render_hud`` (RGB and YUY2 converted by ``yuy2_to_rgb``), ``render_hud_luma``,
``draw_rect`` and ``draw_rect_luma_strips`` against the JAX package's on the
same seeded frames: uint8-equal.  One ``HudParams`` each for selecting,
tracking and lost, at 320x256, with boxes inside the frame, crossing its
edge and off it.  ``resize_static``: a float32 resample rounded, equal to
JAX's or one level away where the two round a near half-tie differently;
the count of such pixels is asserted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import colorspace as jcs  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import font as jfont  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import overlay as jov  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import overlay_nv12 as jov12  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import resample as jrs  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import colorspace as tcs  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import font as tfont  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import overlay as tov  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import overlay_nv12 as tov12  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import resample as trs  # noqa: E402

H, W = 256, 320


def _hud(module, state, bbox=(40, 30, 80, 60)):
    """HudParams of ``module`` for the three session states."""
    kw = dict(fps=59.7, track_ms=3.25, cursor=(160, 128),
              sel_start=(100, 90), bbox=bbox)
    if state == "selecting":
        return module.HudParams(state_name="SELECT END", score=0.0,
                                is_tracking=False, is_selecting=True,
                                sel_active=True, has_bbox=False, **kw)
    if state == "tracking":
        return module.HudParams(state_name="TRACKING", score=0.873,
                                is_tracking=True, is_selecting=False,
                                sel_active=False, has_bbox=True, **kw)
    return module.HudParams(state_name="LOST", score=0.0, is_tracking=False,
                            is_selecting=False, sel_active=False,
                            has_bbox=False, **kw)


STATES = ("selecting", "tracking", "lost")
# Inside the frame, over its right and bottom edges, over its top-left
# corner, thinner than the bands, and wholly off the frame.
BOXES = ((40, 30, 80, 60), (270, 220, 90, 70), (-20, -15, 60, 50),
         (100, 100, 4, 2), (400, 300, 30, 30))


def _frame(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("bbox", BOXES)
@pytest.mark.parametrize("state", STATES)
def test_render_hud_rgb_matches_jax(state, bbox):
    img = _frame(1, (H, W, 3))
    want = np.asarray(jov.render_hud(jnp.asarray(img), _hud(jov, state, bbox)))
    t = torch.tensor(img)
    got = tov.render_hud(t, _hud(tov, state, bbox))
    assert got is t                                   # painted in place
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != img).any()


@pytest.mark.parametrize("state", STATES)
def test_render_hud_on_yuy2_matches_jax(state):
    packed = _frame(2, (H, W * 2))
    want = np.asarray(jov.render_hud(
        jcs.yuy2_to_rgb(jnp.asarray(packed).reshape(-1), width=W, height=H),
        _hud(jov, state, BOXES[1])))
    rgb = tcs.yuy2_to_rgb(torch.tensor(packed).reshape(-1), width=W, height=H)
    np.testing.assert_array_equal(
        rgb.numpy(), np.asarray(jcs.yuy2_to_rgb(
            jnp.asarray(packed).reshape(-1), width=W, height=H)))
    got = tov.render_hud(rgb, _hud(tov, state, BOXES[1]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bbox", BOXES)
@pytest.mark.parametrize("state", STATES)
def test_render_hud_luma_matches_jax(state, bbox):
    y = _frame(3, (H, W))
    want = np.asarray(jov12.render_hud_luma(jnp.asarray(y),
                                            _hud(jov, state, bbox)))
    got = tov12.render_hud_luma(torch.tensor(y), _hud(tov, state, bbox))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bbox", BOXES)
@pytest.mark.parametrize("thickness", (1, 2, 3))
def test_draw_rect_and_strips_match_jax(bbox, thickness):
    img = _frame(4, (H, W, 3))
    want = np.asarray(jov.draw_rect(jnp.asarray(img), *bbox, thickness,
                                    (255, 80, 80)))
    got = tov.draw_rect(torch.tensor(img), *bbox, thickness, (255, 80, 80))
    np.testing.assert_array_equal(got.numpy(), want)

    y = _frame(5, (H, W))
    want = np.asarray(jov12.draw_rect_luma_strips(jnp.asarray(y), *bbox,
                                                  thickness, 215))
    got = tov12.draw_rect_luma_strips(torch.tensor(y), *bbox, thickness, 215)
    np.testing.assert_array_equal(got.numpy(), want)


def test_selection_with_corners_past_the_frame_matches_jax():
    """Selection corners clamp into the frame; start and cursor may lie on
    either side of each other."""
    for sx, sy, ux, uy in ((300, 200, 20, 10), (10, 10, 400, 300),
                           (330, 260, 350, 270)):
        img = _frame(6, (H, W, 3))
        want = np.asarray(jov.draw_selection(jnp.asarray(img), sx, sy, ux, uy))
        got = tov.draw_selection(torch.tensor(img), sx, sy, ux, uy)
        np.testing.assert_array_equal(got.numpy(), want)
        y = img[..., 0].copy()
        want = np.asarray(jov12.draw_selection_luma(jnp.asarray(y), sx, sy,
                                                    ux, uy))
        got = tov12.draw_selection_luma(torch.tensor(y), sx, sy, ux, uy)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cursor_and_crosshair_at_the_frame_edges_match_jax():
    for cx, cy in ((0, 0), (W - 3, H - 1), (-10, 5), (W + 4, H + 9)):
        img = _frame(7, (H, W, 3))
        want = np.asarray(jov.draw_cursor(jnp.asarray(img), cx, cy))
        np.testing.assert_array_equal(
            tov.draw_cursor(torch.tensor(img), cx, cy).numpy(), want)
        want = np.asarray(jov.draw_crosshair(jnp.asarray(img), cx, cy, 15,
                                             (0, 255, 0)))
        np.testing.assert_array_equal(tov.draw_crosshair(
            torch.tensor(img), cx, cy, 15, (0, 255, 0)).numpy(), want)
        y = img[..., 1].copy()
        want = np.asarray(jov12.draw_cursor_luma(jnp.asarray(y), cx, cy))
        np.testing.assert_array_equal(
            tov12.draw_cursor_luma(torch.tensor(y), cx, cy).numpy(), want)
        want = np.asarray(jov12.draw_crosshair_luma(jnp.asarray(y), cx, cy,
                                                    15, 255))
        np.testing.assert_array_equal(tov12.draw_crosshair_luma(
            torch.tensor(y), cx, cy, 15, 255).numpy(), want)


def test_hud_fields_truncate_like_jax():
    """A first frame slow enough to overflow a field truncates it."""
    kw = dict(state_name="TRACKING", fps=123456.0, track_ms=123456.7,
              score=1.0, is_tracking=True, is_selecting=False,
              cursor=(5, 5), sel_start=(5, 5), sel_active=False,
              bbox=None, has_bbox=False)
    j, t = jov.HudParams(**kw), tov.HudParams(**kw)
    for name in ("state", "fps", "trk", "score"):
        np.testing.assert_array_equal(getattr(t, f"{name}_chars"),
                                      getattr(j, f"{name}_chars"))
        assert getattr(t, f"{name}_n") == getattr(j, f"{name}_n")
    np.testing.assert_array_equal(t.bbox, j.bbox)


def test_font_is_a_faithful_copy():
    np.testing.assert_array_equal(tfont.FONT_TABLE, jfont.FONT_TABLE)
    assert tfont.FONT_CHARS == jfont.FONT_CHARS
    assert tfont.ADVANCE == jfont.ADVANCE
    with pytest.raises(KeyError):
        tfont.encode_text("x/y", 5)


@pytest.mark.parametrize("shape,out", [((H, W, 3), (512, 640)),
                                       ((H, W), (1024, 1280)),
                                       ((H, W, 3), (200, 250))])
def test_resize_static_matches_jax(shape, out):
    img = _frame(8, shape)
    want = np.asarray(jrs.resize_static(jnp.asarray(img), *out)).astype(int)
    got = trs.resize_static(torch.tensor(img), *out).numpy().astype(int)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1
    # A level apart only where the float32 value sits on a half-tie that
    # the two summation orders round apart: a few in ten thousand.
    assert (d > 0).sum() <= 1e-3 * d.size, (d > 0).sum()


def test_crop_resize_matches_jax():
    img = _frame(9, (H, W, 3))
    for start, size, out in (((10.5, 20.0), (100.0, 80.0), (64, 64)),
                             ((-30.0, 250.0), (90.0, 120.0), (48, 40))):
        want = np.asarray(jrs.crop_resize(jnp.asarray(img), start, size, out))
        got = trs.crop_resize(torch.tensor(img), start, size, out).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
