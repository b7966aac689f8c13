"""PyTorch port: the HUD and the full-frame pixel ops the app draws with.

``render_hud`` (RGB and YUY2 converted by ``yuy2_to_rgb``), ``render_hud_luma``,
``draw_rect`` and ``draw_rect_luma_strips`` against the JAX package's on the
same seeded frames: uint8-equal.  So are ``draw_background``,
``draw_background_luma``, ``draw_crosshair_luma_strips`` (centres off the
plane, negative, planes smaller than the crosshair) and the device-tensor
forms of the rect strips and the text that the HUD pool draws with.  One ``HudParams`` each for selecting,
tracking and lost, at 320x256, with boxes inside the frame, crossing its
edge and off it.  ``resize_static``: a float32 resample rounded, equal to
JAX's or one level away where the two round a near half-tie differently;
the count of such pixels is asserted.  ``crop_resize_chw`` against JAX's
in float32 to 1e-5 relative (its uint8 inputs reach 255, where one float32
ulp is 1.5e-5 and the two einsum orders differ by an ulp or two).

The compiled draws the app calls (``render_hud_jit``, ``render_hud_luma_jit``,
``yuy2_to_rgb_jit``, ``resize_static_jit``: one program a frame shape, the
geometry on the device) against JAX's jitted ones and the eager draws:
uint8-equal, for every state and box above and for cursors and selection
corners off the frame; the frame is donated.
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


def _hud(module, state, bbox=(40, 30, 80, 60), cursor=(160, 128),
         sel_start=(100, 90)):
    """HudParams of ``module`` for the three session states."""
    kw = dict(fps=59.7, track_ms=3.25, cursor=cursor, sel_start=sel_start,
              bbox=bbox)
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


@pytest.mark.parametrize("box", ((40, 30, 80, 60), (-20, -15, 60, 50),
                                 (300, 240, 50, 40), (0, 0, 0, 0),
                                 (400, 300, 30, 30)))
def test_draw_background_matches_jax(box):
    img = _frame(10, (H, W, 3))
    want = np.asarray(jov.draw_background(jnp.asarray(img), *box, value=30))
    got = tov.draw_background(torch.tensor(img), *box, value=30).numpy()
    np.testing.assert_array_equal(got, want)
    luma = _frame(11, (H, W))
    for dark in (0, 128, 255):
        want = np.asarray(jov12.draw_background_luma(jnp.asarray(luma), *box,
                                                     dark))
        got = tov12.draw_background_luma(torch.tensor(luma), *box,
                                         dark).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tov12.draw_background_luma(torch.tensor(luma), *box, 128,
                                   enable=False).numpy(), luma)


# Inside; on each edge; off the plane past the far corner; negative (the
# centre clamps at 0); on planes smaller than the crosshair (31 px).
CROSS = [((H, W), c) for c in ((160, 128), (0, 5), (W - 1, H - 1), (W + 40, 90),
                               (-12, -30), (-5, 200), (100, H + 20))] + [
    ((20, 24), (10, 9)), ((20, 24), (-3, 30)), ((9, 40), (20, 4)),
    ((31, 31), (15, 15))]


@pytest.mark.parametrize("shape,centre", CROSS)
def test_crosshair_strips_match_jax(shape, centre):
    luma = _frame(12, shape)
    want = np.asarray(jov12.draw_crosshair_luma_strips(
        jnp.asarray(luma), *centre, 15, 255))
    got = tov12.draw_crosshair_luma_strips(torch.tensor(luma), *centre, 15,
                                           255).numpy()
    np.testing.assert_array_equal(got, want)
    # Device-tensor centres give the same pixels.
    got = tov12.draw_crosshair_luma_strips(
        torch.tensor(luma), torch.tensor(centre[0], dtype=torch.int32),
        torch.tensor(centre[1], dtype=torch.int32), 15, 255).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bbox", BOXES + ((-40, -30, 20, 10),))
@pytest.mark.parametrize("thickness", (1, 3))
def test_rect_strips_dyn_match_jax(bbox, thickness):
    luma = _frame(13, (H, W))
    want = np.asarray(jov12.draw_rect_luma_strips(jnp.asarray(luma), *bbox,
                                                  thickness, 255))
    box = torch.tensor(bbox, dtype=torch.int32)
    got = tov12.draw_rect_luma_strips_dyn(torch.tensor(luma), *box,
                                          thickness, 255).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("enable", (True, False))
def test_text_luma_takes_device_glyphs_and_enable(enable):
    luma = _frame(14, (H, W))
    chars, n = tfont.encode_text("score: 87.3%", 12)
    want = np.asarray(jov12.draw_text_luma(
        jnp.asarray(luma), jnp.asarray(chars), n, 200, 15, 2, 255,
        enable=jnp.asarray(enable)))
    got = tov12.draw_text_luma(torch.tensor(luma), torch.tensor(chars), n,
                               200, 15, 2, 255,
                               enable=torch.tensor(enable)).numpy()
    np.testing.assert_array_equal(got, want)
    got = tov12.draw_text_luma(torch.tensor(luma), chars, n, 200, 15, 2, 255,
                               enable=enable).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start,size,out", [
    ((10.5, 20.0), (100.0, 80.0), (64, 64)),
    ((-30.0, 250.0), (90.0, 120.0), (48, 40)),
    ((3.25, -7.5), (33.3, 47.1), (17, 23))])
def test_crop_resize_chw_matches_jax(start, size, out):
    img = _frame(15, (3, H, W))
    want = np.asarray(jrs.crop_resize_chw(jnp.asarray(img), start, size, out))
    got = trs.crop_resize_chw(torch.tensor(img), start, size, out).numpy()
    assert got.shape == (3,) + out and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# The cursor and the selection's start: inside the frame, off its left and
# past its bottom-right, and both past the frame.
POINTS = (((160, 128), (100, 90)), ((-10, 5), (330, 260)),
          ((W + 4, H + 9), (10, 10)), ((-30, -40), (W + 50, -5)))


@pytest.mark.parametrize("points", POINTS)
@pytest.mark.parametrize("bbox", BOXES)
@pytest.mark.parametrize("state", STATES)
def test_compiled_hud_matches_jax_and_the_eager_draw(state, bbox, points):
    img, y = _frame(1, (H, W, 3)), _frame(3, (H, W))
    jp, tp = (_hud(m, state, bbox, *points) for m in (jov, tov))
    want = np.asarray(jov.render_hud(jnp.asarray(img), jp))
    got = tov.render_hud_jit(img, tp, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tov.render_hud(torch.tensor(img), tp).numpy())
    want = np.asarray(jov12.render_hud_luma(jnp.asarray(y), jp))
    got = tov12.render_hud_luma_jit(y, tp, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tov12.render_hud_luma(torch.tensor(y), tp).numpy())


@pytest.mark.parametrize("state", STATES)
def test_compiled_yuy2_hud_and_resize_match_jax(state):
    packed = _frame(2, (H, W * 2))
    jrgb = jcs.yuy2_to_rgb(jnp.asarray(packed).reshape(-1), width=W, height=H)
    rgb = tcs.yuy2_to_rgb_jit(packed.reshape(-1), W, H, "cpu")
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    # JAX's render_hud donates its frame.
    want = np.asarray(jov.render_hud(jrgb, _hud(jov, state, BOXES[1])))
    got = tov.render_hud_jit(rgb, _hud(tov, state, BOXES[1]), "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    big = trs.resize_static_jit(got, 512, 640, "cpu")
    assert torch.equal(big, trs.resize_static(torch.tensor(want), 512, 640))
    d = np.abs(big.numpy().astype(int) - np.asarray(jrs.resize_static(
        jnp.asarray(want), 512, 640)).astype(int))
    assert d.max() <= 1 and (d > 0).sum() <= 1e-3 * d.size


def test_the_compiled_hud_donates_the_frame():
    """A host frame is copied in and left as it was; the returned tensor
    passed back is painted in place, with no copy; a result still held
    when another frame comes in keeps its pixels."""
    img = _frame(1, (H, W, 3))
    before = img.copy()
    sel, trk = _hud(tov, "selecting"), _hud(tov, "tracking")
    out = tov.render_hud_jit(img, sel, "cpu")
    np.testing.assert_array_equal(img, before)
    copies = tov._render_hud.copies
    again = tov.render_hud_jit(out, trk, "cpu")
    assert again is out and tov._render_hud.copies == copies + 1  # the HUD
    want = tov.render_hud(tov.render_hud(torch.tensor(img), sel), trk)
    assert torch.equal(again, want)
    held = again.clone()
    tov.render_hud_jit(_frame(5, (H, W, 3)), sel, "cpu")
    assert torch.equal(again, held)
