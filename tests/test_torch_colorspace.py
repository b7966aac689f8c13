"""PyTorch port: ``ops/colorspace.py``'s whole-frame conversions against the
JAX package's.

``nv12_to_rgb`` (flat buffer: even sizes, odd widths and heights whose
chroma reads run past the buffer's end and are clamped to its last byte as
JAX's gather clamps, a buffer longer than needed, a short buffer that gives
a zero image) and ``nv12_planes_to_rgb`` are uint8-equal; the float
conversions ``rgb_from_yuv_f32`` and ``rgb_from_shifted_yuv_f32`` are held
to 1e-6 relative and come out equal (both round the coefficients to float32
and sum in the same order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import colorspace as jcs  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import colorspace as tcs  # noqa: E402


def _buf(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("w,h,extra", [(64, 48, 0), (320, 256, 0),
                                       (33, 20, 0), (40, 25, 0), (17, 9, 0),
                                       (17, 9, 5), (64, 48, 7), (2, 2, 0)])
def test_nv12_to_rgb_matches_jax(w, h, extra):
    buf = _buf(w * h * 3 // 2 + extra, w * h + extra)
    want = np.asarray(jcs.nv12_to_rgb(jnp.asarray(buf), width=w, height=h))
    got = tcs.nv12_to_rgb(torch.from_numpy(buf), width=w, height=h)
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_short_nv12_buffer_is_black():
    buf = _buf(64 * 48 * 3 // 2 - 1, 1)
    want = np.asarray(jcs.nv12_to_rgb(jnp.asarray(buf), width=64, height=48))
    got = tcs.nv12_to_rgb(buf, width=64, height=48).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.any()


@pytest.mark.parametrize("h,w", [(48, 64), (256, 320)])
def test_nv12_planes_to_rgb_matches_jax_and_the_flat_buffer(h, w):
    buf = _buf(w * h * 3 // 2, h + w)
    y = buf[:w * h].reshape(h, w)
    uv = buf[w * h:].reshape(h // 2, w // 2, 2)
    want = np.asarray(jcs.nv12_planes_to_rgb(jnp.asarray(y), jnp.asarray(uv)))
    got = tcs.nv12_planes_to_rgb(torch.from_numpy(y), torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tcs.nv12_to_rgb(torch.from_numpy(buf), width=w,
                                     height=h).numpy())


def test_float_conversions_match_jax():
    rng = np.random.default_rng(2)
    y, u, v = (rng.uniform(0, 255, (37, 29)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jcs.rgb_from_yuv_f32(*map(jnp.asarray, (y, u, v))))
    got = tcs.rgb_from_yuv_f32(*map(torch.from_numpy, (y, u, v)))
    assert got.dtype == torch.float32 and got.shape == (37, 29, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    yp, up, vp = y - 16, u - 128, v - 128
    want = np.asarray(jcs.rgb_from_shifted_yuv_f32(
        *map(jnp.asarray, (yp, up, vp))))
    got = tcs.rgb_from_shifted_yuv_f32(*map(torch.from_numpy, (yp, up, vp)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
