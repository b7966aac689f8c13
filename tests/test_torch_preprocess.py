"""PyTorch port: crop geometry, resampling and the NV12 preprocess against
the JAX package, on the same seeded 1080p NV12 frame.

Geometry and sampling matrices must be identical in float32.  The crop is
held to atol 1e-4 in float32 and 0.05 in bf16 (on the normalised output:
a bf16 ulp there is up to ~0.03); both run bit-identical on the CPU today.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import preprocess as jpp  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import resample as jrs  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import preprocess as tpp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import resample as trs  # noqa: E402

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BAND = 1152

# (bbox, factor): inside the frame; hanging over the bottom-right corner;
# a window larger than the band (ramped re-detection size).
WINDOWS = {
    "inside": ([900.0, 500.0, 120.0, 90.0], 4.0),
    "over_edge": ([1850.0, 1010.0, 100.0, 90.0], 4.0),
    "larger_than_band": ([700.0, 300.0, 300.0, 260.0], 4.48),
}


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (1080, 1920), dtype=np.uint8)
    uv = rng.integers(0, 256, (540, 960, 2), dtype=np.uint8)
    return y, uv


def _windows(bbox, factor):
    jw = jpp.crop_window(jnp.asarray(bbox, jnp.float32), factor)
    tw = tpp.crop_window(torch.tensor(bbox, dtype=torch.float32), factor)
    return jw, tw


@pytest.mark.parametrize("bbox", [[10.0, 20.0, 30.0, 40.0],
                                  [0.0, 0.0, 0.2, 0.1],
                                  [100.5, 200.25, 17.0, 333.0],
                                  [-5.0, 1070.0, 64.0, 64.0]])
@pytest.mark.parametrize("factor", [2.0, 4.0, 5.6])
def test_crop_window_exact(bbox, factor):
    jw, tw = _windows(bbox, factor)
    for a, b in zip(jw, tw):
        assert b.dtype == torch.float32
        assert float(a) == float(b)


@pytest.mark.parametrize("name", sorted(WINDOWS))
@pytest.mark.parametrize("hw", [(1080, 1920), (2160, 3840), (720, 1280)])
def test_band_origin_exact(name, hw):
    jw, tw = _windows(*WINDOWS[name])
    ja = jpp.band_origin(jw, hw[0], hw[1], BAND)
    ta = tpp.band_origin(tw, hw[0], hw[1], BAND)
    assert [int(a) for a in ja] == [int(b) for b in ta]


@pytest.mark.parametrize("out,src,start,scale",
                         [(256, 1152, -37.5, 1.625), (128, 1080, 512.25, 0.75),
                          (64, 960, 101.0, 3.1), (16, 40, -3.0, 2.5)])
def test_sampling_matrix_and_fold_exact(out, src, start, scale):
    jm = np.asarray(jrs.sampling_matrix(out, src, start, scale))
    tm = trs.sampling_matrix(out, src, torch.tensor(start), torch.tensor(scale))
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(trs.fold_half_res(tm).numpy(),
                                  np.asarray(jrs.fold_half_res(jnp.asarray(jm))))
    with pytest.raises(ValueError):
        trs.fold_half_res(tm[:, :-1])


@pytest.mark.parametrize("name", sorted(WINDOWS))
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_preprocess_nv12_matches_jax(frame, name, dtype, atol):
    y, uv = frame
    jw, tw = _windows(*WINDOWS[name])
    if name == "larger_than_band":
        assert float(tw.size) > BAND
    out = jpp.preprocess_nv12(jnp.asarray(y), jnp.asarray(uv), jw, 256, MEAN,
                              STD, dtype=getattr(jnp, dtype), band=BAND)
    got = tpp.preprocess_nv12(torch.from_numpy(y), torch.from_numpy(uv), tw,
                              256, MEAN, STD, dtype=getattr(torch, dtype),
                              band=BAND)
    assert got.shape == (256, 256, 3) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(out, np.float32), atol=atol, rtol=0)
