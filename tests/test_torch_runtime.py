"""PyTorch port: the native host runtime (``runtime/``), its own copy of
``framering.cpp`` built with g++ into the git-ignored ``build/torch_runtime/``.

The cases of ``tests/test_runtime_native.py`` on the port's runtime (ring
semantics, the converters against JAX's op, the frame generator), the
converters bit-equal to the port's torch op at even and odd sizes and on
short buffers, and the fallback: with the compiler made to fail the
library is unavailable and the converters still answer, through the op.
"""

import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.ops import colorspace as jcs  # noqa: E402
from gstreamer_vit_tracker_tpu_torch import runtime  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import colorspace as tcs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    if not runtime.available():
        pytest.skip("no C++ toolchain to build the native runtime")
    return runtime


def test_library_is_built_from_the_ports_source_outside_it(native):
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "torch_runtime")
    assert native.load()._name == path
    assert native.SOURCE == os.path.join(
        REPO, "gstreamer_vit_tracker_tpu_torch", "runtime", "native",
        "framering.cpp")
    ignored = subprocess.run(["git", "check-ignore", "-q", path], cwd=REPO)
    assert ignored.returncode == 0
    assert not [f for f in os.listdir(os.path.dirname(native.SOURCE))
                if f.endswith(".so")]


def test_ring_drop_oldest(native):
    ring = native.NativeFrameRing(capacity=3, slot_bytes=16)
    for i in range(5):
        ring.push(np.full(16, i, np.uint8))
    assert len(ring) == 3
    assert ring.stats["dropped"] == 2
    seq, frame = ring.pop()
    assert frame[0] == 2            # oldest two (0, 1) were dropped
    assert seq == 3                 # sequence numbers are 1-based
    assert ring.pop()[1][0] == 3
    assert ring.pop()[1][0] == 4
    assert ring.pop() is None
    ring.close()


def test_ring_producer_never_blocks(native):
    ring = native.NativeFrameRing(capacity=2, slot_bytes=8)
    for i in range(10_000):
        ring.push(np.zeros(8, np.uint8))
    assert ring.stats["pushed"] == 10_000
    assert ring.stats["dropped"] == 9_998
    with pytest.raises(ValueError):
        ring.push(np.zeros(9, np.uint8))
    ring.close()


# Even sizes; odd width, height or both (the reads past the buffer's end
# take its last byte, as JAX's gather clamps).
SIZES = ((128, 96), (64, 48), (33, 20), (40, 25), (17, 9))


@pytest.mark.parametrize("w,h", SIZES)
def test_native_nv12_matches_op_and_jax(native, w, h):
    buf = np.random.default_rng(w * h).integers(
        0, 256, size=w * h * 3 // 2, dtype=np.uint8)
    got = native.nv12_to_rgb(buf, w, h, num_threads=4)
    op = tcs.nv12_to_rgb(torch.from_numpy(buf), width=w, height=h).numpy()
    jx = np.asarray(jcs.nv12_to_rgb(jnp.asarray(buf), width=w, height=h))
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, op)
    np.testing.assert_array_equal(got, jx)


def test_native_nv12_short_buffer_is_black(native):
    buf = np.full(64 * 48 * 3 // 2 - 1, 200, np.uint8)
    got = native.nv12_to_rgb(buf, 64, 48)
    np.testing.assert_array_equal(got, np.zeros((48, 64, 3), np.uint8))
    np.testing.assert_array_equal(
        got, np.asarray(jcs.nv12_to_rgb(jnp.asarray(buf), width=64,
                                        height=48)))


@pytest.mark.parametrize("w,h", ((64, 48), (30, 7)))
def test_native_yuy2_matches_op_and_jax(native, w, h):
    buf = np.random.default_rng(w + h).integers(0, 256, size=w * h * 2,
                                                dtype=np.uint8)
    got = native.yuy2_to_rgb(buf, w, h, num_threads=2)
    op = tcs.yuy2_to_rgb(torch.from_numpy(buf), width=w, height=h).numpy()
    jx = np.asarray(jcs.yuy2_to_rgb(jnp.asarray(buf), width=w, height=h))
    np.testing.assert_array_equal(got, op)
    np.testing.assert_array_equal(got, jx)
    with pytest.raises(ValueError):
        native.yuy2_to_rgb(buf, w + 1, h)


def test_synth_nv12_generator(native):
    f = native.synth_nv12(64, 48, 10, 10, 16)
    assert f.shape == (64 * 48 * 3 // 2,)
    y = f[: 64 * 48].reshape(48, 64)
    # Object region is textured (has variance); background is a gradient.
    assert y[10:26, 10:26].std() > 10


def test_failed_build_falls_back_to_the_op(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(runtime, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_load_failed", False)
    assert not runtime.build()
    assert not runtime.available()
    assert not os.path.exists(runtime.library_path())
    buf = np.random.default_rng(3).integers(0, 256, size=33 * 20 * 3 // 2,
                                            dtype=np.uint8)
    np.testing.assert_array_equal(
        runtime.nv12_to_rgb(buf, 33, 20),
        np.asarray(jcs.nv12_to_rgb(jnp.asarray(buf), width=33, height=20)))
    yuy2 = buf[:16 * 10 * 2]
    np.testing.assert_array_equal(
        runtime.yuy2_to_rgb(yuy2, 16, 10),
        tcs.yuy2_to_rgb(torch.from_numpy(yuy2), width=16, height=10).numpy())
    with pytest.raises(RuntimeError):
        runtime.synth_nv12(64, 48, 10, 10, 16)
    with pytest.raises(RuntimeError):
        runtime.NativeFrameRing(2, 8)
