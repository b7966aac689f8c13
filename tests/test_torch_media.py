"""PyTorch port: its own copy of ``media/`` against the JAX package's.

For the same seeds the port's sources give byte-equal frames:
``SyntheticSource`` in rgb, nv12 and yuy2 with 0 and 2 distractors (and the
distractor boxes), ``HeldoutSource`` and ``FlakySource`` (drops, corrupted
frames, transport faults).  A y4m file written by the port reads back in
the port and in JAX's ``FileSource``; ``FileSink`` takes a tensor as it
takes an array.  ``gst.parse_launch`` maps the reference's own pipeline
lines onto the same spec, ``apply_to_args`` onto the same flags, and
``V4L2Source`` on a missing device raises as JAX's does.
"""

import argparse
import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu.media import gst as jgst  # noqa: E402
from gstreamer_vit_tracker_tpu.media import queue as jqueue  # noqa: E402
from gstreamer_vit_tracker_tpu.media import sink as jsink  # noqa: E402
from gstreamer_vit_tracker_tpu.media import source as jsource  # noqa: E402
from gstreamer_vit_tracker_tpu.media import v4l2 as jv4l2  # noqa: E402
from gstreamer_vit_tracker_tpu.media import y4m as jy4m  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media import gst as tgst  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media import queue as tqueue  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media import sink as tsink  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media import source as tsource  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media import v4l2 as tv4l2  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media import y4m as ty4m  # noqa: E402

W, H = 320, 256
FRAMES = (0, 1, 7, 30)


def _assert_frames_equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for p, q in zip(a, b):
            assert p.dtype == q.dtype == np.uint8
            np.testing.assert_array_equal(p, q)
    else:
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_distractors", (0, 2))
@pytest.mark.parametrize("fmt", ("rgb", "nv12", "yuy2"))
def test_synthetic_frames_are_byte_equal(fmt, n_distractors):
    kw = dict(seed=3, fmt=fmt, n_distractors=n_distractors)
    j, t = jsource.SyntheticSource(W, H, **kw), tsource.SyntheticSource(W, H, **kw)
    for i in FRAMES:
        _assert_frames_equal(t.frame(i), j.frame(i))
        assert t.bbox_at(i) == j.bbox_at(i)
        for k in range(1, n_distractors + 1):
            assert t.object_bbox_at(k, i) == j.object_bbox_at(k, i)


def test_synthetic_options_are_byte_equal():
    kw = dict(seed=5, fmt="rgb", scale_range=(0.6, 1.4), occlusion=(5, 12),
              shake_px=2.0, rotation_dpf=1.5, noise_sigma=3.0,
              appearance_drift=0.02, morph_rate=0.01)
    j, t = jsource.SyntheticSource(W, H, **kw), tsource.SyntheticSource(W, H, **kw)
    for i in FRAMES:
        _assert_frames_equal(t.frame(i), j.frame(i))
        assert t.bbox_at(i) == j.bbox_at(i)


@pytest.mark.parametrize("fmt", ("rgb", "nv12", "yuy2"))
def test_heldout_frames_are_byte_equal(fmt):
    j = jsource.HeldoutSource(W, H, seed=2, fmt=fmt)
    t = tsource.HeldoutSource(W, H, seed=2, fmt=fmt)
    for i in FRAMES:
        _assert_frames_equal(t.frame(i), j.frame(i))
        assert t.bbox_at(i) == j.bbox_at(i)


@pytest.mark.parametrize("fmt", ("rgb", "nv12"))
def test_flaky_source_is_byte_equal(fmt):
    def make(mod):
        return mod.FlakySource(mod.SyntheticSource(W, H, seed=1, fmt=fmt),
                               drop_every=3, corrupt_every=5, fault_every=7,
                               seed=4)

    j, t = make(jsource), make(tsource)
    faults = 0
    for i in range(16):
        try:
            a = j.frame(i)
        except OSError as e:
            with pytest.raises(OSError, match=str(e)):
                t.frame(i)
            j.reopen()
            t.reopen()
            faults += 1
            continue
        _assert_frames_equal(t.frame(i), a)
    assert faults == 2 and t.reopen_count == j.reopen_count == 2


def test_colour_helpers_are_byte_equal():
    rgb = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    _assert_frames_equal(tsource.rgb_to_nv12_planes(rgb),
                         jsource.rgb_to_nv12_planes(rgb))
    _assert_frames_equal(tsource.rgb_to_yuy2(rgb), jsource.rgb_to_yuy2(rgb))


def test_y4m_round_trip_and_read_back_by_jax(tmp_path):
    src = tsource.SyntheticSource(W, H, seed=6, fmt="rgb")
    path = str(tmp_path / "clip.y4m")
    writer = ty4m.Y4MWriter(path, fps=30.0)
    for i in range(4):
        writer.write_rgb(src.frame(i))
    writer.close()
    with open(path, "rb") as f:
        ours = f.read()
    jpath = str(tmp_path / "clip_jax.y4m")
    jw = jy4m.Y4MWriter(jpath, fps=30.0)
    for i in range(4):
        jw.write_rgb(src.frame(i))
    jw.close()
    with open(jpath, "rb") as f:
        assert f.read() == ours
    tfs, jfs = tsource.FileSource(path), jsource.FileSource(path)
    assert (tfs.num_frames, tfs.width, tfs.height, tfs.fmt) == \
        (jfs.num_frames, jfs.width, jfs.height, jfs.fmt) == (4, W, H, "nv12")
    for i in range(4):
        want = tsource.rgb_to_nv12_planes(src.frame(i))
        _assert_frames_equal(tfs.frame(i), want)
        _assert_frames_equal(jfs.frame(i), want)


def test_file_sink_takes_a_tensor(tmp_path):
    frames = [np.random.default_rng(i).integers(0, 256, (H, W, 3), np.uint8)
              for i in range(3)]
    for suffix in (".y4m", ".npy"):
        tp, jp = str(tmp_path / f"t{suffix}"), str(tmp_path / f"j{suffix}")
        ts, js = tsink.FileSink(tp, fps=30.0), jsink.FileSink(jp, fps=30.0)
        assert ts.wants_host_pixels
        for f in frames:
            ts.write(torch.tensor(f))
            js.write(f)
        ts.close()
        js.close()
        with open(tp, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read()
    null = tsink.NullSink()
    null.write(torch.zeros(2, 2))
    assert null.frames == 1
    np.testing.assert_array_equal(tsink.host_pixels(torch.tensor(frames[0])),
                                  frames[0])


def test_frame_queue_drops_oldest_like_jax():
    tq, jq = tqueue.FrameQueue(3), jqueue.FrameQueue(3)
    for i in range(5):
        assert tq.push(i) == jq.push(i)
    assert [tq.try_pop() for _ in range(4)] == [jq.try_pop() for _ in range(4)]


REFERENCE_IR = (
    "v4l2src device=/dev/video21 io-mode=4 do-timestamp=true ! "
    "video/x-raw,format=YUY2,width=640,height=512,framerate=60/1 ! "
    "videoconvert n-threads=4 ! video/x-raw,format=RGB ! identity ! "
    "rgaconvert ! video/x-raw,format=RGB,width=1280,height=1024 ! "
    "queue max-size-buffers=3 leaky=downstream ! "
    "kmssink sync=false connector-id=231 plane-id=72")
REFERENCE_LEGACY = (
    "v4l2src device=/dev/video21 ! "
    "video/x-raw,format=NV12,width=1920,height=1080,framerate=60/1 ! "
    "identity ! queue max-size-buffers=3 leaky=2 ! kmssink sync=false")
FILE_LINE = ("filesrc location=in.y4m ! decodebin ! videoscale ! "
             "video/x-raw,width=320,height=256 ! filesink location=out.y4m")


@pytest.mark.parametrize("line", (REFERENCE_IR, REFERENCE_LEGACY, FILE_LINE))
def test_gst_parse_launch_gives_the_same_spec(line):
    want = dataclasses.asdict(jgst.parse_launch(line))
    got = dataclasses.asdict(tgst.parse_launch(line))
    assert got == want
    ja, ta = argparse.Namespace(), argparse.Namespace()
    jgst.apply_to_args(jgst.parse_launch(line), ja)
    tgst.apply_to_args(tgst.parse_launch(line), ta)
    assert vars(ta) == vars(ja)


@pytest.mark.parametrize("line", (
    "v4l2src ! weirdelement ! fakesink", "fakesink",
    "videotestsrc ! audio/x-raw,rate=48000 ! fakesink",
    "v4l2src ! video/x-raw,format=BGRx ! fakesink", "filesrc ! fakesink",
    "videotestsrc ! videotestsrc ! fakesink", "videotestsrc !! fakesink"))
def test_gst_rejects_what_jax_rejects(line):
    with pytest.raises(ValueError) as jerr:
        jgst.parse_launch(line)
    with pytest.raises(ValueError) as terr:
        tgst.parse_launch(line)
    assert str(terr.value) == str(jerr.value)


def test_v4l2_missing_device_raises_as_jax(tmp_path):
    missing = str(tmp_path / "video99")
    with pytest.raises(FileNotFoundError) as jerr:
        jsource.V4L2Source(missing)
    with pytest.raises(FileNotFoundError) as terr:
        tsource.V4L2Source(missing)
    assert str(terr.value) == str(jerr.value)
    for name in ("v4l2_format", "v4l2_buffer", "v4l2_requestbuffers",
                 "v4l2_streamparm"):
        assert ctypes.sizeof(getattr(tv4l2, name)) == \
            ctypes.sizeof(getattr(jv4l2, name))
    for code in ("VIDIOC_S_FMT", "VIDIOC_REQBUFS", "VIDIOC_QBUF",
                 "VIDIOC_DQBUF", "VIDIOC_STREAMON", "VIDIOC_S_PARM",
                 "PIX_FMT_YUYV", "PIX_FMT_MJPEG"):
        assert getattr(tv4l2, code) == getattr(jv4l2, code)
