"""PyTorch port, ``media/indie.py`` (the independent eval world): the port's
own numpy copy.  Frames (``frame_rgb``, ``frame``) and every ground-truth
query (``bbox_at``, ``object_bbox_at``, ``occluder_rect_at``,
``visible_frac_at``) are bit-equal to the JAX package's for a few seeds and
every scenario option; like the original it is an RGB-only world that
shares no code with ``media/source.py``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu.media.indie import IndependentSource as JSource  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media.indie import IndependentSource  # noqa: E402

CASES = {
    "basic": dict(seed=0),
    "scale": dict(seed=1, scale_range=(0.5, 2.0), scale_period=40),
    "occlusion": dict(seed=2, occlusion=(40, 21)),
    "distractors": dict(seed=3, n_distractors=2),
    "shake": dict(seed=4, shake_px=24.0),
    "exit": dict(seed=5, exit_spec=(40, 20)),
    "drift_morph_rotation_noise": dict(seed=6, appearance_drift=0.01,
                                       morph_rate=0.02, rotation_dpf=7.5,
                                       noise_sigma=12.0),
}
FRAMES = (0, 7, 19, 20, 33)


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_and_ground_truth_bit_equal(case):
    kw = dict(obj_size=48, speed=3.0, **CASES[case])
    src, ref = IndependentSource(320, 256, **kw), JSource(320, 256, **kw)
    for i in FRAMES:
        got = src.frame_rgb(i)
        assert got.dtype == np.uint8 and got.shape == (256, 320, 3)
        np.testing.assert_array_equal(got, ref.frame_rgb(i))
        np.testing.assert_array_equal(src.frame(i), ref.frame(i))
        assert src.bbox_at(i) == ref.bbox_at(i)
        assert src.occluder_rect_at(i) == ref.occluder_rect_at(i)
        assert src.visible_frac_at(i) == ref.visible_frac_at(i)
        for k in range(1 + src.n_distractors):
            assert src.object_bbox_at(k, i) == ref.object_bbox_at(k, i)


@pytest.mark.parametrize("seed", [0, 9])
def test_full_size_frame_bit_equal(seed):
    kw = dict(obj_size=64, seed=seed, n_distractors=1, occlusion=(200, 41))
    src, ref = IndependentSource(640, 512, **kw), JSource(640, 512, **kw)
    for i in (0, 100):
        np.testing.assert_array_equal(src.frame_rgb(i), ref.frame_rgb(i))


@pytest.mark.parametrize("fmt", ["nv12", "yuy2"])
def test_rgb_only_world(fmt):
    for cls in (IndependentSource, JSource):
        with pytest.raises(AssertionError):
            cls(320, 256, fmt=fmt)


def test_shares_no_code_with_the_training_worlds():
    import gstreamer_vit_tracker_tpu_torch.media.indie as mod

    with open(os.path.abspath(mod.__file__)) as f:
        text = f.read()
    assert "from .source" not in text and "media.source" not in text.split(
        '"""', 2)[2]
