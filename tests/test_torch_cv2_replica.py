"""PyTorch port, ``compat/cv2vit.py``: the measured ``cv2.TrackerVit``
spec.  ``Cv2VitReplica`` (cv2 + numpy, copied) returns cv2.TrackerVit's
integer Rects and scores on the port's flagship export; the port's
``MatchedCropTracker`` (the port's f32 model under cv2's crop / decode /
integer-Rect pipeline) gives the JAX package's integer Rects, scores within
1e-4, on the f32 ``small`` preset, with cv2's integer window and with the
float window of ``ops/preprocess.py``.  cv2 is imported only inside the
functions that use it; the cases that need it skip, with their reason,
where it is missing."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.compat import cv2vit as jcv2vit  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch import compat  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.compat import (CV2_50_HANN_PEAK,  # noqa: E402
                                                    Cv2VitReplica,
                                                    MatchedCropTracker,
                                                    hann_interior_np)
from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media.source import SyntheticSource  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import export_onnx, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models.heads import hanning_2d  # noqa: E402

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cv2():
    return pytest.importorskip("cv2", reason="cv2 is not installed")


def _frames(n, seed, obj=48):
    src = SyntheticSource(640, 512, obj_size=obj, seed=seed, speed=3.0)
    return ([src.frame_rgb(i) for i in range(n)],
            tuple(int(v) for v in src.bbox_at(0)))


def test_interior_hann_is_the_decode_window():
    for n in (8, 16):
        np.testing.assert_allclose(hanning_2d(n, "interior", CPU).numpy(),
                                   hann_interior_np(n), atol=1e-6)
        np.testing.assert_array_equal(hann_interior_np(n),
                                      jcv2vit.hann_interior_np(n))
    assert CV2_50_HANN_PEAK == jcv2vit.CV2_50_HANN_PEAK


def test_importing_compat_imports_no_cv2():
    code = ("import sys; import gstreamer_vit_tracker_tpu_torch.compat; "
            "import gstreamer_vit_tracker_tpu_torch.scripts.eval_tracking; "
            "assert 'cv2' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_replica_equals_cv2_trackervit_on_the_port_export(tmp_path):
    cv2 = _cv2()
    cfg = ModelConfig(dtype="float32")
    params = weights.load_npz(weights.checkpoint_path("vittrack-t"), cfg,
                              device=CPU)
    path = str(tmp_path / "vittrack_cv2.onnx")
    export_onnx.export_vittrack(params, cfg, path, input_transform="cv2-5.0")
    frames, bb0 = _frames(9, seed=17)
    p = cv2.TrackerVit_Params()
    p.net = path
    tr = cv2.TrackerVit_create(p)
    tr.init(frames[0], bb0)
    rep = Cv2VitReplica(path)
    rep.init(frames[0], bb0)
    for i in range(1, len(frames)):
        _ok, box = tr.update(frames[i])
        r = rep.update(frames[i])
        assert tuple(box) == r, f"frame {i}: cv2 {tuple(box)} != replica {r}"
        assert abs(tr.getTrackingScore() - rep.score) < 1e-6, f"frame {i}"


@pytest.fixture(scope="module")
def small_trees():
    """The shipped ``small`` checkpoint in both packages' trees (JAX's
    ``load_npz`` fills a numpy tree of the same structure)."""
    path, cfg = weights.checkpoint_path("small"), PRESETS["small"]
    tparams = weights.load_npz(path, cfg, device=CPU)
    jparams = jweights.load_npz(path, weights.tree_to_numpy(tparams))
    return JAX_PRESETS["small"], jparams, cfg, tparams


@pytest.mark.parametrize("window,feedback", [("int", "int"),
                                             ("float", "float")])
def test_matched_crop_tracker_equals_jax(small_trees, window, feedback):
    if window == "int":
        _cv2()
    jcfg, jparams, cfg, tparams = small_trees
    frames, bb0 = _frames(11, seed=29)
    ours = MatchedCropTracker(tparams, cfg, window=window, feedback=feedback,
                              device=CPU)
    theirs = jcv2vit.MatchedCropTracker(jparams, jcfg, window=window,
                                        feedback=feedback)
    ours.init(frames[0], bb0)
    theirs.init(frames[0], bb0)
    for i in range(1, len(frames)):
        got, want = ours.update(frames[i]), theirs.update(frames[i])
        assert got == want, f"frame {i}: {got} != {want}"
        assert abs(ours.score - theirs.score) < 1e-4, f"frame {i}"
    assert ours.score > 0.3


def test_matched_crop_requires_f32():
    with pytest.raises(ValueError, match="f32"):
        MatchedCropTracker({}, ModelConfig(), device=CPU)   # bf16 default


def test_installed_cv2_matches_baked_convention():
    _cv2()
    got = compat.verify_cv2_convention()
    assert abs(got["hann_peak"] - CV2_50_HANN_PEAK) < 1e-4


def test_verify_aborts_on_changed_convention(monkeypatch):
    fixed = {"hann_peak": CV2_50_HANN_PEAK,
             "slope": [1 / 0.229, 1 / 0.224, 1 / 0.225],
             "crossing": [0.485, 0.456, 0.406]}
    monkeypatch.setattr(compat.cv2vit, "measure_cv2_convention",
                        lambda workdir=None: fixed)
    with pytest.raises(RuntimeError, match="convention differs"):
        compat.cv2vit.verify_cv2_convention()
