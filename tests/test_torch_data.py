"""PyTorch port, ``train/data.py``: the port's own numpy copy on its own
``media/source.py``.  For one seed its batches are bit-equal to the JAX
package's: ``make_batch``, ``make_dataset`` and ``batch_iterator``, for every
diversity table (v1, v2, v3) and the sampling knobs, at the ``small`` and
flagship crop sizes, a few samples each.  ``set_diversity`` is module-level
state in both packages, so every case resets both to v1."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.train import data as jdata  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.train import data as tdata  # noqa: E402

KNOBS = {
    "defaults": {},
    "border": dict(border_frac=0.9),
    "full_occ": dict(full_occ_frac=0.6),
    "rotation": dict(rotation_frac=0.7),
    "fade": dict(fade_frac=0.7),
}


@pytest.fixture(autouse=True)
def diversity_reset():
    yield
    jdata.set_diversity("v1")
    tdata.set_diversity("v1")


def _set(div):
    jdata.set_diversity(div)
    tdata.set_diversity(div)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
@pytest.mark.parametrize("div", ["v1", "v2", "v3"])
def test_make_dataset_bit_equal(preset, div):
    _set(div)
    seed = {"v1": 3, "v2": 5, "v3": 11}[div]
    got = tdata.make_dataset(seed, 3, PRESETS[preset])
    want = jdata.make_dataset(seed, 3, JAX_PRESETS[preset])
    _equal(got, want)
    assert got[0].dtype == np.uint8 and got[2].dtype == np.float32


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_make_dataset_knobs_bit_equal(knob):
    _set("v2")
    kw = KNOBS[knob]
    got = tdata.make_dataset(7, 4, PRESETS["small"], **kw)
    want = jdata.make_dataset(7, 4, JAX_PRESETS["small"], **kw)
    _equal(got, want)


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
@pytest.mark.parametrize("div", ["v1", "v3"])
def test_make_batch_bit_equal(preset, div):
    _set(div)
    got = tdata.make_batch(np.random.default_rng(21), 2, PRESETS[preset],
                           border_frac=0.5)
    want = jdata.make_batch(np.random.default_rng(21), 2,
                            JAX_PRESETS[preset], border_frac=0.5)
    _equal(got, want)
    assert got[0].dtype == np.float64      # normalised, as JAX's


def test_batch_iterator_bit_equal():
    cfg, jcfg = PRESETS["small"], JAX_PRESETS["small"]
    it, jit = tdata.batch_iterator(4, 2, cfg), jdata.batch_iterator(4, 2, jcfg)
    for _ in range(2):
        _equal(next(it), next(jit))


def test_set_diversity_clears_the_pool_and_rejects_unknown():
    tdata.make_dataset(0, 1, PRESETS["small"])
    assert tdata._SOURCE_POOL
    tdata.set_diversity("v3")
    assert not tdata._SOURCE_POOL and tdata._DIVERSITY == "v3"
    with pytest.raises(AssertionError):
        tdata.set_diversity("v9")
