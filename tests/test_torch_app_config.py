"""PyTorch port: the app's configs, its presets and the seeded parameters.

The port's copies of the six config classes and the three app presets equal
the JAX package's, field by field.  ``init_params`` gives JAX's tree (keys,
shapes, float32) for every preset; JAX's PRNG bits cannot be matched, so
its draws are held to their distribution: ``std`` x a normal truncated at
+-2 (max|w| <= 2 std, sample std 0.8796 std within 5 %), biases 0, LayerNorm
scales 1.  One seed gives one tree, on every call; another seed another.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu import config as jconfig  # noqa: E402
from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch import config as tconfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.app import main as tapp  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack as tvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402

PRESETS = ("corr-tiny", "small", "vittrack-t")
CLASSES = ("CaptureConfig", "DisplayConfig", "QueueConfig", "SessionConfig",
           "TelemetryConfig", "AppConfig", "ModelConfig")
# Truncated at +-2 std, a normal keeps this fraction of its std.
TRUNC_STD = 0.8796


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_config_classes_are_faithful_copies(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    jf, tf = _fields(j), _fields(t)
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, a), (_, b) in zip(tf, jf):
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), n
        else:
            assert a == b, n


def test_app_config_json_round_trip_matches_jax():
    t = tconfig.AppConfig().replace(model_path="x.npz")
    j = jconfig.AppConfig().replace(model_path="x.npz")
    assert t.to_json() == j.to_json()
    back = tconfig.AppConfig.from_json(j.to_json())
    assert back == t
    assert tconfig.DEFAULT == tconfig.AppConfig()


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_equal_jax_app_presets(preset):
    assert sorted(tconfig.PRESETS) == sorted(JAX_PRESETS) == list(PRESETS)
    assert (dataclasses.asdict(tconfig.PRESETS[preset])
            == dataclasses.asdict(JAX_PRESETS[preset]))
    assert tapp.PRESETS is tconfig.PRESETS


def _tree(preset, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return tvittrack.init_params(gen, tconfig.PRESETS[preset], device="cpu")


@pytest.mark.parametrize("preset", PRESETS)
def test_init_params_has_jax_tree(preset):
    jtree = jax.eval_shape(lambda: jvittrack.init_params(
        jax.random.PRNGKey(0), JAX_PRESETS[preset]))
    jflat = jweights._flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jtree))
    tflat = tweights.flatten(_tree(preset))
    assert sorted(tflat) == sorted(jflat)
    for k, a in jflat.items():
        assert tuple(tflat[k].shape) == a.shape, k
        assert tflat[k].dtype == torch.float32 and a.dtype == np.float32, k
    # The structure that weights.param_shapes describes (params_from_flat
    # checks every key and shape against it), head or none.
    tweights.params_from_flat(
        {k: v.numpy() for k, v in tflat.items()}, tconfig.PRESETS[preset],
        device="cpu")
    assert ("head" in _tree(preset)) == (preset != "corr-tiny")


@pytest.mark.parametrize("preset", PRESETS)
def test_init_params_statistics(preset):
    flat = tweights.flatten(_tree(preset))
    drawn = {0.02: [], 0.05: []}
    for k, t in flat.items():
        a = t.numpy()
        if k.endswith("/scale"):
            assert (a == 1).all(), k
        elif k.endswith("/bias"):
            assert (a == 0).all(), k
        else:
            std = 0.05 if k.startswith("head/") else 0.02
            assert np.abs(a).max() <= 2 * std, k
            drawn[std].append(a.ravel())
    for std, parts in drawn.items():
        if not parts:
            assert preset == "corr-tiny" and std == 0.05
            continue
        sample = np.concatenate(parts)
        assert abs(sample.std() / (TRUNC_STD * std) - 1) < 0.05, (std, sample.std())
        assert abs(sample.mean()) < 0.05 * std
        # Truncated, not clipped: no mass piled up at the bounds.
        assert (np.abs(sample) > 1.99 * std).mean() < 0.005


def test_init_params_is_seeded():
    a, b, c = (tweights.flatten(_tree("small", s)) for s in (0, 0, 1))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    drawn = [k for k in a if k.endswith("kernel") or "pos_embed" in k]
    assert all(not torch.equal(a[k], c[k]) for k in drawn)


def test_default_checkpoint_per_preset():
    assert tweights.default_checkpoint("corr-tiny") == ""
    for preset in ("small", "vittrack-t"):
        assert tweights.default_checkpoint(preset) == \
            tweights.checkpoint_path(preset)
