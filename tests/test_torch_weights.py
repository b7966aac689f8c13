"""PyTorch port: config copy and checkpoint loading against the JAX package.

The same npz arrays go to JAX's ``weights.load_npz`` and to the port's
``load_npz``; every leaf must come out with JAX's shape and the same
values, and the derived grouped head must be identical.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import heads as jheads  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch import config as tconfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import heads as theads  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402

PRESETS = ("small", "vittrack-t")


def _jax_flat(preset):
    cfg = JAX_PRESETS[preset]
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg))
    return jweights._flatten(jweights.load_npz(
        tweights.checkpoint_path(preset), like))


def _torch_flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _torch_flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _torch_flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def test_model_config_is_a_faithful_copy():
    jf = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.ModelConfig)}
    assert tf == jf
    for prop in ("feat_size", "template_feat_size", "num_template_tokens",
                 "num_search_tokens", "num_tokens"):
        for preset in PRESETS:
            assert (getattr(tconfig.PRESETS[preset], prop)
                    == getattr(JAX_PRESETS[preset], prop))


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_app_presets(preset):
    assert (dataclasses.asdict(tconfig.PRESETS[preset])
            == dataclasses.asdict(JAX_PRESETS[preset]))


@pytest.mark.parametrize("preset", PRESETS)
def test_checkpoint_loads_like_jax(preset):
    jflat = _jax_flat(preset)
    tflat = _torch_flat(tweights.load_npz(tweights.checkpoint_path(preset),
                                          tconfig.PRESETS[preset],
                                          device="cpu"))
    assert sorted(tflat) == sorted(jflat)
    if preset == "vittrack-t":
        assert len(tflat) == 174
    for k, a in jflat.items():
        t = tflat[k]
        assert tuple(t.shape) == a.shape, k
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a, err_msg=k)


def _flat_npz(preset):
    with np.load(tweights.checkpoint_path(preset)) as d:
        return {k: d[k] for k in d.files}


def test_missing_key_raises():
    flat = _flat_npz("small")
    del flat["backbone/blocks/2/mlp1/bias"]
    with pytest.raises(KeyError, match="blocks/2/mlp1/bias"):
        tweights.params_from_flat(flat, tconfig.PRESETS["small"], device="cpu")


def test_wrong_shape_raises():
    flat = _flat_npz("small")
    flat["head/size/1/kernel"] = flat["head/size/1/kernel"][:, :, :-1]
    with pytest.raises(ValueError, match="head/size/1/kernel"):
        tweights.params_from_flat(flat, tconfig.PRESETS["small"], device="cpu")


def test_wrong_config_raises():
    with pytest.raises(ValueError, match="shape mismatch"):
        tweights.load_npz(tweights.checkpoint_path("small"),
                          tconfig.PRESETS["vittrack-t"], device="cpu")


def test_load_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tweights.load_npz(tweights.checkpoint_path("small"),
                          tconfig.PRESETS["small"])


@pytest.mark.parametrize("preset", PRESETS)
def test_group_head_params_matches_jax(preset):
    cfg = JAX_PRESETS[preset]
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg))
    jhead = jheads.group_head_params(jweights.load_npz(
        tweights.checkpoint_path(preset), like)["head"])
    thead = theads.group_head_params(tweights.load_npz(
        tweights.checkpoint_path(preset), tconfig.PRESETS[preset],
        device="cpu")["head"])
    assert len(thead["layers"]) == len(jhead["layers"]) == 4
    for jl, tl in zip(jhead["layers"], thead["layers"]):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))


def test_checkpoints_ship():
    for preset in PRESETS:
        assert os.path.exists(tweights.checkpoint_path(preset))
