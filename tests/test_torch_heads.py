"""PyTorch port: conv heads, hann windows and the decode against the JAX
package.  Heads in float32 within atol 1e-5 (on the CPU both sides use
full float32 convolutions); hann windows and the decode exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import heads as jheads  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import heads as theads  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402


def _heads(preset):
    cfg = JAX_PRESETS[preset]
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg))
    jparams = jweights.load_npz(tweights.checkpoint_path(preset), like)
    tparams = tweights.load_npz(tweights.checkpoint_path(preset),
                                PRESETS[preset], device="cpu")
    return jparams["head"], tparams["head"]


def _feat(preset, seed):
    cfg = PRESETS[preset]
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (2, cfg.num_search_tokens, cfg.embed_dim)).astype(np.float32)


def _assert_maps(got, ref, atol):
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=0)


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
def test_conv_head_matches_jax(preset):
    jhead, thead = _heads(preset)
    feat = _feat(preset, 1)
    ref = jheads.conv_head(jhead, jnp.asarray(feat), JAX_PRESETS[preset])
    got = theads.conv_head(thead, torch.from_numpy(feat), PRESETS[preset])
    _assert_maps(got, ref, 1e-5)


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
def test_conv_head_grouped_matches_jax(preset):
    jhead, thead = _heads(preset)
    feat = _feat(preset, 2)
    ref = jheads.conv_head_grouped(jheads.group_head_params(jhead),
                                   jnp.asarray(feat), JAX_PRESETS[preset])
    got = theads.conv_head_grouped(theads.group_head_params(thead),
                                   torch.from_numpy(feat), PRESETS[preset])
    _assert_maps(got, ref, 1e-5)
    # The grouped head computes the towers' maps.
    _assert_maps(got, theads.conv_head(thead, torch.from_numpy(feat),
                                       PRESETS[preset]), 1e-5)


def test_conv_head_bf16_close_to_jax():
    jhead, thead = _heads("vittrack-t")
    feat = _feat("vittrack-t", 3)
    bcfg = JAX_PRESETS["vittrack-t"]
    ref = jheads.conv_head_grouped(jheads.group_head_params(jhead),
                                   jnp.asarray(feat, jnp.bfloat16), bcfg)
    got = theads.conv_head_grouped(theads.group_head_params(thead),
                                   torch.from_numpy(feat).bfloat16(),
                                   PRESETS["vittrack-t"])
    _assert_maps(got, ref, 0.02)


@pytest.mark.parametrize("fs", [4, 8, 16, 17, 20])
@pytest.mark.parametrize("mode", ["interior", "opencv"])
def test_hanning_exact(fs, mode):
    ref = np.asarray(jheads.hanning_2d(fs, mode))
    got = theads.hanning_2d(fs, mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hanning_unknown_mode_raises():
    with pytest.raises(ValueError):
        theads.hanning_2d(16, "gaussian")


def _decode_inputs(rng, fs):
    score = rng.uniform(0, 1, (fs, fs)).astype(np.float32)
    offset = rng.uniform(0, 1, (fs, fs, 2)).astype(np.float32)
    size = rng.uniform(0, 1, (fs, fs, 2)).astype(np.float32)
    return score, offset, size


def _decode_both(score, offset, size, fs, mode, prev):
    ref = jheads.decode_maps(jnp.asarray(score), jnp.asarray(offset),
                             jnp.asarray(size), jheads.hanning_2d(fs, mode),
                             jnp.asarray(prev))
    got = theads.decode_maps(torch.from_numpy(score), torch.from_numpy(offset),
                             torch.from_numpy(size), theads.hanning_2d(fs, mode),
                             torch.from_numpy(prev))
    return ref, got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["interior", "opencv"])
def test_decode_maps_exact(seed, mode):
    rng = np.random.default_rng(seed)
    fs = 16
    score, offset, size = _decode_inputs(rng, fs)
    size[rng.uniform(size=(fs, fs)) < 0.3] = 0.0      # zero size -> prev
    prev = np.asarray([0.21, 0.17], np.float32)
    (jb, jc), (tb, tc) = _decode_both(score, offset, size, fs, mode, prev)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert float(tc) == float(jc)


def test_decode_maps_tie_takes_first_index_and_zero_size_falls_back():
    fs = 8
    score = np.zeros((fs, fs), np.float32)
    score[2, 5] = score[5, 2] = 0.9          # same hann weight by symmetry
    offset = np.full((fs, fs, 2), 0.5, np.float32)
    offset[2, 5] = [0.1, 0.2]
    offset[5, 2] = [0.7, 0.8]
    size = np.full((fs, fs, 2), 0.3, np.float32)
    size[2, 5] = [0.0, 0.4]
    prev = np.asarray([0.25, 0.5], np.float32)
    hann = theads.hanning_2d(fs)
    assert float(hann[2, 5]) == float(hann[5, 2])
    (jb, jc), (tb, tc) = _decode_both(score, offset, size, fs, "interior", prev)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert float(tc) == float(jc)
    # Row-major first maximum: cell (iy=2, ix=5), its w from prev.
    np.testing.assert_allclose(tb.numpy(), [(5 + 0.1) / fs, (2 + 0.2) / fs,
                                            0.25, 0.4])
