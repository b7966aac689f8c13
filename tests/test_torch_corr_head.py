"""PyTorch port: the training-free correlation head and the corr-tiny preset.

``corr_head`` and ``_parabolic_offsets`` against the JAX package's on the
same seeded float32 inputs, for an even and an odd central kernel (tc 4 and
5: XLA's ``SAME`` padding of an even kernel puts the peak half a cell early,
which the half-cell anchor corrects) at B = 1 and 3: scores and sizes to
1e-5, and the offsets to 1e-5 wherever the decode can read them.  Then
``corr-tiny`` tracked through ``core`` beside JAX's ``core`` on JAX's seeded
weights carried across through its ``save_npz``: 10 free-running updates
held to bbox 1e-2 px and score 1e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import heads as jheads  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media.source import SyntheticSource  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import heads as theads  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack as tvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402

CPU = torch.device("cpu")


def _inputs(cfg, b, seed):
    """Seeded template and search tokens, the search map holding a copy of
    the central template tokens so the correlation has a clear peak."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    z = rng.standard_normal((b, cfg.num_template_tokens, d)).astype(np.float32)
    x = rng.standard_normal((b, cfg.num_search_tokens, d)).astype(np.float32)
    tz, fs = cfg.template_feat_size, cfg.feat_size
    q = tz // 4
    zc = z.reshape(b, tz, tz, d)[:, q:tz - q, q:tz - q]
    xm = x.reshape(b, fs, fs, d)
    tc = tz - 2 * q
    for i in range(b):
        r0, c0 = 3 + 2 * i, 5 + i
        xm[i, r0:r0 + tc, c0:c0 + tc] = 0.3 * xm[i, r0:r0 + tc, c0:c0 + tc] \
            + zc[i]
    return z, xm.reshape(b, fs * fs, d)


@pytest.mark.parametrize("b", (1, 3))
@pytest.mark.parametrize("template_size,tc", ((64, 4), (72, 5)))
def test_corr_head_matches_jax(template_size, tc, b):
    cfg = dataclasses.replace(PRESETS["corr-tiny"], template_size=template_size)
    jcfg = dataclasses.replace(JAX_PRESETS["corr-tiny"],
                               template_size=template_size)
    tz = cfg.template_feat_size
    assert tz - 2 * (tz // 4) == tc
    z, x = _inputs(cfg, b, seed=template_size + b)
    js, jo, jsz = (np.asarray(a) for a in jheads.corr_head(
        jnp.asarray(z), jnp.asarray(x), jcfg))
    ts, to, tsz = (a.numpy() for a in theads.corr_head(
        torch.tensor(z), torch.tensor(x), cfg))
    assert ts.shape == js.shape == (b, cfg.feat_size, cfg.feat_size)
    assert to.shape == jo.shape and tsz.shape == jsz.shape
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tsz, jsz)
    assert js.max() > 0.5                     # the planted match peaks
    # The offsets are the port's own parabola over its own score plus the
    # anchor (the function is held to JAX's below) ...
    anchor = 0.5 if tc % 2 == 0 else 0.0
    np.testing.assert_array_equal(
        to, theads._parabolic_offsets(torch.tensor(ts)).numpy() + anchor)
    # ... and equal JAX's to 1e-5 at each map's peak, what the decode reads.
    # (Elsewhere a parabola's denominator can be as small as its 1e-6 floor,
    # where a 1e-7 difference in the scores moves the offset by 0.1.)
    for i in range(b):
        iy, ix = np.unravel_index(np.argmax(js[i]), js[i].shape)
        np.testing.assert_allclose(to[i, iy, ix], jo[i, iy, ix], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("b", (1, 3))
def test_parabolic_offsets_match_jax(b):
    rng = np.random.default_rng(b)
    score = np.clip(rng.random((b, 16, 16)).astype(np.float32) * 1.2 - 0.1,
                    0, 1)
    score[:, 7, 9] = 1.0                        # a peak, and edge cells
    want = np.asarray(jheads._parabolic_offsets(jnp.asarray(score)))
    got = theads._parabolic_offsets(torch.tensor(score)).numpy()
    assert got.shape == (b, 16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_forward_tokens_dispatches_the_corr_head():
    cfg = PRESETS["corr-tiny"]
    gen = torch.Generator().manual_seed(3)
    params = tvittrack.init_params(gen, cfg, device="cpu")
    z, x = (torch.tensor(a) for a in _inputs(cfg, 1, seed=9))
    maps = tvittrack.forward_tokens(params, z, x, cfg)
    # Depth 0: the encoder is the final LayerNorm alone.
    from gstreamer_vit_tracker_tpu_torch.models import vit
    feat = vit.layer_norm(x, params["backbone"]["norm"])
    want = theads.corr_head(z, feat, cfg)
    for a, b in zip(maps, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX's corr-tiny tree from init_params(PRNGKey(0)), saved by its
    save_npz and loaded by the port."""
    path = str(tmp_path_factory.mktemp("corr") / "corr_tiny.npz")
    jparams = jvittrack.init_params(jax.random.PRNGKey(0),
                                    JAX_PRESETS["corr-tiny"])
    jweights.save_npz(path, jparams)
    tparams = tweights.load_npz(path, PRESETS["corr-tiny"], device=CPU)
    assert "head" not in tparams
    return jparams, tparams


def _frames(fmt, n):
    src = SyntheticSource(320, 256, seed=0, fmt=fmt)
    return [src.frame(i) for i in range(n)], src.bbox_at(0)


def _jax_frame(fmt, f):
    return tuple(map(jnp.asarray, f)) if fmt == "nv12" else jnp.asarray(f)


@pytest.mark.parametrize("fmt", ("rgb", "nv12"))
def test_corr_tiny_core_trajectory_matches_jax(carried, fmt):
    jparams, tparams = carried
    cfg_j, cfg_t = JAX_PRESETS["corr-tiny"], PRESETS["corr-tiny"]
    frames, bbox = _frames(fmt, 11)
    jupd = jax.jit(functools.partial(jcore.update, cfg=cfg_j,
                                     frame_format=fmt))
    jst = jcore.init(jparams, _jax_frame(fmt, frames[0]), jnp.asarray(bbox),
                     cfg_j, frame_format=fmt)
    tst = tcore.init(tparams, frames[0], bbox, cfg_t, frame_format=fmt,
                     device=CPU)
    np.testing.assert_allclose(tst.z_tok.numpy(), np.asarray(jst.z_tok),
                               rtol=0, atol=1e-4)
    for i, f in enumerate(frames[1:], 1):
        jst, jb, jc = jupd(jparams, jst, _jax_frame(fmt, f))
        tst, tb, tc = tcore.update(tparams, tst, f, cfg_t, frame_format=fmt,
                                   device=CPU)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                                   atol=1e-2, err_msg=f"bbox, frame {i}")
        assert abs(float(tc) - float(jc)) <= 1e-4, (i, float(tc), float(jc))
        assert int(tst.lost_frames) == int(jst.lost_frames)
    assert float(tc) > 0.5                      # still on the target
