"""PyTorch port: the per-block encode route and batched tracking
(``tracker/multi.py``) against the JAX package, on the CPU.

Same seeded NV12 frames, boxes and weights on both sides.  On the CPU the
port's attention is the CUDA kernels' plain version.

Tolerances: float32 encode 1e-5, bf16 encode 0.05 (JAX rounds a product
and its bias sum separately, the port's ``addmm`` once); trajectories of
the float32 ``small`` preset: bbox 1e-2 px, score 1e-4, ``lost_frames``
exact, template tokens 1e-4; an inactive slot is held bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vit as jvit  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import multi as jmulti  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker.state import TrackState as JTrackState  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit as tvit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention as tattn  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core as tcore  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import multi as tmulti  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker.state import (  # noqa: E402
    TrackState, stack_states, zeros_state)

CPU = torch.device("cpu")
H, W = 160, 224
# (x, y, w, h, dx, dy): two bright textured targets per stream.
TARGETS = ((40, 40, 36, 32, 3, 1), (140, 90, 32, 36, -2, -1))


def nv12_clip(n, seed, targets=TARGETS, h=H, w=W):
    """n NV12 frames of bright checker targets moving over a dim textured
    background, and each target's box per frame (n, len(targets), 4)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg = (70 + 20 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
          + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.uint8)
    bg_uv = (128 + rng.normal(0, 3, (h // 2, w // 2, 2))).clip(
        0, 255).astype(np.uint8)
    frames, boxes = [], []
    for t in range(n):
        y, uv, row = bg.copy(), bg_uv.copy(), []
        for k, (x0, y0, bw, bh, dx, dy) in enumerate(targets):
            x, yv = x0 + dx * t, y0 + dy * t
            x, yv = x - x % 2, yv - yv % 2
            ty, tx = np.mgrid[0:bh, 0:bw]
            y[yv:yv + bh, x:x + bw] = 190 + 50 * (((tx // 6) + (ty // 6) + k) % 2)
            uv[yv // 2:(yv + bh) // 2, x // 2:(x + bw) // 2] = (90 + 60 * k, 200)
            row.append((x, yv, bw, bh))
        frames.append((y, uv))
        boxes.append(row)
    return frames, np.asarray(boxes, np.float32)


@pytest.fixture(scope="module")
def small():
    cfg_j, cfg_t = JAX_PRESETS["small"], PRESETS["small"]
    path = tweights.checkpoint_path("small")
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg_j))
    return (cfg_j, jweights.load_npz(path, like),
            cfg_t, tweights.load_npz(path, cfg_t, device=CPU))


def _jstate(tstate):
    return JTrackState(*map(jnp.asarray, tweights.state_to_numpy(tstate)))


def _assert_states(tst, jst, z_atol=1e-4):
    t, j = tweights.state_to_numpy(tst), jax.device_get(jst)
    np.testing.assert_allclose(t.z_tok, np.asarray(j.z_tok, np.float32),
                               atol=z_atol, rtol=0)
    np.testing.assert_allclose(t.bbox, j.bbox, atol=1e-2, rtol=0)
    np.testing.assert_allclose(t.score, j.score, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t.frame_idx, j.frame_idx)
    np.testing.assert_array_equal(t.lost_frames, j.lost_frames)


def _stack_frames(frames_per_stream, t):
    return (np.stack([f[t][0] for f in frames_per_stream]),
            np.stack([f[t][1] for f in frames_per_stream]))


# ---------------------------------------------------------------------------
# The per-block encode route
# ---------------------------------------------------------------------------

def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.05)])
def test_encode_per_block_matches_jax(dtype, tol):
    cfg_kw = dict(template_size=32, search_size=64, patch_size=16,
                  embed_dim=64, depth=3, num_heads=2, dtype=dtype)
    jcfg, tcfg = JaxModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jparams = jvit.init_vit_params(jax.random.PRNGKey(6), jcfg)
    tparams = _tree(jax.tree.map(np.asarray, jparams), torch.tensor)
    rng = np.random.default_rng(8)
    z = rng.standard_normal((3, jcfg.num_template_tokens, 64)).astype(np.float32)
    x = rng.standard_normal((3, jcfg.num_search_tokens, 64)).astype(np.float32)
    ref = jvit.encode(jparams, jnp.asarray(z), jnp.asarray(x), jcfg,
                      use_pallas=False, fused=False)
    before = (tattn.SINGLE_LAUNCHES, tattn.FLASH_LAUNCHES)
    got = tvit.encode(tparams, torch.from_numpy(z), torch.from_numpy(x), tcfg,
                      fused=False)
    assert (tattn.SINGLE_LAUNCHES, tattn.FLASH_LAUNCHES) == before  # CPU
    assert got.shape == (3, jcfg.num_search_tokens, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    # Both routes of the port compute one function (other rounding points
    # in bf16 only); at batch > 1 the default is the per-block route.
    fused = tvit.encode(tparams, torch.from_numpy(z), torch.from_numpy(x),
                        tcfg, fused=True)
    np.testing.assert_allclose(fused.float().numpy(), got.float().numpy(),
                               rtol=tol, atol=tol)
    auto = tvit.encode(tparams, torch.from_numpy(z), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(auto.float().numpy(), got.float().numpy())


def test_encode_use_kernel_true_on_cpu_raises():
    cfg = ModelConfig(template_size=32, search_size=64, embed_dim=64, depth=1,
                      num_heads=2, dtype="float32")
    params = tweights.params_from_flat(
        {k: np.zeros(s, np.float32) for k, s in _flat_shapes(cfg).items()},
        cfg, device=CPU)["backbone"]
    z = torch.zeros((2, cfg.num_template_tokens, 64))
    x = torch.zeros((2, cfg.num_search_tokens, 64))
    with pytest.raises(ValueError, match="use_kernel=True"):
        tvit.encode(params, z, x, cfg, use_kernel=True, fused=False)


def _flat_shapes(cfg, tree=None, prefix=""):
    tree = tweights.param_shapes(cfg) if tree is None else tree
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_shapes(cfg, v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_shapes(cfg, v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# Helpers of the batch
# ---------------------------------------------------------------------------

def test_batched_cfg_turns_the_band_off():
    cfg = PRESETS["small"]
    assert cfg.preprocess_band is not None
    b = tmulti._batched_cfg(cfg)
    assert b.preprocess_band is None
    assert dataclasses.replace(b, preprocess_band=cfg.preprocess_band) == cfg
    assert tmulti._batched_cfg(b) is b


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(0)
    b = np.concatenate([rng.uniform(0, 50, (2, 5, 2)),
                        rng.uniform(5, 40, (2, 5, 2))], -1).astype(np.float32)
    got = tmulti._pairwise_iou(torch.from_numpy(b)).numpy()
    for s in range(2):
        np.testing.assert_allclose(
            got[s], np.asarray(jmulti._pairwise_iou(jnp.asarray(b[s]))),
            rtol=1e-6, atol=1e-7)


def _toy_state(n, rng, jax_side):
    leaves = (rng.standard_normal((n, 4, 8)).astype(np.float32),
              rng.standard_normal((n, 4, 8)).astype(np.float32),
              np.tile(np.asarray([10, 10, 20, 20], np.float32), (n, 1)),
              rng.uniform(0.3, 0.9, n).astype(np.float32),
              np.arange(n, dtype=np.int32) + 3,
              np.arange(n, dtype=np.int32) % 2)
    if jax_side:
        return JTrackState(*map(jnp.asarray, leaves))
    return TrackState(*map(torch.from_numpy, leaves))


def test_suppress_duplicates_matches_jax_and_breaks_ties_low():
    n = 4
    old_t = _toy_state(n, np.random.default_rng(1), False)
    old_j = _toy_state(n, np.random.default_rng(1), True)
    new_t = _toy_state(n, np.random.default_rng(2), False)
    new_j = _toy_state(n, np.random.default_rng(2), True)
    # 0 and 1 overlap with EQUAL scores (tie -> slot 0 wins); 2 overlaps
    # them with a higher score but is inactive; 3 is far away.
    boxes = np.asarray([[10, 10, 20, 20], [11, 10, 20, 20], [10, 11, 20, 20],
                        [90, 90, 20, 20]], np.float32)
    scores = np.asarray([0.7, 0.7, 0.9, 0.8], np.float32)
    active = np.asarray([True, True, False, True])
    new_t = new_t._replace(bbox=torch.from_numpy(boxes.copy()),
                           score=torch.from_numpy(scores.copy()))
    new_j = new_j._replace(bbox=jnp.asarray(boxes), score=jnp.asarray(scores))
    jst, jb, jsc = jmulti._suppress_duplicates(
        new_j, old_j, jnp.asarray(boxes), jnp.asarray(scores),
        jnp.asarray(active), 0.6)
    tst, tb, tsc = tmulti._suppress_duplicates(
        new_t, old_t, torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(active), 0.6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    for a, b in zip(tweights.state_to_numpy(tst), jax.device_get(jst)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tsc.tolist() == pytest.approx([0.7, 0.0, 0.9, 0.8])   # 1 lost
    np.testing.assert_array_equal(tb[1].numpy(), old_t.bbox[1].numpy())
    assert int(tst.lost_frames[1]) == int(old_t.lost_frames[1]) + 1
    np.testing.assert_array_equal(tst.z_tok[1].numpy(), old_t.z_tok[1].numpy())
    np.testing.assert_array_equal(tst.z_tok[0].numpy(), new_t.z_tok[0].numpy())


def test_mask_state_holds_inactive_leaves_bit_for_bit():
    rng = np.random.default_rng(3)
    old = TrackState(*(t.reshape(2, 2, *t.shape[1:])
                       for t in _toy_state(4, rng, False)))
    new = TrackState(*(t.reshape(2, 2, *t.shape[1:])
                       for t in _toy_state(4, rng, False)))
    active = torch.tensor([[True, False], [False, True]])
    out = tmulti._mask_state(new, old, active)
    for o, n, m in zip(old, new, out):
        assert m.dtype == n.dtype
        np.testing.assert_array_equal(m[0, 0].numpy(), n[0, 0].numpy())
        np.testing.assert_array_equal(m[0, 1].numpy(), o[0, 1].numpy())
        np.testing.assert_array_equal(m[1, 0].numpy(), o[1, 0].numpy())
        np.testing.assert_array_equal(m[1, 1].numpy(), n[1, 1].numpy())


def test_state_crosses_to_numpy_and_back():
    cfg = dataclasses.replace(PRESETS["small"], dtype="bfloat16")
    rng = np.random.default_rng(4)
    z = zeros_state(cfg, device=CPU)
    assert z.z_tok.dtype == torch.bfloat16 and z.frame_idx.dtype == torch.int32
    st = stack_states([stack_states([z, z, z]), stack_states([z, z, z])])
    assert st.z_tok.shape == (2, 3, 16, 96) and st.score.shape == (2, 3)
    st = st._replace(
        z_tok=torch.from_numpy(rng.standard_normal(st.z_tok.shape).astype(
            np.float32)).to(torch.bfloat16),
        bbox=torch.from_numpy(rng.uniform(0, 9, st.bbox.shape).astype(np.float32)),
        lost_frames=torch.arange(6, dtype=torch.int32).reshape(2, 3))
    leaves = tweights.state_to_numpy(st)
    jst = JTrackState(jnp.asarray(leaves.z_tok, jnp.bfloat16),
                      jnp.asarray(leaves.z_tok_init, jnp.bfloat16),
                      *map(jnp.asarray, leaves[2:]))
    back = tweights.state_from_numpy(jax.device_get(jst), cfg, device=CPU)
    for a, b in zip(st, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_jit_names_are_aliases():
    # No longer aliases: each *_jit name is a compiled entry point
    # (utils/graph.py) over the eager function of the same name.
    from gstreamer_vit_tracker_tpu_torch.utils import graph

    for name in ("update_streams", "update_objects", "init_streams",
                 "init_objects"):
        jit = getattr(tmulti, name + "_jit")
        assert isinstance(jit, graph.Compiled)
        assert jit is not getattr(tmulti, name)
        assert jit.fn is getattr(tmulti, name)
    assert tmulti.update_streams_jit.donate == {"state": (0,)}
    assert tmulti.init_streams_jit.donate == {}


# ---------------------------------------------------------------------------
# Multi-object and multi-stream steps against JAX
# ---------------------------------------------------------------------------

def test_update_objects_matches_jax(small):
    cfg_j, jparams, cfg_t, tparams = small
    frames, boxes = nv12_clip(5, seed=1)
    bbs = np.concatenate([boxes[0], boxes[0][:1] + [2, 1, 0, 0]])   # N = 3
    active = np.asarray([True, True, False])
    tst = tmulti.init_objects(tparams, frames[0], bbs, cfg_t, device=CPU,
                              frame_format="nv12")
    jst = jmulti.init_objects(jparams, tuple(map(jnp.asarray, frames[0])),
                              jnp.asarray(bbs), cfg_j, "nv12")
    _assert_states(tst, jst)
    jupd = jax.jit(functools.partial(jmulti.update_objects, cfg=cfg_j,
                                     frame_format="nv12"))
    held = [t.clone() for t in tst]
    for f in frames[1:]:
        jst, jb, jsc = jupd(jparams, jst, tuple(map(jnp.asarray, f)),
                            jnp.asarray(active))
        tst, tb, tsc = tmulti.update_objects(tparams, tst, f, active, cfg_t,
                                             device=CPU, frame_format="nv12")
        assert tb.shape == (3, 4) and tsc.shape == (3,)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-4, rtol=0)
        _assert_states(tst, jst)
    for h, t in zip(held, tst):                     # the inactive object
        np.testing.assert_array_equal(h[2].numpy(), t[2].numpy())
    assert int(tst.frame_idx[0]) == 4 and float(tsc[0]) > 0.25


def _streams(n):
    a, ba = nv12_clip(n, seed=2)
    b, bb = nv12_clip(n, seed=3, targets=((120, 30, 36, 32, -3, 2),
                                          (50, 100, 32, 36, 2, -1)))
    return (a, b), np.stack([ba, bb], axis=1)          # boxes (n, S, M, 4)


def test_update_streams_matches_jax_and_holds_inactive_slot(small):
    cfg_j, jparams, cfg_t, tparams = small
    streams, boxes = _streams(5)
    active = np.asarray([[True, True], [False, True]])
    f0 = _stack_frames(streams, 0)
    tst = tmulti.init_streams(tparams, f0, boxes[0], cfg_t, device=CPU,
                              frame_format="nv12")
    jst = jmulti.init_streams(jparams, tuple(map(jnp.asarray, f0)),
                              jnp.asarray(boxes[0]), cfg_j, "nv12")
    assert tst.z_tok.shape == (2, 2, cfg_t.num_template_tokens, cfg_t.embed_dim)
    _assert_states(tst, jst)
    jupd = jax.jit(functools.partial(jmulti.update_streams, cfg=cfg_j,
                                     frame_format="nv12"))
    held = [t.clone() for t in tst]
    for t in range(1, 5):
        f = _stack_frames(streams, t)
        jst, jb, jsc = jupd(jparams, jst, tuple(map(jnp.asarray, f)),
                            jnp.asarray(active))
        tst, tb, tsc = tmulti.update_streams(tparams, tst, f, active, cfg_t,
                                             device=CPU, frame_format="nv12")
        assert tb.shape == (2, 2, 4) and tsc.shape == (2, 2)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-4, rtol=0)
        _assert_states(tst, jst)
    for h, leaf in zip(held, tst):                  # slot (1, 0) never ran
        np.testing.assert_array_equal(h[1, 0].numpy(), leaf[1, 0].numpy())
    np.testing.assert_array_equal(tb[1, 0].numpy(), boxes[0, 1, 0])
    # The live slots follow their targets.
    for s, m in ((0, 0), (0, 1), (1, 1)):
        assert float(tsc[s, m]) > 0.25
        assert np.abs(tb[s, m].numpy() - boxes[4, s, m]).max() < 8.0


def test_update_streams_exclusive_matches_jax(small):
    cfg_j, jparams, cfg_t, tparams = small
    streams, boxes = _streams(4)
    # Stream 0: both boxes on ONE target (the second nudged by 2 px), so
    # the two slots collapse and the lower-scoring one must be suppressed.
    bbs = boxes[0].copy()
    bbs[0, 1] = bbs[0, 0] + [2, 0, 0, 0]
    active = np.ones((2, 2), bool)
    f0 = _stack_frames(streams, 0)
    tst = tmulti.init_streams(tparams, f0, bbs, cfg_t, device=CPU,
                              frame_format="nv12")
    jst = _jstate(tst)
    jupd = jax.jit(functools.partial(jmulti.update_streams, cfg=cfg_j,
                                     frame_format="nv12", exclusive=True))
    losers = 0
    for t in range(1, 4):
        f = _stack_frames(streams, t)
        prev = tst
        jst, jb, jsc = jupd(jparams, jst, tuple(map(jnp.asarray, f)),
                            jnp.asarray(active))
        tst, tb, tsc = tmulti.update_streams(tparams, tst, f, active, cfg_t,
                                             exclusive=True, device=CPU,
                                             frame_format="nv12")
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-4, rtol=0)
        _assert_states(tst, jst)
        lost = (tsc[0] == 0.0).numpy()
        if lost.any():
            losers += 1
            k = int(np.argmax(lost))
            assert lost.sum() == 1
            np.testing.assert_array_equal(tb[0, k].numpy(), prev.bbox[0, k].numpy())
            assert int(tst.lost_frames[0, k]) == int(prev.lost_frames[0, k]) + 1
        assert (tsc[1] > 0.0).all()                 # stream 1 is untouched
    assert losers >= 1


def test_update_streams_template_update_matches_jax(small):
    cfg_j, jparams, cfg_t, tparams = small
    kw = dict(template_update_enabled=True, template_update_threshold=0.3,
              template_update_interval=2)
    cfg_j, cfg_t = (dataclasses.replace(c, **kw) for c in (cfg_j, cfg_t))
    streams, boxes = _streams(5)
    active = np.asarray([[True, True], [True, False]])
    f0 = _stack_frames(streams, 0)
    tst = tmulti.init_streams(tparams, f0, boxes[0], cfg_t, device=CPU,
                              frame_format="nv12")
    jst = _jstate(tst)
    jupd = jax.jit(functools.partial(jmulti.update_streams, cfg=cfg_j,
                                     frame_format="nv12"))
    z0 = tst.z_tok.clone()
    for t in range(1, 5):
        f = _stack_frames(streams, t)
        jst, jb, jsc = jupd(jparams, jst, tuple(map(jnp.asarray, f)),
                            jnp.asarray(active))
        tst, tb, tsc = tmulti.update_streams(tparams, tst, f, active, cfg_t,
                                             device=CPU, frame_format="nv12")
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
        # A re-embedded template at boxes that agree to ~1e-3 px: looser
        # tokens, as in tests/test_torch_tracker.py.
        _assert_states(tst, jst, z_atol=1e-2)
    assert not torch.equal(tst.z_tok[0, 0], z0[0, 0])       # an update ran
    np.testing.assert_array_equal(tst.z_tok[1, 1].numpy(), z0[1, 1].numpy())
    np.testing.assert_array_equal(tst.z_tok_init.numpy(), z0.numpy())


def test_batched_step_matches_the_ports_unbatched_step(small):
    # Frames within the band: the banded unbatched step and the band-less
    # batch compute the same crop.  Float32 sums in other GEMM shapes: 1e-3
    # px, 1e-5 score.
    _, _, cfg_t, tparams = small
    streams, boxes = _streams(4)
    f0 = _stack_frames(streams, 0)
    tst = tmulti.init_streams(tparams, f0, boxes[0], cfg_t, device=CPU,
                              frame_format="nv12")
    singles = {(s, m): tcore.init(tparams, streams[s][0], boxes[0, s, m],
                                  cfg_t, device=CPU, frame_format="nv12")
               for s in range(2) for m in range(2)}
    for (s, m), st in singles.items():
        np.testing.assert_allclose(tst.z_tok[s, m].numpy(), st.z_tok.numpy(),
                                   atol=1e-5, rtol=0)
    active = np.ones((2, 2), bool)
    for t in range(1, 4):
        tst, tb, tsc = tmulti.update_streams(
            tparams, tst, _stack_frames(streams, t), active, cfg_t, device=CPU,
                                             frame_format="nv12")
        for (s, m), st in singles.items():
            st, b, c = tcore.update(tparams, st, streams[s][t], cfg_t,
                                    device=CPU, fused=False,
                                    frame_format="nv12")
            singles[(s, m)] = st
            np.testing.assert_allclose(tb[s, m].numpy(), b.numpy(), atol=1e-3,
                                       rtol=0)
            assert abs(float(tsc[s, m]) - float(c)) <= 1e-5
            assert int(tst.lost_frames[s, m]) == int(st.lost_frames)


def test_init_keeps_copies_not_the_callers_buffers(small):
    _, _, cfg_t, tparams = small
    streams, boxes = _streams(2)
    bbs = torch.from_numpy(boxes[0].copy())
    f0 = tuple(torch.from_numpy(p) for p in _stack_frames(streams, 0))
    st = tmulti.init_streams(tparams, f0, bbs, cfg_t, device=CPU,
                             frame_format="nv12")
    assert st.bbox.data_ptr() != bbs.data_ptr()
    assert st.z_tok.data_ptr() != st.z_tok_init.data_ptr()
    st.bbox.add_(100.0)
    np.testing.assert_array_equal(bbs.numpy(), boxes[0])
    again = tmulti.init_streams(tparams, f0, bbs, cfg_t, device=CPU,
                                frame_format="nv12")
    np.testing.assert_array_equal(again.bbox.numpy(), boxes[0])


def test_batched_options_that_are_not_ported_raise(small):
    _, _, cfg_t, tparams = small
    streams, boxes = _streams(2)
    st = tmulti.init_streams(tparams, _stack_frames(streams, 0), boxes[0],
                             cfg_t, device=CPU, frame_format="nv12")
    f1 = _stack_frames(streams, 1)
    # The one-kernel preprocess + embed is for the unbatched step only.
    with pytest.raises(ValueError, match="one window"):
        tcore.update(tparams, st, f1, tmulti._batched_cfg(cfg_t), device=CPU,
                     fused_prep=True, frame_format="nv12")
    # The patch-major embed takes the batch: the plain route's result.
    _, pb, pc = tcore.update(tparams, st, f1, tmulti._batched_cfg(cfg_t),
                             device=CPU, fused=False, frame_format="nv12")
    _, fb, fc = tcore.update(tparams, st, f1, tmulti._batched_cfg(cfg_t),
                             device=CPU, fused=False, fused_embed=True,
                             frame_format="nv12")
    np.testing.assert_allclose(fb.numpy(), pb.numpy(), atol=1e-2, rtol=0)
    np.testing.assert_allclose(fc.numpy(), pc.numpy(), atol=1e-4, rtol=0)
    # A band smaller than the frame is for the unbatched step only.
    banded = dataclasses.replace(cfg_t, preprocess_band=128)
    with pytest.raises(ValueError, match="band"):
        tcore.update(tparams, st, f1, banded, device=CPU, fused=False,
                     frame_format="nv12")
    # Frames must lead the state's batch.
    with pytest.raises(ValueError, match="frame batch"):
        tcore.update(tparams, st, (f1[0][:1], f1[1][:1]),
                     tmulti._batched_cfg(cfg_t), device=CPU, fused=False,
                     frame_format="nv12")
    with pytest.raises(ValueError, match="unknown frame format"):
        tmulti.update_streams(tparams, st, f1, np.ones((2, 2), bool), cfg_t,
                              frame_format="bgr", device=CPU)


def test_batched_entry_points_need_cuda_without_a_device(small, monkeypatch):
    _, _, cfg_t, tparams = small
    streams, boxes = _streams(2)
    f0 = _stack_frames(streams, 0)
    st = tmulti.init_streams(tparams, f0, boxes[0], cfg_t, device=CPU,
                             frame_format="nv12")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmulti.init_streams(tparams, f0, boxes[0], cfg_t, frame_format="nv12")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmulti.update_streams(tparams, st, f0, np.ones((2, 2), bool), cfg_t,
                              frame_format="nv12")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmulti.update_objects(tparams, st, f0, np.ones(2, bool), cfg_t,
                              frame_format="nv12")
