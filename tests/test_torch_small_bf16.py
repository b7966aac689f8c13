"""PyTorch port: the ``small`` architecture in JAX's default dtype (bf16,
D 96, 2 heads of 48, MLP 384, depth 4) against the JAX package on the CPU.

JAX's ``ModelConfig.dtype`` defaults to ``"bfloat16"``; the config here is
``dataclasses.replace(PRESETS["small"], dtype="bfloat16")`` on both sides,
with the shipped ``assets/weights_small_synthetic.npz`` cast.  On the card
the port runs kernels 1 and 2 zero-padded to D 128 (head dim 64) and
kernels 3 and 4 at head dim 64 (``ops/vit_block.py::plan``,
``ops/attention.py::plan``); on the CPU each wrapper is its plain twin,
which these tests hold to JAX.

* JAX's ``vit_block.encoder`` at (1, 80, 96) x 4 and ``vit_block.block`` at
  (16, 80, 96) (Pallas, interpret mode) against the port's ``encoder`` /
  ``block`` on the CPU: 0.05, the flagship's bf16 tolerance for the same
  check (``tests/test_torch_vit_block.py``, ``tests/test_torch_block.py``).
* ``core.update`` (single object, 1080p NV12, the fused encode) and
  ``multi.update_streams`` (2 streams x 2 slots of 1080p NV12, the
  per-block route) step
  by step, each step of the port run from JAX's state before it: bf16
  trajectories that run free part at near-ties (ROADMAP, section 3).  Each
  step's bbox within 1 px and score within 0.01 (the flagship's bf16
  tolerances against JAX's eval script, ``tests/test_torch_eval_script.py``;
  read here: 0.50 px and 0.0021 single, 0.70 px and 0.0023 batched at
  most), ``lost_frames`` exact; the template
  tokens of ``init`` within 0.05 (the flagship's bf16 one,
  ``tests/test_torch_tracker.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.ops import vit_block as jvb  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import core as jcore  # noqa: E402
from gstreamer_vit_tracker_tpu.tracker import multi as jmulti  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vit  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.ops import attention, vit_block  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.profile_encoder import nv12_clip  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker import core, multi  # noqa: E402

CPU = torch.device("cpu")
BF16 = torch.bfloat16
KERNEL_TOL = 0.05                    # the flagship's bf16 twin-vs-JAX one
BOX_TOL, SCORE_TOL = 1.0, 0.01       # px, confidence: a step from JAX's state
Z_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_bf16():
    """(JAX config, JAX params, port config, port params on the CPU): the
    ``small`` preset with ``dtype="bfloat16"``, the shipped weights."""
    cfg_j = dataclasses.replace(JAX_PRESETS["small"], dtype="bfloat16")
    cfg_t = dataclasses.replace(PRESETS["small"], dtype="bfloat16")
    path = weights.checkpoint_path("small")
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg_j))
    return (cfg_j, jvittrack.with_grouped_head(jweights.load_npz(path, like)),
            cfg_t, vittrack.with_grouped_head(
                weights.load_npz(path, cfg_t, device=CPU)))


def test_the_card_runs_this_architecture_padded(small_bf16):
    # What the kernels run on the card (the rule is a pure function): mma
    # with D 96 -> 128 and dh 48 -> 64 for kernels 1 and 2 at batch 1 and
    # 16, mma at dh 64 for kernel 3 of the tick and kernel 4 past 384 keys.
    cfg = small_bf16[2]
    d, heads = cfg.embed_dim, cfg.num_heads
    hidden = int(d * cfg.mlp_ratio)
    assert (d, heads, hidden, cfg.depth) == (96, 2, 384, 4)
    for b in (1, 16):
        got = vit_block.plan(b, cfg.num_tokens, d, heads, hidden, BF16, 132)
        assert (got.variant, got.pad, got.width, got.mlp) == ("mma", 64, 128, 0)
    for s, route in ((cfg.num_tokens, "single"), (1088, "flash")):
        got = attention.plan(s, d // heads, BF16, 232448, 16 * heads)
        assert (got.route, got.variant, got.pad) == (route, "mma", 64)


def _both(tree, to_jax, to_torch):
    if isinstance(tree, dict):
        pairs = {k: _both(v, to_jax, to_torch) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    a = tree.float().numpy()
    return to_jax(a), to_torch(a)


@pytest.mark.parametrize("kernel,batch", [("encoder", 1), ("block", 16)])
def test_kernel_twin_matches_pallas_at_small_bf16(small_bf16, kernel, batch):
    # JAX's Pallas kernel (interpret mode) and the port's wrapper on the
    # same bf16 inputs (seeded tokens at the scale the tracker's reach) and
    # the shipped small weights cast to bf16 on both sides.
    _, _, cfg, params = small_bf16
    blocks = params["backbone"]["blocks"]
    jb, tb = zip(*(_both(p, lambda a: jnp.asarray(a, jnp.bfloat16),
                         lambda a: torch.from_numpy(a).to(BF16))
                   for p in blocks))
    rng = np.random.default_rng(96 + batch)
    x = (2.0 * rng.standard_normal((batch, cfg.num_tokens, cfg.embed_dim))
         ).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)
    if kernel == "encoder":
        ref = jvb.encoder(jx, list(jb), cfg.num_heads)
        got = vit_block.encoder(tx, list(tb), cfg.num_heads)
    else:
        ref = jvb.block(jx, jb[1], cfg.num_heads)
        got = vit_block.block(tx, tb[1], cfg.num_heads)
    assert got.dtype == BF16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


def _held(rows):
    for i, (tb, jb, tc, jc, tl, jl) in enumerate(rows):
        np.testing.assert_allclose(tb, jb, atol=BOX_TOL, rtol=0,
                                   err_msg=f"bbox, step {i + 1}")
        np.testing.assert_allclose(tc, jc, atol=SCORE_TOL, rtol=0,
                                   err_msg=f"score, step {i + 1}")
        np.testing.assert_array_equal(tl, jl, err_msg=f"lost, step {i + 1}")


def test_update_step_by_step_from_jax_state(small_bf16):
    cfg_j, jparams, cfg_t, tparams = small_bf16
    frames, boxes = nv12_clip(7)
    bbox = list(boxes[0])
    jst = jcore.init(jparams, tuple(map(jnp.asarray, frames[0])),
                     jnp.asarray(bbox), cfg_j, frame_format="nv12")
    tst = core.init(tparams, frames[0], bbox, cfg_t, device=CPU,
                    frame_format="nv12")
    np.testing.assert_allclose(tst.z_tok.float().numpy(),
                               np.asarray(jst.z_tok, np.float32), atol=Z_TOL,
                               rtol=0)
    jupd = jax.jit(functools.partial(jcore.update, cfg=cfg_j,
                                     frame_format="nv12"))
    rows = []
    for f in frames[1:]:
        tst = weights.state_from_numpy(jax.device_get(jst), cfg_t, device=CPU)
        jst, jb, jc = jupd(jparams, jst, tuple(map(jnp.asarray, f)))
        tst, tb, tc = core.update(tparams, tst, f, cfg_t, device=CPU,
                                  frame_format="nv12")
        rows.append((tb.numpy(), np.asarray(jb), float(tc), float(jc),
                     int(tst.lost_frames), int(jst.lost_frames)))
    _held(rows)
    assert min(r[3] for r in rows) > 0.25          # the target is tracked


def test_update_streams_step_by_step_from_jax_state(small_bf16):
    cfg_j, jparams, cfg_t, tparams = small_bf16
    # Two 1080p streams, two slots each on the stream's target (the second
    # box nudged), stream 1's second slot inactive.
    clips = [nv12_clip(4, seed=2, box=(880, 480, 96, 72), step=(3, 2)),
             nv12_clip(4, seed=3, box=(600, 300, 96, 72), step=(-3, 2))]
    boxes = np.asarray([[c[1][0], np.add(c[1][0], (4, -3, 0, 0))]
                        for c in clips], np.float32)          # (S, M, 4)
    active = np.asarray([[True, True], [True, False]])

    def frames_at(t):
        return (np.stack([c[0][t][0] for c in clips]),
                np.stack([c[0][t][1] for c in clips]))

    f0 = frames_at(0)
    jst = jmulti.init_streams(jparams, tuple(map(jnp.asarray, f0)),
                              jnp.asarray(boxes), cfg_j, "nv12")
    tst = multi.init_streams(tparams, f0, boxes, cfg_t, device=CPU,
                             frame_format="nv12")
    np.testing.assert_allclose(tst.z_tok.float().numpy(),
                               np.asarray(jst.z_tok, np.float32), atol=Z_TOL,
                               rtol=0)
    jupd = jax.jit(functools.partial(jmulti.update_streams, cfg=cfg_j,
                                     frame_format="nv12"))
    rows = []
    for t in range(1, 4):
        f = frames_at(t)
        tst = weights.state_from_numpy(jax.device_get(jst), cfg_t, device=CPU)
        jst, jb, jc = jupd(jparams, jst, tuple(map(jnp.asarray, f)),
                           jnp.asarray(active))
        tst, tb, tc = multi.update_streams(tparams, tst, f, active, cfg_t,
                                           device=CPU, frame_format="nv12")
        assert tb.shape == (2, 2, 4)
        rows.append((tb.numpy(), np.asarray(jb), tc.numpy(), np.asarray(jc),
                     tst.lost_frames.numpy(), np.asarray(jst.lost_frames)))
    _held(rows)


def test_encode_routes_agree_at_small_bf16(small_bf16):
    # The fused route (kernels 1 and 2 on the card) and the per-block route
    # (kernel 3) on the same bf16 tokens: one function, other rounding
    # points, within the bf16 tolerance.
    _, _, cfg, params = small_bf16
    bb = params["backbone"]
    gen = torch.Generator().manual_seed(48)
    z = (2.0 * torch.randn((2, cfg.num_template_tokens, cfg.embed_dim),
                           generator=gen)).to(BF16)
    x = (2.0 * torch.randn((2, cfg.num_search_tokens, cfg.embed_dim),
                           generator=gen)).to(BF16)
    fused = vit.encode(bb, z, x, cfg, fused=True)
    per_block = vit.encode(bb, z, x, cfg, fused=False)
    assert fused.dtype == BF16 and fused.shape == x.shape
    np.testing.assert_allclose(fused.float().numpy(),
                               per_block.float().numpy(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
