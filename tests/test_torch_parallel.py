"""PyTorch port: ``parallel/`` on ``torch.distributed`` against the JAX
package's ``parallel/``.

Pure parts in this process: ``factor_mesh`` equals JAX's for 1-16 devices,
and ``param_pspec`` gives JAX's spec for every leaf of the flagship tree.

The rest runs once, in four gloo ranks on the CPU (``parallel/launch.py``,
one intra-op thread each, a join timeout), and each test below reads its
part of what the ranks sent back:

* ``shard_params`` then ``gather_params`` gives the input back, bit for bit;
* a ``SlotEngine`` on a 2x2 dp x tp mesh at JAX's own test configuration
  (D=32, 2 heads, 8 slots, NV12 64x96) against JAX's single-device engine,
  rtol / atol 1e-4 (JAX's bound); the flagship width (D=192, 3 heads:
  qkv's column split cuts a head) at tp=2 likewise;
* a 2x2 train step at the dry-run configuration (D=192, depth 12, 3
  heads): its loss within 1e-4 relative of JAX's ``train_step(
  use_pallas=False)``; the gathered params and first moments after it, and
  the second step's loss, against the port's one-process run (bounds at
  the tests);
* the ``slots % dp`` rule of ``tests/test_sharding.py``;
* ``ShardedStreamTracker`` over a 4x1 mesh: its three ticks against
  JAX's, and recovery from a poisoned state as ``tests/test_sharding.py``
  holds JAX's;
* ``train_synthetic --mesh 2x2 --cpu`` saves the gathered checkpoint.

Every mesh path above runs its compiled program (``utils/graph.py``: on
the CPU the plumbing, the body called eagerly), as the mesh paths of NCCL
ranks do on the card; each is also held bit for bit to its eager mesh
body called by name (the route of ranks that share a card): the tracker's
ticks and recovery, the 2x2 engine's slot writes and ticks, the 2x2 train
step, and the 2x2 ``train_scan`` (the script's route).

The ranks import this module to find ``_rank_jobs``, so it imports JAX and
the JAX package inside the tests only (each rank would otherwise load them
too).  Params are drawn by the port and handed to JAX as numpy.
"""

import dataclasses
import io
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu_torch import entry  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media.source import SyntheticSource  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.parallel import (  # noqa: E402
    ShardedStreamTracker, factor_mesh, make_mesh, sharding)
from gstreamer_vit_tracker_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import SlotEngine  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.train import data  # noqa: E402

TINY = dict(template_size=32, search_size=64, patch_size=16)
SERVE = dict(TINY, embed_dim=32, depth=2, num_heads=2, dtype="float32")
WIDE = dict(TINY, embed_dim=192, depth=2, num_heads=3, dtype="float32")
CORR = dict(template_size=64, search_size=128, patch_size=8, embed_dim=64,
            depth=0, num_heads=2, head_mode="corr", dtype="float32")
TRAIN_ARGV = ["--cpu", "--preset", "small", "--steps", "2", "--batch", "4",
              "--dataset-size", "8", "--log-every", "1", "--seed", "3"]
# The port's mesh step against its one-process step (float32): the data
# mean of the gradients and the norm sum in another order.  Measured at
# this configuration: first moments (0.1 x the clipped gradient, up to
# 0.015) 5.1e-9 apart, held to 1e-7, so a clip by a wrong norm (a tenth
# off moves them 1.5e-3) or a missing gradient shows; params after one
# step 4.4e-6 apart, held to a tenth of the learning rate (AdamW's first
# step moves a leaf by lr x g / (|g| + eps), which another summation order
# moves where |g| is near eps); the second loss equal, held to 1e-5
# relative.
STEP_PARAMS_ATOL, STEP_MU_ATOL, STEP_LOSS_RTOL = 1e-5, 1e-7, 1e-5


def _params(cfg_kw, seed):
    return vittrack.init_params(torch.Generator().manual_seed(seed),
                                ModelConfig(**cfg_kw), device="cpu")


def _jax_tree(params):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, weights.tree_to_numpy(params))


def _jax_cfg(cfg_kw):
    from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxConfig

    return JaxConfig(**cfg_kw)


def _nv12(rng, s, h=64, w=96):
    return (rng.integers(0, 256, (s, h, w), dtype=np.uint8),
            rng.integers(0, 256, (s, h // 2, w // 2, 2), dtype=np.uint8))


def _serve_inputs(seed, s):
    rng = np.random.default_rng(seed)
    f0, f1 = _nv12(rng, s), _nv12(rng, s)
    bbs = [[20.0 + 2.0 * i, 16.0 + float(i), 24.0, 20.0] for i in range(s)]
    return f0, f1, bbs


def _corr_frames(t):
    srcs = [SyntheticSource(160, 128, obj_size=32, seed=s) for s in range(8)]
    return (np.stack([s.frame_rgb(t) for s in srcs]),
            np.asarray([[s.bbox_at(0)] for s in srcs], np.float32))


def _engine_rule(mesh, params, cfg, slots):
    try:
        SlotEngine(params, cfg, slots=slots, frame_format="rgb",
                   device="cpu", mesh=mesh)
        return "ok"
    except ValueError:
        return "raises"


def _engine_routes(params, cfg, frames0, frames1, bbs, mesh):
    """The mesh engine's slot writes and two ticks, eager (the bodies by
    name) then compiled: (packed rows, final state, tick and write
    captures) of each."""
    out = []
    for compiled in (False, True):
        eng = SlotEngine(params, cfg, slots=len(bbs), frame_format="nv12",
                         device="cpu", mesh=mesh)
        eng.compiled = compiled
        for i in range(len(bbs)):
            eng.init_slot(eng.alloc(), (frames0[0][i], frames0[1][i]),
                          bbs[i])
        rows = [eng.step(f, np.ones(len(bbs), bool))
                for f in (frames1, frames0)]
        out.append({"rows": rows, "state": [t.numpy() for t in eng.state],
                    "captures": (eng._tick.traces, eng._write.traces)})
    return out


def _eager_train_steps(params, batch, cfg, mesh, steps=2):
    """``entry.train_steps`` with the eager step called by name: the losses
    and the gathered params and first moments after the first step."""
    from gstreamer_vit_tracker_tpu_torch.parallel.mesh import use_mesh
    from gstreamer_vit_tracker_tpu_torch.train import step as tstep

    state = tstep.create_train_state(sharding.shard_params(
        weights.tree_to(params, "cpu", copy=True), mesh))
    z, x, gt = (torch.as_tensor(np.asarray(t)) for t in
                sharding.shard_batch(tuple(batch), mesh))
    losses, first = [], None
    with use_mesh(mesh):
        for _ in range(steps):
            state, loss, _ = tstep.train_step_eager(state, z, x, gt, cfg,
                                                    device="cpu")
            losses.append(float(loss))
            first = first or (state.params, state.opt_state.mu)

    def whole(tree):
        return weights.flatten(weights.tree_to_numpy(
            sharding.gather_params(tree, mesh)))

    return {"losses": losses, "params": whole(first[0]),
            "mu": whole(first[1])}


def _scan_routes(cfg, mesh):
    """``train_scan`` and ``train_scan_eager`` under ``mesh``, two steps
    of a batch of 4 from one seeded generator: (losses, params, the
    generator's state) of each."""
    from gstreamer_vit_tracker_tpu_torch.parallel.mesh import use_mesh
    from gstreamer_vit_tracker_tpu_torch.train import step as tstep

    rng = np.random.default_rng(4)
    ds = (rng.integers(0, 256, (6, cfg.template_size, cfg.template_size, 3),
                       dtype=np.uint8),
          rng.integers(0, 256, (6, cfg.search_size, cfg.search_size, 3),
                       dtype=np.uint8),
          rng.uniform(0.2, 0.6, (6, 4)).astype(np.float32))
    out = []
    for scan in (tstep.train_scan_eager, tstep.train_scan):
        opt = tstep.make_optimizer(1e-3)
        state = tstep.create_train_state(sharding.shard_params(
            _params(SERVE, 9), mesh), opt=opt)
        gen = torch.Generator().manual_seed(5)
        with use_mesh(mesh):
            state, gen, losses, _ = scan(state, *ds, gen, cfg, opt, 2, 4,
                                         device="cpu")
        out.append((losses.numpy(), [t.numpy() for t in
                                     tstep.tree_leaves(state.params)],
                    gen.get_state().numpy()))
    return out


def _rank_jobs(rank, n, inp):
    """Everything the tests read, on one rank of four."""
    out = {}
    try:
        make_mesh((4, 2), device="cpu")
        out["too_big"] = "ok"
    except ValueError as e:
        out["too_big"] = str(e)
    mesh = make_mesh((2, 2), device="cpu")
    serve_cfg, wide_cfg = ModelConfig(**SERVE), ModelConfig(**WIDE)
    wide = inp["wide"]
    shards = sharding.shard_params(wide, mesh)
    back = weights.flatten(sharding.gather_params(shards, mesh))
    out["gather_equal"] = all(torch.equal(back[k], v) for k, v in
                              weights.flatten(wide).items())
    out["qkv_shard"] = tuple(shards["backbone"]["blocks"][0]["qkv"][
        "kernel"].shape)
    try:
        sharding.shard_batch(np.zeros((3, 2)), mesh)
        out["odd_batch"] = "ok"
    except ValueError:
        out["odd_batch"] = "raises"
    out["serve"] = entry.serve_tick(inp["serve"], serve_cfg, *inp["frames"],
                                    mesh=mesh, device="cpu")
    out["wide"] = entry.serve_tick(wide, wide_cfg, *inp["wide_frames"],
                                   mesh=mesh, device="cpu")
    out["engine_routes"] = _engine_routes(inp["serve"], serve_cfg,
                                          *inp["frames"], mesh)
    out["train"] = entry.train_steps(inp["train"], inp["batch"],
                                     entry.DRYRUN_CFG, steps=2, mesh=mesh,
                                     device="cpu")
    out["train_eager"] = _eager_train_steps(inp["train"], inp["batch"],
                                            entry.DRYRUN_CFG, mesh)
    out["scan_routes"] = _scan_routes(serve_cfg, mesh)
    out["rule_22"] = {s: _engine_rule(mesh, inp["serve"], serve_cfg, s)
                      for s in (2, 3, 4)}

    # train_synthetic over the same ranks (the group is already joined).
    from gstreamer_vit_tracker_tpu_torch.scripts import train_synthetic

    from gstreamer_vit_tracker_tpu_torch.train import step as tstep

    buf = io.StringIO()
    scans = tstep._scan_step.traces
    with contextlib.redirect_stdout(buf):
        rep = train_synthetic.run(TRAIN_ARGV + ["--mesh", "2x2", "--out",
                                                inp["out"]])
    out["script"] = {"rc": rep.rc, "losses": rep.losses,
                     "stdout": buf.getvalue(),
                     "scan_captures": tstep._scan_step.traces - scans}
    full = weights.flatten(weights.tree_to_numpy(
        sharding.gather_params(rep.state.params, mesh)))
    if rank == 0:
        out["script"]["gathered"] = full

    # Pure data over four ranks: the rule, and the stream tracker.
    pure = make_mesh((4, 1), device="cpu")
    out["rule_41"] = {s: _engine_rule(pure, inp["serve"], serve_cfg, s)
                      for s in (4, 6)}
    out["tracker"] = _tracker_run(pure, inp["corr"], compiled=True)
    out["tracker_eager"] = _tracker_run(pure, inp["corr"], compiled=False)
    return out


def _tracker_run(mesh, params, compiled):
    """The 4x1 tracker: three ticks, a poisoned state, ``recover`` and a
    fourth tick, through the compiled program or the eager body."""
    cfg = ModelConfig(**CORR)
    t = ShardedStreamTracker(mesh, params, cfg, frame_format="rgb",
                             snapshot_every=2, device="cpu")
    t.compiled = compiled
    frames0, bboxes = _corr_frames(0)
    t.init(frames0, bboxes)
    ticks = [[v.numpy() for v in t.update(_corr_frames(i)[0])]
             for i in range(1, 4)]
    # Poison the live state (what a dead device leaves behind: tensors
    # whose data cannot be read, here meta tensors).
    t.state = type(t.state)(*(torch.empty_like(x, device="meta")
                              for x in t.state))
    frames4 = _corr_frames(4)[0]
    try:
        t.update(frames4)
        poisoned = "ok"
    except Exception:
        poisoned = "raises"
    t.recover()
    boxes, scores = t.update(frames4)
    return {"ticks": ticks, "first": ticks[0],
            "local_rows": t.state.bbox.shape[0], "poisoned": poisoned,
            "boxes_ok": ticks[-1][0], "boxes": boxes.numpy(),
            "scores": scores.numpy(), "state": [x.numpy() for x in t.state],
            "captures": t._step.traces}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    serve, wide = _params(SERVE, 7), _params(WIDE, 5)
    train = _params(dataclasses.asdict(entry.DRYRUN_CFG), 0)
    corr = _params(CORR, 0)
    batch = data.make_batch(np.random.default_rng(0), 4, entry.DRYRUN_CFG)
    inp = dict(serve=serve, wide=wide, train=train, corr=corr, batch=batch,
               frames=_serve_inputs(1, 8), wide_frames=_serve_inputs(2, 4),
               out=str(tmp_path_factory.mktemp("mesh") / "w.npz"))
    return inp, run_ranks(_rank_jobs, 4, inp, device="cpu", timeout=600)


# ---------------------------------------------------------------------------
# Pure parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_equals_jax(n):
    from gstreamer_vit_tracker_tpu.parallel import mesh as jmesh

    assert factor_mesh(n) == jmesh.factor_mesh(n)


def test_param_pspec_equals_jax_on_every_flagship_leaf():
    import jax

    from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxConfig
    from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack
    from gstreamer_vit_tracker_tpu.parallel import sharding as jsharding

    tree = jax.eval_shape(lambda: jvittrack.init_params(
        jax.random.PRNGKey(0), JaxConfig()))
    specs = jax.tree_util.tree_map_with_path(jsharding.param_pspec, tree)
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(s)
            for p, s in leaves}
    ours = vittrack.init_params(torch.Generator().manual_seed(0),
                                PRESETS["vittrack-t"], device="cpu")
    got = {}
    sharding.tree_map_with_path(lambda p, x: got.setdefault(
        "/".join(map(str, p)), sharding.param_pspec(p, x)), ours)
    assert len(got) == len(want) > 150
    assert got == want
    assert sum(bool(s) for s in got.values()) == 6 * 12


def test_a_collective_inside_a_subset_body_raises():
    """The engine's slot write runs on the ranks that hold the slot only:
    a collective there raises, naming the body, before it is issued."""
    from gstreamer_vit_tracker_tpu_torch.parallel import tensor as ptensor

    with ptensor.no_collectives("engine.write_slot"):
        with pytest.raises(RuntimeError,
                           match="engine.write_slot: an all-reduce"):
            ptensor.all_reduce_sum(torch.ones(2), None)
        with pytest.raises(RuntimeError,
                           match="engine.write_slot: an all-gather"):
            ptensor.all_gather_cat(torch.ones(2), 0, None)


def test_make_mesh_needs_cuda_without_a_device():
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1, 1))
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# On four ranks
# ---------------------------------------------------------------------------

def test_shard_params_gathers_back_to_the_input(ranks):
    _, res = ranks
    assert all(r["gather_equal"] for r in res)
    # D=192 at tp=2: qkv's 576 columns split 288 / 288 (all of q and half
    # of k on model rank 0).
    assert {r["qkv_shard"] for r in res} == {(192, 288)}
    assert {r["odd_batch"] for r in res} == {"raises"}
    assert {r["too_big"] for r in res} == {"mesh (4, 2) needs 8 devices, "
                                           "have 4"}


def _jax_engine_tick(params, cfg_kw, frames0, frames1, bbs):
    from gstreamer_vit_tracker_tpu.serve import SlotEngine as JaxSlotEngine

    eng = JaxSlotEngine(_jax_tree(params), _jax_cfg(cfg_kw), slots=len(bbs),
                        frame_format="nv12")
    for i in range(len(bbs)):
        eng.init_slot(eng.alloc(), (frames0[0][i], frames0[1][i]), bbs[i])
    return eng.step(frames1, np.ones(len(bbs), bool))


def test_dp_tp_slot_engine_tick_matches_jax(ranks):
    inp, res = ranks
    want = _jax_engine_tick(inp["serve"], SERVE, *inp["frames"])
    for r in res:
        assert r["serve"]["qkv_split"]
        np.testing.assert_allclose(r["serve"]["packed"], want, rtol=1e-4,
                                   atol=1e-4)


def test_flagship_width_tp_tick_matches_jax(ranks):
    # 3 heads over 2 model ranks: qkv is gathered before attention.
    inp, res = ranks
    want = _jax_engine_tick(inp["wide"], WIDE, *inp["wide_frames"])
    for r in res:
        assert r["wide"]["qkv_split"]
        np.testing.assert_allclose(r["wide"]["packed"], want, rtol=1e-4,
                                   atol=1e-4)


def test_dp_tp_train_step_matches_jax_and_one_process(ranks):
    import jax.numpy as jnp

    from gstreamer_vit_tracker_tpu.train import step as jstep

    inp, res = ranks
    cfg = entry.DRYRUN_CFG
    jst = jstep.create_train_state(_jax_tree(inp["train"]))
    _, jloss, _ = jstep.train_step(jst, *(jnp.asarray(a) for a in
                                          inp["batch"]),
                                   _jax_cfg(dataclasses.asdict(cfg)),
                                   use_pallas=False)
    one = entry.train_steps(inp["train"], inp["batch"], cfg, steps=2,
                            device="cpu")
    got = res[0]["train"]
    for r in res:
        assert r["train"]["losses"] == got["losses"]
    assert abs(got["losses"][0] - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert abs(got["losses"][1] - one["losses"][1]) <= (
        STEP_LOSS_RTOL * abs(one["losses"][1]))
    for key, want in one["params"].items():
        np.testing.assert_allclose(got["params"][key], want, rtol=0,
                                   atol=STEP_PARAMS_ATOL, err_msg=key)
        np.testing.assert_allclose(got["mu"][key], one["mu"][key], rtol=0,
                                   atol=STEP_MU_ATOL, err_msg=key)


def test_dp_tp_slot_engine_compiled_equals_the_eager_body(ranks):
    _, res = ranks
    for r in res:
        eager, compiled = r["engine_routes"]
        for a, b in zip(eager["rows"] + eager["state"],
                        compiled["rows"] + compiled["state"]):
            np.testing.assert_array_equal(a, b)
        # One capture of the tick; the slot write once on every rank (each
        # holds slots: 8 slots over 2 data ranks), none eagerly.
        assert compiled["captures"] == (1, 1)
        assert eager["captures"] == (0, 0)


def test_dp_tp_train_step_compiled_equals_the_eager_body(ranks):
    _, res = ranks
    for r in res:
        got, want = r["train"], r["train_eager"]
        assert got["route"] == "compiled"
        assert got["losses"] == want["losses"]
        for key in want["params"]:
            np.testing.assert_array_equal(got["params"][key],
                                          want["params"][key], err_msg=key)
            np.testing.assert_array_equal(got["mu"][key], want["mu"][key],
                                          err_msg=key)


def test_dp_tp_train_scan_compiled_equals_the_eager_scan(ranks):
    _, res = ranks
    for r in res:
        (l_e, p_e, g_e), (l_c, p_c, g_c) = r["scan_routes"]
        np.testing.assert_array_equal(l_e, l_c)
        np.testing.assert_array_equal(g_e, g_c)
        for a, b in zip(p_e, p_c):
            np.testing.assert_array_equal(a, b)
        assert r["script"]["scan_captures"] >= 1    # the script's route


def test_sharded_stream_tracker_compiled_equals_the_eager_body(ranks):
    _, res = ranks
    for r in res:
        got, want = r["tracker"], r["tracker_eager"]
        for a, b in zip(got["ticks"], want["ticks"]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        for key in ("boxes", "scores"):
            np.testing.assert_array_equal(got[key], want[key])
        for a, b in zip(got["state"], want["state"]):
            np.testing.assert_array_equal(a, b)
        assert got["poisoned"] == want["poisoned"] == "raises"
        # A capture before recover() and one after it (new params), on
        # every rank together.
        assert got["captures"] == 2 and want["captures"] == 0


def test_slots_must_tile_the_data_axis(ranks):
    _, res = ranks
    for r in res:
        # The model axis does not split slots: 2 and 4 on a 2x2 mesh.
        assert r["rule_22"] == {2: "ok", 3: "raises", 4: "ok"}
        assert r["rule_41"] == {4: "ok", 6: "raises"}


def test_sharded_stream_tracker_matches_jax_and_recovers(ranks):
    from gstreamer_vit_tracker_tpu.parallel import ShardedStreamTracker as J
    from gstreamer_vit_tracker_tpu.parallel import mesh as jmesh

    inp, res = ranks
    jt = J(jmesh.make_mesh((8, 1)), _jax_tree(inp["corr"]), _jax_cfg(CORR),
           frame_format="rgb")
    jt.init(*_corr_frames(0))
    jticks = [[np.asarray(v) for v in jt.update(_corr_frames(i)[0])]
              for i in range(1, 4)]
    for r in res:
        tr = r["tracker"]
        assert tr["local_rows"] == 2          # 8 streams over 4 data ranks
        for (boxes, scores), (jboxes, jscores) in zip(tr["ticks"], jticks):
            np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-3)
            np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-4)
        assert tr["poisoned"] == "raises"
        assert tr["boxes"].shape == (8, 1, 4)
        assert np.isfinite(tr["boxes"]).all()
        # Recovered tracks resume near where the healthy run left them
        # (snapshot staleness <= snapshot_every ticks).
        assert np.abs(tr["boxes"][:, 0, :2]
                      - tr["boxes_ok"][:, 0, :2]).max() < 24.0


def test_train_synthetic_mesh_saves_the_gathered_checkpoint(ranks):
    from gstreamer_vit_tracker_tpu_torch.scripts import train_synthetic

    inp, res = ranks
    lines = res[0]["script"]["stdout"].splitlines()
    assert "mesh: dp=2 x tp=2 over 4 devices" in lines
    assert lines[-1] == f"saved {inp['out']}"
    assert all(r["script"]["rc"] == 0 and r["script"]["stdout"] == ""
               for r in res[1:])
    with np.load(inp["out"]) as saved:
        gathered = res[0]["script"]["gathered"]
        assert set(saved.files) == set(gathered)
        for k in saved.files:
            np.testing.assert_array_equal(saved[k], gathered[k])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        one = train_synthetic.run(TRAIN_ARGV + ["--out", inp["out"] + ".1"])
    np.testing.assert_allclose(res[0]["script"]["losses"], one.losses,
                               rtol=1e-5)
