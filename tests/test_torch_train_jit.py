"""PyTorch port, compiled training (``train/step.py``'s ``train_step`` and
``train_scan`` through ``utils/graph.py::Compiled``) on the CPU, where the
wrapper's plumbing runs with the body called eagerly for each step: the
``small`` preset at depth 2, float32, one intra-op thread.

* the compiled ``train_step`` against JAX's jitted ``train_step`` over 3
  steps with EMA and a warmup schedule: loss rtol 1e-4, params and EMA
  within 3 x lr, mu rtol 1e-3, nu rtol 2e-3 (``test_torch_train.py``'s
  tolerances and reasons);
* the compiled ``train_step`` and ``train_scan`` against the eager bodies
  (``train_step_eager``, ``train_scan_eager``) bit for bit, augmentation
  on and off, from the same seeded CPU generator, which both leave in the
  same state;
* the wrapper's contract: the returned state passed back is neither traced
  anew nor copied; a state from elsewhere is left as it was; a new batch
  of the same shape replays; another ``opt`` or ``ema_decay`` traces; a
  draw window smaller than ``n_steps`` gives what one window gives; a
  refreshed dataset of the same shape replays and is copied in; a
  compiled wrapper under a mesh raises and names the roadmap's item.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.train import step as jstep  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.parallel.mesh import use_mesh  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.train import step as tstep  # noqa: E402

CPU = torch.device("cpu")
LR = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """JAX's initial parameters at depth 2 (``test_torch_train.py``'s
    fixture) in both packages' configs, as a flat numpy tree."""
    cfg_j = dataclasses.replace(JAX_PRESETS["small"], depth=2)
    cfg_t = dataclasses.replace(PRESETS["small"], depth=2)
    jparams = jvittrack.init_params(jax.random.PRNGKey(0), cfg_j)
    flat = {k: np.array(v) for k, v in jweights._flatten(jparams).items()}
    return cfg_j, jparams, cfg_t, flat


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 1, (b, cfg.template_size, cfg.template_size, 3))
    x = rng.normal(0, 1, (b, cfg.search_size, cfg.search_size, 3))
    gt = np.concatenate([rng.uniform(0.3, 0.7, (b, 2)),
                         rng.uniform(0.1, 0.4, (b, 2)),
                         (rng.uniform(size=(b, 1)) > 0.3)], axis=1)
    return (z.astype(np.float32), x.astype(np.float32),
            gt.astype(np.float32))


def _dataset(cfg, n, seed):
    rng = np.random.default_rng(seed)
    ds_z = rng.integers(0, 256, (n, cfg.template_size, cfg.template_size, 3),
                        dtype=np.uint8)
    ds_x = rng.integers(0, 256, (n, cfg.search_size, cfg.search_size, 3),
                        dtype=np.uint8)
    ds_gt = np.concatenate([rng.uniform(0.3, 0.7, (n, 2)),
                            rng.uniform(0.1, 0.4, (n, 2)),
                            rng.uniform(size=(n, 1)) > 0.2],
                           1).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (ds_z, ds_x, ds_gt))


def _opt(tag: int, **kw):
    """An optimizer no other test's key holds (the wrappers' captures live
    as long as the process: a tag moves the weight decay)."""
    return tstep.make_optimizer(LR, weight_decay=1e-4 + tag * 1e-7, **kw)


def _state(flat, cfg, opt, ema=0.0):
    return tstep.create_train_state(
        tweights.params_from_flat(flat, cfg, device=CPU), opt=opt,
        ema_decay=ema)


def _leaves(state):
    return [t.clone() for t in tstep.tree_leaves(
        [state.params, state.opt_state.mu, state.opt_state.nu,
         state.ema_params or {}])] + [state.step.clone(),
                                      state.opt_state.count.clone()]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_compiled_train_step_matches_jax_jitted_step(start):
    cfg_j, jparams, cfg_t, flat = start
    ema = 0.9
    kw = dict(total_steps=30, warmup_steps=1)
    jopt, topt = jstep.make_optimizer(LR, **kw), tstep.make_optimizer(LR, **kw)
    jst = jstep.create_train_state(jax.tree.map(jnp.copy, jparams), opt=jopt,
                                   ema_decay=ema)
    tst = _state(flat, cfg_t, topt, ema)
    traces = tstep.train_step.traces
    for i in range(3):
        z, x, gt = _batch(cfg_t, 4, seed=20 + i)
        jst, jl, jparts = jstep.train_step(
            jst, jnp.asarray(z), jnp.asarray(x), jnp.asarray(gt), cfg_j,
            use_pallas=False, opt=jopt, ema_decay=ema)
        tst, tl, tparts = tstep.train_step(tst, z, x, gt, cfg_t, opt=topt,
                                           ema_decay=ema, device=CPU)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4,
                                   err_msg=f"loss, step {i}")
        for k in jparts:
            np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert tstep.train_step.traces == traces + 1      # one key, 3 steps
    assert int(tst.step) == int(jst.step) == 3
    adam = jst.opt_state[1][0]
    pairs = ((jst.params, tst.params, 0, 3 * LR),
             (jst.ema_params, tst.ema_params, 0, 3 * LR),
             (adam.mu, tst.opt_state.mu, 1e-3, 1e-6),
             (adam.nu, tst.opt_state.nu, 2e-3, 1e-9))
    for jtree, ttree, rtol, atol in pairs:
        jf = jweights._flatten(jtree)
        tf = tweights.flatten(tweights.tree_to_numpy(ttree))
        assert set(jf) == set(tf)
        for key in jf:
            np.testing.assert_allclose(tf[key], np.asarray(jf[key]),
                                       rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_compiled_train_step_equals_the_eager_body(start, ema):
    _, _, cfg_t, flat = start
    opt = _opt(1, total_steps=10, warmup_steps=2)
    eager, comp = _state(flat, cfg_t, opt, ema), _state(flat, cfg_t, opt, ema)
    for i in range(3):
        z, x, gt = _batch(cfg_t, 3, seed=40 + i)
        eager, el, ep = tstep.train_step_eager(eager, z, x, gt, cfg_t,
                                               opt=opt, ema_decay=ema,
                                               device=CPU)
        comp, cl, cp = tstep.train_step(comp, z, x, gt, cfg_t, opt=opt,
                                        ema_decay=ema, device=CPU)
        assert torch.equal(el, cl) and set(ep) == set(cp)
        assert all(torch.equal(ep[k], cp[k]) for k in ep)
    assert _equal(_leaves(eager), _leaves(comp))


@pytest.mark.parametrize("augment", [True, False])
def test_compiled_train_scan_equals_the_eager_scan(start, augment):
    _, _, cfg_t, flat = start
    opt = _opt(2, total_steps=10, warmup_steps=1)
    ds = _dataset(cfg_t, 7, seed=3)
    g_e, g_c = (torch.Generator().manual_seed(5) for _ in range(2))
    se, g_e2, le, pe = tstep.train_scan_eager(
        _state(flat, cfg_t, opt, 0.5), *ds, g_e, cfg_t, opt, 4, 3,
        ema_decay=0.5, augment=augment, device=CPU)
    sc, g_c2, lc, pc = tstep.train_scan(
        _state(flat, cfg_t, opt, 0.5), *ds, g_c, cfg_t, opt, 4, 3,
        ema_decay=0.5, augment=augment, device=CPU)
    assert g_e2 is g_e and g_c2 is g_c
    assert torch.equal(g_e.get_state(), g_c.get_state())
    assert torch.equal(le, lc) and lc.shape == (4,)
    assert set(pe) == set(pc) == set(tstep.PARTS)
    assert all(torch.equal(pe[k], pc[k]) for k in pe)
    assert _equal(_leaves(se), _leaves(sc))


def test_a_small_draw_window_equals_one_window(start, monkeypatch):
    _, _, cfg_t, flat = start
    opt = _opt(3)
    ds = _dataset(cfg_t, 6, seed=4)
    crop = tuple(ds[1].shape[1:])
    assert tstep.window_steps(5, 2, crop, True) == 5
    whole = tstep.train_scan(_state(flat, cfg_t, opt), *ds,
                             torch.Generator().manual_seed(9), cfg_t, opt,
                             5, 2, device=CPU)
    # Two steps' draws a window: windows of 2, 2 and 1 steps.
    per_step = 8 * 2 + 4 * 2 * (3 + int(np.prod(crop)))
    monkeypatch.setattr(tstep, "DRAW_WINDOW_BYTES", 2 * per_step + 1)
    assert tstep.window_steps(5, 2, crop, True) == 2
    traces = tstep._scan_step.traces
    gen = torch.Generator().manual_seed(9)
    parts = tstep.train_scan(_state(flat, cfg_t, opt), *ds, gen, cfg_t, opt,
                             5, 2, device=CPU)
    assert tstep._scan_step.traces == traces + 1      # one key, 3 windows
    assert torch.equal(whole[2], parts[2])
    assert torch.equal(whole[1].get_state(), gen.get_state())
    assert _equal(_leaves(whole[0]), _leaves(parts[0]))


def test_the_returned_state_passed_back_is_not_copied(start):
    _, _, cfg_t, flat = start
    opt = _opt(4)
    z, x, gt = _batch(cfg_t, 2, seed=50)
    st0 = _state(flat, cfg_t, opt)
    before = _leaves(st0)
    traces, copies = tstep.train_step.traces, tstep.train_step.copies
    st1, _, _ = tstep.train_step(st0, z, x, gt, cfg_t, opt=opt, device=CPU)
    n_state = len(tstep.tree_leaves(list(st0[:3])))   # no EMA leaves
    assert tstep.train_step.traces == traces + 1
    assert tstep.train_step.copies == copies + n_state + 3
    # A state from elsewhere is copied in and left as it was.
    assert _equal(_leaves(st0), before)
    # The returned state passed back: no trace, only the batch copied; a
    # new batch of the same shape replays.
    z2, x2, gt2 = _batch(cfg_t, 2, seed=51)
    st2, _, _ = tstep.train_step(st1, z2, x2, gt2, cfg_t, opt=opt,
                                 device=CPU)
    assert all(a is b for a, b in zip(                # donated
        tstep.tree_leaves(st2.params), tstep.tree_leaves(st1.params)))
    assert tstep.train_step.traces == traces + 1
    assert tstep.train_step.copies == copies + n_state + 6
    assert int(st2.step) == 2
    # The two steps equal the eager chain's.
    want = tstep.train_step_eager(
        tstep.train_step_eager(_state(flat, cfg_t, opt), z, x, gt, cfg_t,
                               opt=opt, device=CPU)[0],
        z2, x2, gt2, cfg_t, opt=opt, device=CPU)[0]
    assert _equal(_leaves(want), _leaves(st2))


def test_static_arguments_make_new_keys(start):
    _, _, cfg_t, flat = start
    z, x, gt = _batch(cfg_t, 2, seed=52)
    opt = _opt(5)
    traces = tstep.train_step.traces
    st = tstep.train_step(_state(flat, cfg_t, opt), z, x, gt, cfg_t,
                          opt=opt, device=CPU)[0]
    # An equal optimizer is the same static value (a frozen dataclass).
    st = tstep.train_step(st, z, x, gt, cfg_t, opt=_opt(5), device=CPU)[0]
    assert tstep.train_step.traces == traces + 1
    tstep.train_step(st, z, x, gt, cfg_t, opt=_opt(6), device=CPU)
    assert tstep.train_step.traces == traces + 2
    st = _state(flat, cfg_t, opt, ema=0.9)
    tstep.train_step(st, z, x, gt, cfg_t, opt=opt, ema_decay=0.9, device=CPU)
    tstep.train_step(st, z, x, gt, cfg_t, opt=opt, ema_decay=0.8, device=CPU)
    assert tstep.train_step.traces == traces + 4


def test_a_refreshed_dataset_replays_and_is_copied_in(start):
    _, _, cfg_t, flat = start
    opt = _opt(7)
    ds1, ds2 = _dataset(cfg_t, 5, seed=6), _dataset(cfg_t, 5, seed=7)
    traces = tstep._scan_step.traces
    st = _state(flat, cfg_t, opt)
    gen = torch.Generator().manual_seed(2)
    st, gen, _, _ = tstep.train_scan(st, *ds1, gen, cfg_t, opt, 2, 2,
                                     device=CPU)
    copies = tstep._scan_step.copies
    st, gen, _, _ = tstep.train_scan(st, *ds1, gen, cfg_t, opt, 2, 2,
                                     device=CPU)
    assert tstep._scan_step.copies == copies + 5      # the draws only
    st, gen, got, _ = tstep.train_scan(st, *ds2, gen, cfg_t, opt, 2, 2,
                                       device=CPU)
    assert tstep._scan_step.traces == traces + 1
    assert tstep._scan_step.copies == copies + 5 + 3 + 5
    # What the eager scan computes on the same data, from the same start.
    gen = torch.Generator().manual_seed(2)
    want = _state(flat, cfg_t, opt)
    for ds in (ds1, ds1, ds2):
        want, gen, ls, _ = tstep.train_scan_eager(want, *ds, gen, cfg_t, opt,
                                                  2, 2, device=CPU)
    assert torch.equal(ls, got) and _equal(_leaves(want), _leaves(st))


def test_compiled_training_under_a_mesh_raises(start):
    _, _, cfg_t, flat = start
    opt = tstep.make_optimizer(LR)
    z, x, gt = _batch(cfg_t, 2, seed=53)
    ds = _dataset(cfg_t, 4, seed=8)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with use_mesh(object()):
        with pytest.raises(RuntimeError, match="ROADMAP.md"):
            tstep.train_step(_state(flat, cfg_t, opt), z, x, gt, cfg_t,
                             opt=opt, device=CPU)
        with pytest.raises(RuntimeError, match="train_scan_eager"):
            tstep.train_scan(_state(flat, cfg_t, opt), *ds, gen, cfg_t, opt,
                             1, 2, device=CPU)
    assert torch.equal(gen.get_state(), state)        # nothing drawn


def test_the_compiled_scan_needs_a_cpu_generator(start):
    _, _, cfg_t, flat = start
    opt = tstep.make_optimizer(LR)
    ds = _dataset(cfg_t, 4, seed=8)
    gen = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        tstep.train_scan(_state(flat, cfg_t, opt), *ds, gen, cfg_t, opt, 1,
                         2, device=CPU)
