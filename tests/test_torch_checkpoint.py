"""PyTorch port: ``models/weights.py::save_tree`` / ``load_tree``, the
counterpart of the JAX package's ``save_orbax`` / ``load_orbax`` for an
arbitrary tree.

Round trips are bit-equal, leaf for leaf, in the container types and
dtypes of the tree given as ``like``: the shipped ``small`` parameters, a
bf16 ``TrackState`` (and its ``_asdict()``), the AdamW ``TrainState`` of
``train/step.py`` with and without its EMA copy, a JAX ``TrackState``
crossed as numpy (bf16 leaves included), and Python scalars.  A shape or a
key that differs raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.tracker.state import TrackState as JTrackState  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.tracker.state import TrackState  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.train import step  # noqa: E402

CPU = torch.device("cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_bit_equal(a, b):
    assert type(a) is type(b)
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bool
                               else x, y.view(torch.uint8)
                               if y.dtype == torch.bool else y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        else:
            assert x == y


def _track_state(seed=0, lead=()):
    g = torch.Generator().manual_seed(seed)
    return TrackState(
        z_tok=torch.randn(*lead, 64, 192, generator=g).to(torch.bfloat16),
        z_tok_init=torch.randn(*lead, 64, 192, generator=g).to(
            torch.bfloat16),
        bbox=torch.rand(*lead, 4, generator=g) * 500,
        score=torch.rand(lead, generator=g),
        frame_idx=torch.full(lead, 17, dtype=torch.int32),
        lost_frames=torch.full(lead, 2, dtype=torch.int32))


@pytest.fixture(scope="module")
def small_params():
    cfg = PRESETS["small"]
    return weights.load_npz(weights.checkpoint_path("small"), cfg,
                            device=CPU)


def test_params_round_trip(tmp_path, small_params):
    path = str(tmp_path / "params.pt")
    weights.save_tree(path, small_params)
    like = weights.tree_to(small_params, CPU, copy=True)
    for leaf in _leaves(like):
        leaf.zero_()
    _assert_bit_equal(weights.load_tree(path, like), small_params)


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_track_state_round_trips(tmp_path, lead):
    st = _track_state(1, lead)
    path = str(tmp_path / "state.pt")
    weights.save_tree(path, st)
    back = weights.load_tree(path, _track_state(2, lead))
    assert isinstance(back, TrackState)
    _assert_bit_equal(back, st)
    weights.save_tree(path, st._asdict())
    _assert_bit_equal(weights.load_tree(path, _track_state(3, lead)._asdict()),
                      st._asdict())


@pytest.mark.parametrize("ema", [0.0, 0.99])
def test_adamw_state_round_trips(tmp_path, small_params, ema):
    opt = step.make_optimizer(1e-3, total_steps=10, warmup_steps=2)
    ts = step.create_train_state(small_params, opt=opt, ema_decay=ema)
    g = torch.Generator().manual_seed(5)
    mu = step.tree_map(lambda t: torch.randn(t.shape, generator=g),
                       ts.opt_state.mu)
    ts = ts._replace(opt_state=ts.opt_state._replace(
        count=torch.tensor(7, dtype=torch.int32), mu=mu),
        step=torch.tensor(7, dtype=torch.int32))
    path = str(tmp_path / "train.pt")
    weights.save_tree(path, {"state": ts, "epoch": 3, "lr": 1e-3,
                             "done": [True, None]})
    like = {"state": step.create_train_state(small_params, opt=opt,
                                             ema_decay=ema),
            "epoch": 0, "lr": 0.0, "done": [False, None]}
    back = weights.load_tree(path, like)
    assert isinstance(back["state"], step.TrainState)
    assert isinstance(back["state"].opt_state, step.OptState)
    assert (back["state"].ema_params is None) == (ema == 0.0)
    _assert_bit_equal(back, {"state": ts, "epoch": 3, "lr": 1e-3,
                             "done": [True, None]})


def test_jax_track_state_crosses_as_numpy(tmp_path):
    rng = np.random.default_rng(0)
    jst = JTrackState(
        z_tok=jnp.asarray(rng.normal(size=(64, 192)), jnp.bfloat16),
        z_tok_init=jnp.asarray(rng.normal(size=(64, 192)), jnp.bfloat16),
        bbox=jnp.asarray([900.5, 500.25, 120.0, 90.0], jnp.float32),
        score=jnp.asarray(0.8125, jnp.float32),
        frame_idx=jnp.asarray(12, jnp.int32),
        lost_frames=jnp.asarray(0, jnp.int32))
    host = JTrackState(*(np.asarray(a) for a in jst))
    assert host.z_tok.dtype.name == "bfloat16"
    path = str(tmp_path / "jax_state.pt")
    weights.save_tree(path, host)
    like = JTrackState(*(np.zeros_like(a) for a in host))
    back = weights.load_tree(path, like)
    assert isinstance(back, JTrackState)
    _assert_bit_equal(back, host)
    # The same file read into the port's state: bf16 bits carried over.
    tback = weights.load_tree(path, _track_state())
    np.testing.assert_array_equal(tback.z_tok.float().numpy(),
                                  host.z_tok.astype(np.float32))
    np.testing.assert_array_equal(tback.bbox.numpy(), host.bbox)


def test_mismatch_raises(tmp_path):
    st = _track_state()
    path = str(tmp_path / "state.pt")
    weights.save_tree(path, st)
    with pytest.raises(ValueError, match="shape mismatch"):
        weights.load_tree(path, _track_state(lead=(2,)))
    weights.save_tree(path, {"a": torch.zeros(3), "b": torch.ones(2)})
    with pytest.raises(KeyError):
        weights.load_tree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        weights.load_tree(path, {"a": torch.zeros(4), "b": torch.ones(2)})
