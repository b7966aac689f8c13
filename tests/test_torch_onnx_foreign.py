"""PyTorch port, ``models/import_onnx.py`` on a foreign producer's file,
against the JAX package on the CPU.

``tests/test_torch_onnx.py`` reads only files that the two packages' own
writers made.  Here the fixture is JAX's test's: ``_write_foreign_onnx``
(an independent protobuf emitter: the name first, packed dims, packed
``float_data`` for some tensors and ``raw_data`` for others, packed int64
data, graph nodes and producer metadata on the wire) writing
``_ostrack_inventory`` (the upstream OSTrack export's tensor names: the
``backbone.`` scoping and the conv+BN head towers whose folding must land on
the flagship's head weights).  The port's ``read_onnx_tensors`` reads the
same names, dtypes and bits as JAX's; its ``load_onnx(strict=True)`` fills
the same 174 leaves with the same values as JAX's, in this dialect and in
the two prefix dialects that the name maps alias (DataParallel's
``module.`` wrapper and an export without the ``backbone.`` scoping).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu.models import import_onnx as jimport  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import import_onnx as timport  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from test_import_onnx_foreign import (FLAGSHIP, _ostrack_inventory,  # noqa: E402
                                      _write_foreign_onnx)

CPU = torch.device("cpu")
LEAVES = 174                      # the flagship's parameter tree


@pytest.fixture(scope="module")
def foreign():
    """(JAX params, the port's like tree, the inventory) of the flagship
    as JAX's foreign-producer test makes them."""
    jparams = jvittrack.init_params(jax.random.PRNGKey(7), FLAGSHIP)
    flat = {k: np.asarray(v) for k, v in jweights._flatten(jparams).items()}
    like = tweights.params_from_flat(flat, ModelConfig(dtype="float32"),
                                     device=CPU)
    return jparams, like, _ostrack_inventory(jparams,
                                             np.random.default_rng(0))


def _dialect(inventory, dialect):
    if dialect == "backbone.":
        return inventory
    if dialect == "module.":
        return {"module." + k: v for k, v in inventory.items()}
    return {k[len("backbone."):] if k.startswith("backbone.") else k: v
            for k, v in inventory.items()}


def test_foreign_file_reads_the_same_tensors(tmp_path, foreign):
    _, _, inventory = foreign
    path = str(tmp_path / "foreign.onnx")
    _write_foreign_onnx(path, inventory)
    want = jimport.read_onnx_tensors(path)
    got = timport.read_onnx_tensors(path)
    assert list(got) == list(want) == list(inventory)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype == inventory[name].dtype, name
        assert got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    # The BN towers' int64 step counters come through as int64 scalars.
    steps = [k for k in got if k.endswith("num_batches_tracked")]
    assert steps and all(got[k].reshape(-1).tolist() == [8734] for k in steps)


@pytest.mark.parametrize("dialect", ["backbone.", "module.", "unscoped"])
def test_foreign_file_loads_strict_like_jax(tmp_path, foreign, dialect):
    jparams, like, inventory = foreign
    path = str(tmp_path / "foreign.onnx")
    _write_foreign_onnx(path, _dialect(inventory, dialect))
    want = jweights._flatten(jimport.load_onnx(path, jparams, strict=True))
    got = tweights.flatten(timport.load_onnx(path, like, strict=True,
                                             device=CPU))
    assert len(want) == len(got) == LEAVES
    assert list(got) == list(want)
    ref = jweights._flatten(jparams)
    for name, arr in want.items():
        arr = np.asarray(arr)
        assert got[name].dtype == torch.float32 and arr.dtype == np.float32
        assert tuple(got[name].shape) == arr.shape, name
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)
        # ... and BN folding lands on the weights the inventory came from.
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=2e-5, atol=2e-5, err_msg=name)


def test_foreign_file_missing_a_tensor_fails_strict_like_jax(tmp_path, foreign):
    jparams, like, inventory = foreign
    path = str(tmp_path / "foreign.onnx")
    _write_foreign_onnx(path, {k: v for k, v in inventory.items()
                               if k != "backbone.blocks.3.mlp.fc2.bias"})
    with pytest.raises(ValueError) as jerr:
        jimport.load_onnx(path, jparams, strict=True)
    with pytest.raises(ValueError) as terr:
        timport.load_onnx(path, like, strict=True, device=CPU)
    assert str(terr.value) == str(jerr.value)
    assert "backbone/blocks/3/mlp2/bias" in str(terr.value)
