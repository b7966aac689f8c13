"""PyTorch port: config copy and checkpoint loading against the JAX package.

The same npz arrays go to JAX's ``weights.load_npz`` and to the port's
``load_npz``; every leaf must come out with JAX's shape and the same
values, and the derived grouped head must be identical; corr-tiny's
head-less tree crosses both ways.  The port's own copies of pure-Python
modules (``config.py``, ``serve/protocol.py``, ``serve/client.py``) stay
equal to the originals, and no module of the port imports JAX or the JAX
package.
"""

import dataclasses
import os
import re
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import heads as jheads  # noqa: E402
from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.serve import client as jclient  # noqa: E402
from gstreamer_vit_tracker_tpu.serve import protocol as jprotocol  # noqa: E402
from gstreamer_vit_tracker_tpu_torch import config as tconfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import heads as theads  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import client as tclient  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.serve import protocol as tprotocol  # noqa: E402

PRESETS = ("small", "vittrack-t")        # the presets with shipped weights
ALL_PRESETS = ("corr-tiny",) + PRESETS


def _jax_flat(preset):
    cfg = JAX_PRESETS[preset]
    like = jax.eval_shape(
        lambda: jvittrack.init_params(jax.random.PRNGKey(0), cfg))
    return jweights._flatten(jweights.load_npz(
        tweights.checkpoint_path(preset), like))


def test_model_config_is_a_faithful_copy():
    jf = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.ModelConfig)}
    assert tf == jf
    for prop in ("feat_size", "template_feat_size", "num_template_tokens",
                 "num_search_tokens", "num_tokens"):
        for preset in ALL_PRESETS:
            assert (getattr(tconfig.PRESETS[preset], prop)
                    == getattr(JAX_PRESETS[preset], prop))


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_presets_match_app_presets(preset):
    assert sorted(tconfig.PRESETS) == sorted(JAX_PRESETS)
    assert (dataclasses.asdict(tconfig.PRESETS[preset])
            == dataclasses.asdict(JAX_PRESETS[preset]))


@pytest.mark.parametrize("preset", PRESETS)
def test_checkpoint_loads_like_jax(preset):
    jflat = _jax_flat(preset)
    tflat = tweights.flatten(tweights.load_npz(tweights.checkpoint_path(preset),
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


# ---------------------------------------------------------------------------
# The port's own copies of the serving protocol and client
# ---------------------------------------------------------------------------

def test_protocol_constants_are_a_faithful_copy():
    assert tprotocol.MAX_BODY == jprotocol.MAX_BODY
    assert tprotocol.FORMATS == jprotocol.FORMATS
    for fmt in jprotocol.FORMATS:
        for h, w in ((1080, 1920), (32, 48), (2, 2)):
            assert (tprotocol.frame_nbytes(fmt, h, w)
                    == jprotocol.frame_nbytes(fmt, h, w))
    with pytest.raises(ValueError, match="unknown frame format"):
        tprotocol.frame_nbytes("bgr", 2, 2)
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("_"))
    assert public(tprotocol) == public(jprotocol)
    assert public(tclient) == public(jclient)


def _frame(fmt, rng, h=32, w=48):
    if fmt == "nv12":
        return (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h // 2, w // 2, 2), dtype=np.uint8))
    shape = (h, w * 2) if fmt == "yuy2" else (h, w, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("fmt", ["nv12", "yuy2", "rgb"])
@pytest.mark.parametrize("sender,receiver", [("jax", "port"), ("port", "jax")])
def test_protocol_messages_cross_between_the_packages(fmt, sender, receiver):
    mods = {"jax": jprotocol, "port": tprotocol}
    tx, rx = mods[sender], mods[receiver]
    frame = _frame(fmt, np.random.default_rng(5))
    header = {"op": "init", "bbox": [1.5, 2.0, 30.0, 40.25], "slot": 3}
    a, b = socket.socketpair()
    try:
        a.settimeout(10), b.settimeout(10)
        payload = tx.frame_to_bytes(fmt, frame)
        assert payload == rx.frame_to_bytes(fmt, frame)
        tx.send_msg(a, header, payload)
        got_header, got_payload = rx.recv_msg(b, max_body=len(payload) + 4096)
        assert got_header == header and got_payload == payload
        back = rx.frame_from_bytes(fmt, 32, 48, got_payload)
        for p, q in zip(back if fmt == "nv12" else (back,),
                        frame if fmt == "nv12" else (frame,)):
            np.testing.assert_array_equal(p, q)
        with pytest.raises(ValueError):
            rx.frame_from_bytes(fmt, 32, 50, got_payload)
    finally:
        a.close(), b.close()


@pytest.mark.parametrize("body,match", [
    (None, "exceeds limit"), (b"no separator at all", "malformed"),
    (b"not json\npayload", "malformed"), (b"[1,2,3]\npayload", "malformed")])
def test_port_protocol_rejects_what_the_original_rejects(body, match):
    for mod in (jprotocol, tprotocol):
        a, b = socket.socketpair()
        try:
            b.settimeout(10)
            if body is None:
                a.sendall(b"\xff\xff\xff\xff")          # declares ~4.3 GB
            else:
                a.sendall(len(body).to_bytes(4, "little") + body)
            with pytest.raises(ValueError, match=match):
                mod.recv_msg(b)
        finally:
            a.close(), b.close()


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "gstreamer_vit_tracker_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(root, "chip_smoke.py")]
    assert len(files) > 30
    names = {os.path.relpath(p, root) for p in files}
    for must in ("gstreamer_vit_tracker_tpu_torch/app/main.py",
                 "gstreamer_vit_tracker_tpu_torch/session/machine.py",
                 "gstreamer_vit_tracker_tpu_torch/media/source.py",
                 "gstreamer_vit_tracker_tpu_torch/train/step.py",
                 "gstreamer_vit_tracker_tpu_torch/train/losses.py",
                 "gstreamer_vit_tracker_tpu_torch/ops/fused_prep_embed.py",
                 "gstreamer_vit_tracker_tpu_torch/ops/vit_block.py",
                 "gstreamer_vit_tracker_tpu_torch/train/data.py",
                 "gstreamer_vit_tracker_tpu_torch/media/indie.py",
                 "gstreamer_vit_tracker_tpu_torch/models/import_onnx.py",
                 "gstreamer_vit_tracker_tpu_torch/models/export_onnx.py",
                 "gstreamer_vit_tracker_tpu_torch/compat/cv2vit.py",
                 "gstreamer_vit_tracker_tpu_torch/utils/flops.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/train_synthetic.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/eval_tracking.py",
                 "gstreamer_vit_tracker_tpu_torch/runtime/__init__.py",
                 "gstreamer_vit_tracker_tpu_torch/tracker/scan.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/profile_scan.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/profile_streams.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/bench_serve.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/soak.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/export_vittrack_onnx.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/import_vittrack_onnx.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/agreement_cv2.py",
                 "gstreamer_vit_tracker_tpu_torch/parallel/mesh.py",
                 "gstreamer_vit_tracker_tpu_torch/parallel/sharding.py",
                 "gstreamer_vit_tracker_tpu_torch/parallel/serving.py",
                 "gstreamer_vit_tracker_tpu_torch/parallel/tensor.py",
                 "gstreamer_vit_tracker_tpu_torch/parallel/launch.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/ab_fused_prep.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/ab_grouped_head.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/probe_int8.py",
                 "gstreamer_vit_tracker_tpu_torch/scripts/probe_relay_fetch.py",
                 "gstreamer_vit_tracker_tpu_torch/bench.py",
                 "gstreamer_vit_tracker_tpu_torch/utils/graph.py",
                 "chip_smoke.py"):
        assert must in names, must
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|"
                     r"gstreamer_vit_tracker_tpu)(\.|\s|$)", re.M)
    # ... nor by name at run time.
    dynamic = re.compile(r"(import_module|__import__)\(\s*[\"'](jax|flax|optax|"
                         r"orbax|gstreamer_vit_tracker_tpu)[\"'.]")
    for path in files:
        with open(path) as f:
            text = f.read()
        hit = bad.search(text) or dynamic.search(text)
        assert hit is None, f"{path}: {hit.group(0)!r}"


@pytest.mark.parametrize("preset", sorted(tweights.CHECKPOINTS))
def test_params_go_back_to_the_checkpoint_layout(preset):
    """``flatten`` and ``tree_to_numpy`` are the other direction of
    ``params_from_flat``: the flat keys and arrays of the npz, exactly."""
    cfg = tconfig.PRESETS[preset]
    flat = _flat_npz(preset)
    params = tweights.params_from_flat(flat, cfg, device="cpu")
    back = tweights.flatten(tweights.tree_to_numpy(params))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], arr.astype(np.float32))
    # The same keys as the JAX package's own flattening of its tree.
    assert set(back) == set(_jax_flat(preset))
    # Tensors flatten too (what the training tests compare), lists by index.
    tflat = tweights.flatten(params)
    assert tflat["backbone/blocks/0/qkv/kernel"] is \
        params["backbone"]["blocks"][0]["qkv"]["kernel"]


def test_corr_tiny_headless_tree_round_trips(tmp_path):
    """corr-tiny has no head: JAX's seeded tree crosses into the port
    through ``save_npz`` / ``load_npz``, and the port's seeded tree crosses
    back through ``flatten`` / ``tree_to_numpy`` into JAX's ``load_npz``."""
    from gstreamer_vit_tracker_tpu_torch.models import vittrack as tvittrack

    cfg_j, cfg_t = JAX_PRESETS["corr-tiny"], tconfig.PRESETS["corr-tiny"]
    jparams = jvittrack.init_params(jax.random.PRNGKey(0), cfg_j)
    assert "head" not in jparams
    path = str(tmp_path / "jax.npz")
    jweights.save_npz(path, jparams)
    tparams = tweights.load_npz(path, cfg_t, device="cpu")
    assert sorted(tparams) == ["backbone"]
    jflat = jweights._flatten(jparams)
    tflat = tweights.flatten(tweights.tree_to_numpy(tparams))
    assert sorted(tflat) == sorted(jflat)
    for k, a in jflat.items():
        np.testing.assert_array_equal(tflat[k], a, err_msg=k)

    gen = torch.Generator().manual_seed(1)
    ours = tweights.flatten(tweights.tree_to_numpy(
        tvittrack.init_params(gen, cfg_t, device="cpu")))
    back_path = str(tmp_path / "port.npz")
    np.savez(back_path, **ours)
    back = jweights._flatten(jweights.load_npz(back_path, jparams))
    assert sorted(back) == sorted(ours)
    for k, a in ours.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
