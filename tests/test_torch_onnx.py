"""PyTorch port, ``models/import_onnx.py`` and ``models/export_onnx.py``
against the JAX package, on the CPU:

* ``write_onnx_tensors`` writes the same bytes; ``read_onnx_tensors`` reads
  back what either package wrote, dtype and all;
* ``fold_bn_groups`` gives the same arrays, bit for bit; ``load_onnx`` /
  ``map_tensors`` of a torch-layout file (BN groups in the head) give the
  same tree (float32, exact), as tensors on the device asked for; the
  strict mode's errors read the same;
* ``export_vittrack`` of the port's ``small`` and flagship trees (the
  shipped checkpoints) is byte-equal to the JAX package's export of the
  same npz, for both input transforms;
* ``cv2.dnn`` and ``cv2.TrackerVit`` run the port's export to the same maps
  and Rects as the JAX export (skipped, with its reason, without cv2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu.models import export_onnx as jexport  # noqa: E402
from gstreamer_vit_tracker_tpu.models import import_onnx as jimport  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS, ModelConfig  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import export_onnx as texport  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import import_onnx as timport  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import weights as tweights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.media.source import SyntheticSource  # noqa: E402

CPU = torch.device("cpu")
NARROW = dict(template_size=32, search_size=64, patch_size=16, embed_dim=32,
              depth=2, num_heads=2, dtype="float32")


def _numpy_tree(cfg, rng=None):
    """A tree of ``cfg``'s structure (``weights.param_shapes``, the JAX
    ``init_params`` layout) with float32 numpy leaves: seeded normals, or
    zeros without ``rng``.  Both packages' importers and JAX's ``load_npz``
    and exporter take such a tree as their ``like`` / ``params``."""
    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        return (np.zeros(tree, np.float32) if rng is None
                else rng.normal(0, 0.5, tree).astype(np.float32))
    return build(tweights.param_shapes(cfg))


@pytest.fixture(scope="module")
def narrow():
    """A seeded narrow tree as numpy (JAX's side) and as the port's."""
    jcfg, cfg = JModelConfig(**NARROW), ModelConfig(**NARROW)
    jparams = _numpy_tree(cfg, np.random.default_rng(3))
    flat = jweights._flatten(jparams)
    return jcfg, jparams, cfg, tweights.params_from_flat(flat, cfg, device=CPU)


def _torch_layout(flat, patch):
    """Our flat tree -> torch-export-layout ONNX tensors, with the score
    tower's first two layers as conv+BN groups (``convK_ctr.0`` / ``.1``)."""
    rng = np.random.default_rng(5)
    t = {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        parts = key.split("/")
        if key == "backbone/patch_embed/kernel":
            d = v.shape[1]
            t["backbone.patch_embed.proj.weight"] = np.ascontiguousarray(
                v.reshape(patch, patch, 3, d).transpose(3, 2, 0, 1))
        elif key.startswith("backbone/pos_embed"):
            t["backbone." + parts[1]] = v[None]
        elif parts[0] == "backbone" and parts[1] in ("patch_embed", "norm"):
            name = {"bias": "bias", "scale": "weight"}[parts[2]]
            mod = "patch_embed.proj" if parts[1] == "patch_embed" else "norm"
            t[f"backbone.{mod}.{name}"] = v
        elif parts[0] == "backbone":
            i, sub, leaf = parts[2], parts[3], parts[4]
            mod = {"ln1": "norm1", "ln2": "norm2", "qkv": "attn.qkv",
                   "proj": "attn.proj", "mlp1": "mlp.fc1",
                   "mlp2": "mlp.fc2"}[sub]
            name = {"scale": "weight", "bias": "bias", "kernel": "weight"}[leaf]
            t[f"backbone.blocks.{i}.{mod}.{name}"] = (
                np.ascontiguousarray(v.T) if leaf == "kernel" else v)
        else:
            tower, j, leaf = parts[1], int(parts[2]), parts[3]
            if tower == "score" and j < 2:
                pre = f"box_head.conv{j + 1}_ctr."
                if leaf == "kernel":
                    o = v.shape[3]
                    t[pre + "0.weight"] = np.ascontiguousarray(
                        v.transpose(3, 2, 0, 1))
                    t[pre + "1.weight"] = rng.uniform(0.5, 1.5, o).astype(
                        np.float32)
                    t[pre + "1.bias"] = rng.normal(0, 0.1, o).astype(np.float32)
                    t[pre + "1.running_mean"] = rng.normal(0, 0.2, o).astype(
                        np.float32)
                    t[pre + "1.running_var"] = rng.uniform(0.5, 2.0, o).astype(
                        np.float32)
                    t[pre + "1.num_batches_tracked"] = np.asarray(7, np.int64)
                else:
                    t[pre + "0.bias"] = v
            else:
                pre = f"box_head.{tower}.{j}."
                t[pre + ("weight" if leaf == "kernel" else "bias")] = (
                    np.ascontiguousarray(v.transpose(3, 2, 0, 1))
                    if leaf == "kernel" else v)
    return t


def _mixed_tensors():
    rng = np.random.default_rng(0)
    return {"a.weight": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "b.half": rng.normal(size=(7,)).astype(np.float16),
            "c.count": np.asarray([-3, 0, 2 ** 40], np.int64),
            "d.u8": rng.integers(0, 256, (2, 3), np.uint8),
            "e.f64": np.asarray([1.5], np.float64),
            "f.i32": np.arange(6, dtype=np.int32).reshape(2, 3)}


def test_write_bytes_equal_jax_and_read_round_trips(tmp_path):
    tensors = _mixed_tensors()
    ours, theirs = tmp_path / "t.onnx", tmp_path / "j.onnx"
    timport.write_onnx_tensors(str(ours), tensors)
    jimport.write_onnx_tensors(str(theirs), tensors)
    assert ours.read_bytes() == theirs.read_bytes()
    # A 0-d array comes back with shape (1,) (no dims), in both readers.
    scalar = {"s": np.asarray(2.5, np.float32)}
    timport.write_onnx_tensors(str(ours), scalar)
    got, want = (m.read_onnx_tensors(str(ours)) for m in (timport, jimport))
    assert got["s"].shape == want["s"].shape == (1,)
    timport.write_onnx_tensors(str(ours), tensors)
    for path in (ours, theirs):
        back = timport.read_onnx_tensors(str(path))
        assert list(back) == list(tensors)
        for k, v in tensors.items():
            assert back[k].dtype == v.dtype and back[k].shape == v.shape
            np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="not exportable"):
        timport.write_onnx_tensors(str(ours), {"x": np.zeros(2, np.bool_)})


def test_fold_bn_groups_equal_jax(narrow):
    _, jparams, _, _ = narrow
    tensors = _torch_layout(jweights._flatten(jparams), NARROW["patch_size"])
    got, want = timport.fold_bn_groups(tensors), jimport.fold_bn_groups(tensors)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert not any(".1.running_mean" in k for k in got)


def test_load_onnx_tree_equals_jax(narrow, tmp_path):
    jcfg, jparams, cfg, tparams = narrow
    tensors = _torch_layout(jweights._flatten(jparams), NARROW["patch_size"])
    path = str(tmp_path / "w.onnx")
    timport.write_onnx_tensors(path, tensors)
    want = jweights._flatten(jimport.load_onnx(path, jparams))
    # A like tree of other values: every leaf must be overwritten.
    like = tweights.tree_to(tparams, CPU, copy=True)
    for leaf in tweights.flatten(like).values():
        leaf.zero_()
    got = tweights.flatten(timport.load_onnx(path, like, device=CPU))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device == CPU and v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # map_tensors without folding and with the module. prefix dialect.
    plain = {("module." + k): v for k, v in
             _torch_layout(jweights._flatten(jparams), 16).items()
             if ".1." not in k and "conv" not in k}
    gm = timport.map_tensors(plain, tparams, strict=False, fold_bn=False,
                             device=CPU)
    jm = jimport.map_tensors(plain, jparams, strict=False, fold_bn=False)
    jflat = jweights._flatten(jm)
    for k, v in tweights.flatten(gm).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]),
                                      err_msg=k)


def test_strict_errors_read_like_jax(narrow):
    _, jparams, _, tparams = narrow
    tensors = _torch_layout(jweights._flatten(jparams), NARROW["patch_size"])
    tensors.pop("backbone.norm.bias")
    tensors["extra.thing"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError) as got:
        timport.map_tensors(tensors, tparams, device=CPU)
    with pytest.raises(ValueError) as want:
        jimport.map_tensors(tensors, jparams)
    assert str(got.value) == str(want.value)
    bad = dict(tensors, **{"backbone.norm.weight": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="converted shape"):
        timport.map_tensors(bad, tparams, strict=False, device=CPU)


def test_load_onnx_needs_a_card_unless_told_cpu(narrow, tmp_path,
                                                monkeypatch):
    _, jparams, _, tparams = narrow
    path = str(tmp_path / "w.onnx")
    timport.write_onnx_tensors(path, _torch_layout(
        jweights._flatten(jparams), NARROW["patch_size"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timport.load_onnx(path, tparams)


@pytest.fixture(scope="module")
def shipped():
    """The shipped checkpoints in both packages' trees."""
    out = {}
    for preset in ("small", "vittrack-t"):
        jcfg = JAX_PRESETS[preset]
        jp = jweights.load_npz(tweights.checkpoint_path(preset),
                               _numpy_tree(PRESETS[preset]))
        tp = tweights.load_npz(tweights.checkpoint_path(preset),
                               PRESETS[preset], device=CPU)
        out[preset] = (jcfg, jp, PRESETS[preset], tp)
    return out


@pytest.mark.parametrize("preset", ["small", "vittrack-t"])
@pytest.mark.parametrize("transform", ["standard", "cv2-5.0"])
def test_export_bytes_equal_jax(shipped, preset, transform, tmp_path):
    jcfg, jp, cfg, tp = shipped[preset]
    ours, theirs = tmp_path / "t.onnx", tmp_path / "j.onnx"
    assert texport.export_vittrack(tp, cfg, str(ours),
                                   input_transform=transform) == str(ours)
    jexport.export_vittrack(jp, jcfg, str(theirs), input_transform=transform)
    assert ours.read_bytes() == theirs.read_bytes()
    # The exported initializers read back as the port's weights.
    inits = timport.read_onnx_tensors(str(ours))
    np.testing.assert_array_equal(
        inits["pe_x_pos_" + str(_pos_index(inits))][0],
        tp["backbone"]["pos_embed_x"].numpy())
    # The compensation and the unknown transform, as in JAX.
    np.testing.assert_array_equal(texport.cv2_50_compensation(cfg),
                                  jexport.cv2_50_compensation(jcfg))
    with pytest.raises(ValueError, match="unknown input_transform"):
        texport.build_graph(tp, cfg, input_transform="bgr")


def _pos_index(inits):
    (name,) = [k for k in inits if k.startswith("pe_x_pos_")]
    return int(name.rsplit("_", 1)[1])


def test_cv2_runs_the_port_export_like_jax(shipped, tmp_path):
    cv2 = pytest.importorskip("cv2", reason="cv2 is not installed")
    jcfg, jp, cfg, tp = shipped["vittrack-t"]
    ours, theirs = str(tmp_path / "t.onnx"), str(tmp_path / "j.onnx")
    texport.export_vittrack(tp, cfg, ours, input_transform="cv2-5.0")
    jexport.export_vittrack(jp, jcfg, theirs, input_transform="cv2-5.0")

    rng = np.random.default_rng(2)
    z = rng.normal(size=(1, 3, 128, 128)).astype(np.float32)
    x = rng.normal(size=(1, 3, 256, 256)).astype(np.float32)
    maps = []
    for path in (ours, theirs):
        net = cv2.dnn.readNetFromONNX(path)
        net.setInput(z, "template")
        net.setInput(x, "search")
        maps.append(net.forward(["output1", "output2", "output3"]))
    for a, b in zip(*maps):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)

    src = SyntheticSource(640, 512, obj_size=48, seed=17, speed=3.0)
    frames = [src.frame_rgb(i) for i in range(6)]
    bb0 = tuple(int(v) for v in src.bbox_at(0))
    rects = []
    for path in (ours, theirs):
        p = cv2.TrackerVit_Params()
        p.net = path
        tr = cv2.TrackerVit_create(p)
        tr.init(frames[0], bb0)
        rects.append([(tuple(tr.update(f)[1]), tr.getTrackingScore())
                      for f in frames[1:]])
    assert rects[0] == rects[1]
