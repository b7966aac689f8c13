"""PyTorch port, ``scripts/train_synthetic.py`` on the CPU (``--cpu``, the
``small`` preset, a few steps):

* it writes a checkpoint that the JAX package's ``load_npz`` reads, every
  leaf equal to the port's final state; ``--save-fp16`` and ``--ema`` (with
  its ``.raw.npz``) likewise, to float16;
* its first step with ``--no-augment``, from the shipped weights, equals
  JAX's ``train_step`` on the same normalised crops (the dataset rows its
  CPU generator drew): loss rtol 1e-4, parts rtol 1e-4 / atol 1e-6,
  parameters within 3 x lr (the tolerances of ``test_torch_train.py``);
* its prints, flags and defaults are the JAX script's (``--mesh`` included);
  without ``--cpu`` and without a card it exits 1 with a message.
"""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gstreamer_vit_tracker_tpu.models import vittrack as jvittrack  # noqa: E402
from gstreamer_vit_tracker_tpu.models import weights as jweights  # noqa: E402
from gstreamer_vit_tracker_tpu.train import step as jstep  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.models import vittrack, weights  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.scripts import train_synthetic as ttrain  # noqa: E402
from scripts import train_synthetic as jtrain  # noqa: E402

BASE = ["--cpu", "--preset", "small", "--steps", "4", "--batch", "4",
        "--dataset-size", "8", "--log-every", "2"]


def _jax_load(path, tree):
    """The JAX package's ``load_npz`` into a numpy tree of ``tree``'s
    structure; returns its flat leaves as numpy."""
    like = weights.tree_to_numpy(tree)
    return {k: np.asarray(v) for k, v in
            jweights._flatten(jweights.load_npz(path, like)).items()}


def test_checkpoint_loads_in_jax_and_the_port(tmp_path, capsys):
    out = str(tmp_path / "w.npz")
    report = ttrain.run(BASE + ["--out", out])
    assert report.rc == 0 and len(report.losses) == 4
    assert np.isfinite(report.losses).all()
    text = capsys.readouterr().out
    params = report.state.params
    n = vittrack.count_params(params)
    assert n == jvittrack.count_params(weights.tree_to_numpy(params))
    assert f"preset small: {n:,} params, backend cpu" in text
    assert text.count("  loss ") == 2 and "step      4  loss" in text
    assert "samples/s)" in text and f"saved {out}" in text
    assert "dataset: 8 samples (" in text

    want = weights.flatten(weights.tree_to_numpy(params))
    got = _jax_load(out, params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = weights.flatten(weights.load_npz(out, report.cfg, device="cpu"))
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k], err_msg=k)


def test_fp16_and_ema_checkpoints(tmp_path):
    out = str(tmp_path / "w.npz")
    report = ttrain.run(BASE + ["--out", out, "--save-fp16", "--ema", "0.9"])
    assert report.rc == 0
    with np.load(out) as f:
        assert {f[k].dtype for k in f.files} == {np.dtype(np.float16)}
    for path, tree in ((out, report.state.ema_params),
                       (out + ".raw.npz", report.state.params)):
        want = weights.flatten(weights.tree_to_numpy(tree))
        got = _jax_load(path, tree)
        for k in want:
            np.testing.assert_array_equal(
                got[k], want[k].astype(np.float16).astype(np.float32),
                err_msg=k)
    ema = weights.flatten(report.state.ema_params)
    raw = weights.flatten(report.state.params)
    assert any(not torch.equal(ema[k], raw[k]) for k in raw)


def test_first_no_augment_step_equals_jax_train_step(tmp_path):
    lr, seed, batch = 1e-3, 3, 4
    report = ttrain.run([
        "--cpu", "--preset", "small", "--steps", "1", "--batch", str(batch),
        "--dataset-size", "8", "--log-every", "1", "--no-augment",
        "--lr", str(lr), "--seed", str(seed), "--init-from",
        weights.checkpoint_path("small"), "--out", str(tmp_path / "w.npz")])
    assert report.rc == 0
    # The rows the script's CPU generator (seed + 1) drew, normalised as
    # train_scan does without augmentation.
    idx = torch.randint(0, 8, (batch,),
                        generator=torch.Generator().manual_seed(seed + 1))
    cfg = report.cfg
    mean = np.asarray(cfg.norm_mean, np.float32)
    std = np.asarray(cfg.norm_std, np.float32)
    z, x, gt = (a[idx.numpy()] for a in report.dataset)
    z = (z.astype(np.float32) / np.float32(255.0) - mean) / std
    x = (x.astype(np.float32) / np.float32(255.0) - mean) / std

    jcfg = dataclasses.replace(jtrain.PRESETS["small"], dtype="float32")
    start = weights.load_npz(weights.checkpoint_path("small"), cfg,
                             device="cpu")
    jparams = jweights.load_npz(weights.checkpoint_path("small"),
                                weights.tree_to_numpy(start))
    jopt = jstep.make_optimizer(lr, total_steps=1, warmup_steps=0,
                                clip_norm=1.0)
    jst = jstep.create_train_state(jparams, opt=jopt)
    jst, jloss, jparts = jstep.train_step(
        jst, jnp.asarray(z), jnp.asarray(x), jnp.asarray(gt), jcfg,
        use_pallas=False, opt=jopt)
    np.testing.assert_allclose(report.losses[0], float(jloss), rtol=1e-4)
    jp = jweights._flatten(jst.params)
    tp = weights.flatten(weights.tree_to_numpy(report.state.params))
    moved = 0
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=0,
                                   atol=3 * lr, err_msg=k)
        moved += not np.array_equal(tp[k], weights.tree_to_numpy(
            weights.flatten(start)[k]))
    assert moved == len(jp)
    assert set(jparts) == {"focal", "l1_offset", "l1_size", "giou"}


def test_no_card_without_cpu_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttrain.main(BASE[1:]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--cpu" in err


def _jax_parser(monkeypatch):
    """The JAX script's parser: its ``main`` builds one and parses; stop it
    there."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["ap"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jtrain.main([])
    monkeypatch.undo()
    return seen["ap"]


def test_flags_and_defaults_equal_jax_less_mesh(monkeypatch):
    # Since the port of parallel/ the port has --mesh too: every flag and
    # default equals JAX's, --mesh included.
    def table(ap):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       tuple(a.choices) if a.choices else None, a.type,
                       a.nargs, a.const) for a in ap._actions)

    jap = _jax_parser(monkeypatch)
    assert "mesh" in {a.dest for a in jap._actions}
    tap = ttrain.build_argparser()
    assert "mesh" in {a.dest for a in tap._actions}
    assert table(tap) == table(jap)
    assert sorted(ttrain.PRESETS) == sorted(jtrain.PRESETS)
    for name, cfg in ttrain.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jtrain.PRESETS[name])


def test_training_runs_the_compiled_scan_and_equals_the_eager_one(
        tmp_path, monkeypatch):
    # One process trains through the compiled train_scan: one capture for
    # the run, the refreshed dataset (--refresh-every) copied into it, the
    # losses and the checkpoint bit-equal to the eager scan's.
    from gstreamer_vit_tracker_tpu_torch.train import step as tstep

    # Its own --lr: a static value no other test's capture holds (the
    # wrapper's captures live as long as the process).
    argv = BASE + ["--lr", "2e-3", "--refresh-every", "2",
                   "--out", str(tmp_path / "c.npz")]
    traces = tstep._scan_step.traces
    compiled = ttrain.run(argv)
    assert tstep._scan_step.traces == traces + 1
    monkeypatch.setattr(ttrain, "train_scan", tstep.train_scan_eager)
    eager = ttrain.run(argv[:-1] + [str(tmp_path / "e.npz")])
    assert compiled.rc == eager.rc == 0
    assert compiled.losses == eager.losses and len(compiled.losses) == 4
    with np.load(tmp_path / "c.npz") as c, np.load(tmp_path / "e.npz") as e:
        assert sorted(c.files) == sorted(e.files)
        for k in c.files:
            np.testing.assert_array_equal(c[k], e[k], err_msg=k)
