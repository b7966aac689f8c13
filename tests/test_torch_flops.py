"""PyTorch port, ``utils/flops.py``: every count equals the JAX package's
exactly (pure arithmetic on the config), for every preset, frame size,
frame format and head mode; ``mfu_fields`` divides by the H100's dense
bf16 peak, and ``chip_smoke.py`` takes its peaks from this module."""

import pytest

torch = pytest.importorskip("torch")

from gstreamer_vit_tracker_tpu.app.main import PRESETS as JAX_PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu.utils import flops as jflops  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.config import PRESETS  # noqa: E402
from gstreamer_vit_tracker_tpu_torch.utils import flops  # noqa: E402

FRAMES = [(256, 320), (512, 640), (1080, 1920), (2160, 3840)]


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("fmt", ["nv12", "yuy2", "rgb"])
def test_counts_equal_jax(preset, fmt):
    cfg, jcfg = PRESETS[preset], JAX_PRESETS[preset]
    assert flops.encoder_flops(cfg) == jflops.encoder_flops(jcfg)
    for grouped in (True, False):
        assert (flops.head_flops(cfg, grouped)
                == jflops.head_flops(jcfg, grouped))
    for h, w in FRAMES:
        assert (flops.preprocess_flops(cfg, h, w, fmt)
                == jflops.preprocess_flops(jcfg, h, w, fmt))
        for grouped in (True, False):
            assert (flops.update_gflops(cfg, h, w, fmt, grouped)
                    == jflops.update_gflops(jcfg, h, w, fmt, grouped))


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown frame format"):
        flops.preprocess_flops(PRESETS["vittrack-t"], 1080, 1920, "i420")


def test_mfu_fields_use_the_h100_peak():
    f = flops.mfu_fields(6487.5, 6.168)
    assert f == {"gflop_per_frame": 6.168, "achieved_tflops": 40.01,
                 "mfu_vs_h100_bf16": 0.0405}
    jf = jflops.mfu_fields(6487.5, 6.168)
    assert {k: jf[k] for k in ("gflop_per_frame", "achieved_tflops")} == {
        k: f[k] for k in ("gflop_per_frame", "achieved_tflops")}
    g = flops.mfu_fields(1000.0, 2.0, prefix="stream_")
    assert set(g) == {"stream_gflop_per_frame", "stream_achieved_tflops",
                      "stream_mfu_vs_h100_bf16"}
    assert (flops.H100_BF16_FLOPS, flops.H100_F32_FLOPS,
            flops.H100_HBM_BYTES_S) == (989e12, 67e12, 3.35e12)


def test_chip_smoke_takes_its_peaks_from_flops():
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        text = f.read()
    assert "from gstreamer_vit_tracker_tpu_torch.utils.flops import" in text
    assert re.search(r"^H100_\w+\s*=", text, re.M) is None
