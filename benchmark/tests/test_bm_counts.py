"""``counts.py`` against a count by hand and against the port's own
``utils/flops.py`` (the embed, blocks and three-tower head)."""

import pytest

from benchmark import counts, spec
from benchmark.harness import model_config

FIELDS = {n: spec.cell(spec.load(), n).config["model"]
          for n in ("vittrack-t.live-1080p", "ostrack-256.serve-16")}


def test_flagship_by_hand():
    f = FIELDS["vittrack-t.live-1080p"]
    n, d, h = 64 + 256, 192, 768
    block = 2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d + 4 * n * d * h
    head = 3 * 2 * 256 * 9 * (192 * 96 + 96 * 48 + 48 * 24) + 2 * 256 * 24 * 5
    assert counts.block_flops(f) == block
    assert counts.head_flops(f) == head
    assert counts.frame_flops(f) == 2 * 256 * 768 * 192 + 12 * block + head


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_equals_port(name):
    from gstreamer_vit_tracker_tpu_torch.utils import flops

    f = FIELDS[name]
    cfg = model_config(f)
    assert (counts.embed_flops(f) + f["depth"] * counts.block_flops(f)
            == flops.encoder_flops(cfg))
    assert counts.head_flops(f) == flops.head_flops(cfg, grouped=False)


def test_bounds():
    f = FIELDS["vittrack-t.live-1080p"]
    # Kernel 1 at the flagship: 4.341 GFLOP of blocks at 989 TFLOP/s.
    assert counts.encoder_bound_s(f, 1) == pytest.approx(4.39e-6, rel=1e-2)
    # Kernel 3 at (48, 320, 64) bf16: 7.86 MB at 3.35 TB/s.
    assert counts.attention_bound_s(f, 16) == pytest.approx(2.35e-6,
                                                            rel=1e-2)
