"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in a second:
the same files, drivers, reference and check, on a small model (D 64,
2 blocks, seeded weights), small NV12 frames and short clips, with the
band smaller than the frame so the banded crop is exercised, and at most
``streams`` streams."""

from benchmark import spec


def tiny(name: str, dtype: str = "bfloat16", streams: int = 3) -> spec.Cell:
    c = spec.cell(spec.load(), name)
    model = dict(c.config["model"], template_size=32, search_size=64,
                 patch_size=16, embed_dim=64, depth=2, num_heads=2,
                 preprocess_band=96, dtype=dtype)
    clips = dict(c.traffic["clips"], frames=6, height=120, width=160,
                 sizes=[[24, 18], [20, 26], [30, 20]], margin_px=4,
                 speed_px=2.0, sway_px=4.0)
    traffic = dict(c.traffic, clips=clips, warm_steps=2, check_steps=10 ** 6,
                   trace_steps=2,
                   streams=min(int(c.traffic["streams"]), streams))
    return c._replace(config=dict(c.config, model=model, weights="seeded"),
                      traffic=traffic)
