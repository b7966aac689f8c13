"""Model step: the model operations of every frame tracked in the measured
window (``counts.frame_flops``: patch embed, every block, the three head
towers), over the window's seconds, as a share of the card's bf16 peak."""


def read(ctx):
    if ctx.frames <= 0 or ctx.window_s <= 0.0:
        return None
    rate = ctx.frames * ctx.counts.frame_flops(ctx.fields) / ctx.window_s
    return 100.0 * rate / ctx.counts.PEAK_BF16_FLOPS
