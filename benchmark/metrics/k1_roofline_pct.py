"""Kernels: the whole-encoder kernel (kernel 1, ``csrc/vit_encoder.cu``
with ``encoder_mma.cuh`` / ``encoder_tf32.cuh`` / ``ring_tf32.cuh``) on the
unbatched step.  Its bound for one frame's blocks (``counts.
encoder_bound_s`` at batch 1) over the device time of its launches a
frame in the traced slice."""

from benchmark.trace import matching

# The device functions of the encoder's sources (names searched in the
# trace's kernel names; none is a name of csrc/attention.cu's).
PATTERNS = (r"\bproduct_kernel\b", r"\bring_product_kernel\b",
            r"\bln_rows_kernel\b", r"\brow_stats_kernel\b",
            r"\battention_kernel\b", r"\battention_panels_kernel\b",
            r"\blayer_norm_kernel\b", r"\bgemm_bias_kernel\b",
            r"\battention_simt_kernel\b")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, hits = matching(ctx.trace, PATTERNS)
    frames = ctx.trace_steps * ctx.frames_per_step
    if hits == 0 or frames == 0:
        return None
    bound = ctx.counts.encoder_bound_s(ctx.fields, 1)
    return 100.0 * bound / (seconds / frames)
