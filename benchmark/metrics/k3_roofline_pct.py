"""Kernels: the attention kernels (kernels 3 and 4, ``csrc/attention.cu``)
of the per-block encoder in the batched tick.  Their bound for one tick's
blocks (``counts.attention_bound_s`` at the tick's batch, times the depth)
over the device time of their launches a tick in the traced slice."""

from benchmark.trace import matching

PATTERNS = (r"\battention_single_\w*kernel\b",
            r"\battention_flash_\w*kernel\b",
            r"\battention_panels_(?:mma|tf32)_kernel\b")


def read(ctx):
    if ctx.trace is None or ctx.trace_steps == 0:
        return None
    seconds, hits = matching(ctx.trace, PATTERNS)
    if hits == 0:
        return None
    bound = int(ctx.fields["depth"]) * ctx.counts.attention_bound_s(
        ctx.fields, ctx.frames_per_step)
    return 100.0 * bound / (seconds / ctx.trace_steps)
