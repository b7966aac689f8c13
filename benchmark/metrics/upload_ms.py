"""Host ingest: the device milliseconds of the host-to-device copies a
frame (each frame's planes from pinned memory) in the traced slice."""

from benchmark.trace import matching

PATTERNS = (r"^Memcpy HtoD",)


def read(ctx):
    if ctx.trace is None or ctx.trace_steps == 0:
        return None
    seconds, hits = matching(ctx.trace, PATTERNS)
    if hits == 0:
        return None
    return 1e3 * seconds / (ctx.trace_steps * ctx.frames_per_step)
