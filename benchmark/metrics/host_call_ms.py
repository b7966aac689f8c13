"""Compiled entry points: the host's milliseconds from a call into the
program's step (``core.update_packed_jit``, ``SlotEngine.step_async``)
until it returns, a mean over the measured window's calls."""


def read(ctx):
    if len(ctx.calls_s) == 0:
        return None
    return 1e3 * float(sum(ctx.calls_s)) / len(ctx.calls_s)
