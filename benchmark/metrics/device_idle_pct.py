"""Device layer: the share of the measured window in which no kernel, copy
or fill ran on the card.  The device time a step takes comes from the
traced slice (``torch.profiler``, CUPTI: the union of the device
operations over its steps); the window's steps and seconds from the
untraced window, whose host the profiler does not slow.  Nothing to read
where the traced steps' device time exceeds the window's time a step."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or ctx.window_s <= 0.0 or ctx.frames <= 0:
        return None
    busy_step = tr.busy_s / ctx.trace_steps
    steps = ctx.frames / ctx.frames_per_step
    busy = busy_step * steps / ctx.window_s
    return 100.0 * (1.0 - busy) if busy <= 1.0 else None
