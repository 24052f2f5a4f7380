"""device_idle_share: 1 minus the union of the kernel, copy and set
intervals over the traced window (one whole job)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.trace.window_s
