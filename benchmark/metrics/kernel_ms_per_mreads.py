"""kernel_ms_per_mreads: the trace's summed device time of every kernel of
one whole job (the port's and torch's own), in ms per million reads."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["reads"]:
        return None
    return ctx.trace.kernel_s() * 1e3 / (ctx.traced["reads"] / 1e6)
