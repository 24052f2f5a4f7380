"""launches_per_chunk: device operations (kernels, copies, sets) in the
trace of one whole job, over the chunks the job handed the program."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["chunks"]:
        return None
    return ctx.trace.launches() / ctx.traced["chunks"]
