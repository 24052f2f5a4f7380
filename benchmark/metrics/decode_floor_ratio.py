"""decode_floor_ratio: how near a job runs to its FASTQ decoder. The
seconds ``fastq.iter_flat_chunks_multi`` takes to drain the job's own lane
files alone, after the window, over the median wall of the untraced jobs
of the traced run."""

import statistics


def read(ctx):
    if ctx.decode_s is None or not ctx.jobs:
        return None
    return ctx.decode_s / statistics.median(j["wall"] for j in ctx.jobs)
