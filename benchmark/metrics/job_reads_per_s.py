"""job_reads_per_s: whole jobs' reads per second by the host's clock, read
where the host's load spreads that rate too widely to stand as the cell's
end-to-end metric: all reads of the untraced jobs of the traced run over
their summed walls."""


def read(ctx):
    if not ctx.jobs or any("reads" not in j for j in ctx.jobs):
        return None
    return sum(j["reads"] for j in ctx.jobs) / sum(j["wall"] for j in ctx.jobs)
