"""genotype_ratio: the share of a variant-prep job's wall spent in
``genotype_candidates``, by the benchmark's own host-clock spans around the
call, over the untraced jobs of the traced run."""


def read(ctx):
    spans = [j["spans"].get("genotype_candidates") for j in ctx.jobs]
    if not spans or any(s is None for s in spans):
        return None
    return sum(spans) / sum(j["wall"] for j in ctx.jobs)
