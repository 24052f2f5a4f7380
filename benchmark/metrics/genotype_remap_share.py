"""genotype_remap_share: the share of a variant-prep job's wall in the
genotyper's second pass over the reads (``genotype.remap``: map, read
back, assign to sites, orient) in the traced job (program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, lambda n: n == "genotype.remap")
