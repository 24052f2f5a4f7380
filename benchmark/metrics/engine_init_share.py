"""engine_init_share: the share of a variant-prep job's wall spent reading
the reference FASTA and building the engine and its seed index
(``fasta.read``, ``variant.engine_init``) in the traced job
(program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(
        ctx, lambda n: n in ("fasta.read", "variant.engine_init"))
