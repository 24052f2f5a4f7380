"""decode_wait_share: the share of a job's wall in which the program waited
for its FASTQ decoder: the ``fastq.wait`` spans (the consumer blocked on
the prefetch queue, empty) of the traced job over its wall
(program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, lambda n: n == "fastq.wait")
