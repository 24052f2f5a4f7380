"""rank_decode_wait_share: the share of the ranks' time in which they
waited for their FASTQ decoders: every rank's ``fastq.wait`` spans (its
consumer blocked on the empty prefetch queue) in the traced job, over the
sum of the ranks' traced windows (rank_spans.py). ``decode_wait_share``
reads rank 0's alone."""

from benchmark import rank_spans


def read(ctx):
    return rank_spans.share(ctx, ("fastq.wait",))
