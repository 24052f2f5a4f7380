"""merge_wait_share: the share of the ranks' time in which they waited on
one another: every rank's ``wgs.dist.sizes`` (the all-gather of the file
sizes, where a rank waits for the last to start) and ``wgs.dist.merge``
(the all-gathers of the totals, where it waits for the slowest to finish)
in the traced job, over the sum of the ranks' traced windows
(rank_spans.py)."""

from benchmark import rank_spans


def read(ctx):
    return rank_spans.share(ctx, ("wgs.dist.sizes", "wgs.dist.merge"))
