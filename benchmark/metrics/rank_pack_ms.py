"""rank_pack_ms: the host's time packing one chunk, over every rank: the
self times of every rank's ``align.pack`` spans (the native 2-bit packer)
in the traced job, in ms, over the chunks the job handed all ranks
(rank_spans.py)."""

from benchmark import rank_spans


def read(ctx):
    tot = rank_spans.totals(ctx)
    chunks = sum(row["chunks"] for row in ctx.traced_by_rank)
    if tot is None or "align.pack" not in tot or not chunks:
        return None
    return tot["align.pack"]["self_seconds"] * 1e3 / chunks
