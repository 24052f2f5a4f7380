"""sw_score_roofline: the linear-gap Smith-Waterman kernel's share of its
roofline, in %. The least time the card could take for the cells the
traced job's reads need (each read against itself, L^2 cells), at the
fewest instructions a cell needs (work.py), at the card's highest 16-bit
integer rate (card.py, peaks.json), over the trace's device time of
``sw_score_kernel``. Nothing when the card is not in the table of peaks or
the kernel did not run."""

from benchmark import card, work


def read(ctx):
    seconds = ctx.trace.kernel_s("sw_score_kernel") if ctx.trace else 0.0
    if ctx.card is None or ctx.cells is None or seconds <= 0:
        return None
    least = (ctx.cells * work.OPS_PER_CELL["sw_linear"]
             / card.int16x2_ops_per_s(ctx.card))
    return 100.0 * least / seconds
