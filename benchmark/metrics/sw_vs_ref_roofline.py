"""sw_vs_ref_roofline: the seed-free rescue kernel's share of its roofline,
in %. The least time the card could take for the cells the traced job's
reads need (each read that the plain seed mapper leaves unmapped, against
the whole joined reference, both strands, once: work_vs_ref.py) at the
fewest instructions a linear-gap cell needs (work.py) at the card's highest
16-bit integer rate (card.py, peaks.json), over the trace's device time of
``sw_vs_ref_kernel``. A program that sweeps each such read twice a job
reads at most 50 %. Nothing when the card is not in the table of peaks or
the kernel did not run."""

from benchmark import card, work


def read(ctx):
    seconds = ctx.trace.kernel_s("sw_vs_ref_kernel") if ctx.trace else 0.0
    if ctx.card is None or ctx.cells is None or seconds <= 0:
        return None
    least = (ctx.cells * work.OPS_PER_CELL["sw_linear"]
             / card.int16x2_ops_per_s(ctx.card))
    return 100.0 * least / seconds
