"""The work a kernel's roofline share counts, independent of how the
program computes it.

``OPS_PER_CELL`` counts, for one cell of a DP recurrence, the fewest
integer instructions any implementation needs, in the unit of the peak it
is read against (one lane of one instruction, DPX three-input forms
included). The linear-gap Smith-Waterman cell, H = max(0, H(i-1, j-1) +
s(i, j), H(i-1, j) + g, H(i, j-1) + g), merges four varying inputs (the
three neighbours and the substitution score) into one value; an
instruction takes at most three inputs, so it needs at least two: for
instance ``__viaddmax_s16x2_relu`` after one ``__vimax_s16x2``. With that
count against the card's highest 16-bit integer rate no implementation,
packed SIMD included, can read above 100 %.
"""

import numpy as np

OPS_PER_CELL = {
    "sw_linear": 2,
}


def self_alignment_cells(lengths) -> int:
    """Cells that reads aligned each against itself need: L^2 a read."""
    n = np.asarray(lengths, np.int64)
    return int((n * n).sum())
