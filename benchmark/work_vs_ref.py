"""The work the seed-free rescue needs, independent of how the program
computes it (work.py's companion; its ``OPS_PER_CELL["sw_linear"]`` counts
the instructions of one of these cells).

A read that no seed anchors is aligned locally, linear gap, against the
whole joined reference on both strands: L x N cells a strand, once a read.
A program that sweeps a read twice a job does twice the work this counts.
"""


def vs_ref_cells(missed: int, read_length: int, ref_length: int) -> int:
    """Cells that ``missed`` reads of ``read_length`` need against a
    reference of ``ref_length`` bases: both strands, once each."""
    return 2 * int(missed) * int(read_length) * int(ref_length)
