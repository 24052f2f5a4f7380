"""device_wait_share: the share of a job's wall in which the host waited
for the device: every program span named ``*.sync`` (a blocking read of a
device result) of the traced job over its wall (program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, lambda n: n.endswith(".sync"))
