"""rescue_card_share: the share of the traced job's kernel time that the
seed-free rescue takes on the card: the device time of ``sw_vs_ref_kernel``
and of ``decode_keys``, which turns its keys into scores and ends, over the
device time of every kernel of the job. Nothing without a trace or a
kernel."""

RESCUE_KERNELS = ("sw_vs_ref_kernel", "decode_keys")


def read(ctx):
    total = ctx.trace.kernel_s() if ctx.trace else 0.0
    if total <= 0:
        return None
    return sum(ctx.trace.kernel_s(k) for k in RESCUE_KERNELS) / total
