"""chunk_host_ms: the host's own time on one chunk of the device step:
the self times of the consumer's per-chunk spans (pad, pack, put, launch,
the mapping pass's steps; program_spans.CHUNK_SPANS, which leave out the
waits on the decoder and on the device) in the traced job, in ms, over
the chunks the job handed the program."""

from benchmark import program_spans


def read(ctx):
    tot = program_spans.totals(ctx.trace)
    if tot is None or not ctx.traced.get("chunks"):
        return None
    own = sum(tot[n]["self_seconds"] for n in program_spans.CHUNK_SPANS
              if n in tot)
    return own * 1e3 / ctx.traced["chunks"]
