"""The program's own spans in the traced job, as the per-layer metrics
``decode_wait_share``, ``device_wait_share``, ``chunk_host_ms``,
``genotype_remap_share`` and ``engine_init_share`` read them.

The port names its work with spans (``mini_parallel_tpu_torch/utils/
spans.py``); while a torch profiler records, each span on a thread the
profiler captures (the job's own; the FASTQ decoder's thread is not) is a
``user_annotation`` of the trace (trace.py keeps them as host events).
Here they are told from the benchmark's own annotations and torch's ops by
their names, nested by their intervals (one thread), and summed by name
with their self times: a span's duration less the part its child spans
cover. A program without spans leaves the trace without them, and then
:func:`totals` gives None.
"""

from __future__ import annotations

PREFIXES = ("align.", "fastq.", "variant.", "genotype.", "fasta.", "vcf.",
            "wgs.")
# the consumer's spans of one chunk (the program gives them its chunk id)
CHUNK_SPANS = ("align.chunk", "align.pad", "align.pack", "align.put",
               "align.launch", "variant.chunk", "variant.prep",
               "variant.step", "genotype.map", "genotype.assign",
               "genotype.orient")
_EPS = 1e-9  # s: rounding of the trace's microseconds


def is_program(name: str) -> bool:
    return name == "genotype" or name.startswith(PREFIXES)


def totals(trace) -> dict[str, dict] | None:
    """{name: {"count", "seconds", "self_seconds"}} of the program's spans
    in ``trace`` (a trace.Trace), or None without a trace or without a
    single program span in it."""
    if trace is None:
        return None
    prog = sorted(((s, d, n) for n, s, d in trace.host if is_program(n)),
                  key=lambda x: (x[0], -x[1]))
    if not prog:
        return None
    covered = [0.0] * len(prog)
    stack: list[int] = []
    for i, (s, d, _) in enumerate(prog):
        while stack and s >= prog[stack[-1]][0] + prog[stack[-1]][1] - _EPS:
            stack.pop()
        if stack:
            covered[stack[-1]] += d
        stack.append(i)
    out: dict[str, dict] = {}
    for (s, d, n), c in zip(prog, covered):
        t = out.setdefault(n, {"count": 0, "seconds": 0.0,
                               "self_seconds": 0.0})
        t["count"] += 1
        t["seconds"] += d
        t["self_seconds"] += d - c
    return out


def share(ctx, pick) -> float | None:
    """The summed duration of the spans whose name ``pick`` accepts, over
    the traced job's wall."""
    tot = totals(ctx.trace)
    if tot is None or ctx.trace.window_s <= 0:
        return None
    return (sum(t["seconds"] for n, t in tot.items() if pick(n))
            / ctx.trace.window_s)
