"""The program's spans in the traced job of every rank of a cell on
several cards, as the per-layer metrics ``merge_wait_share``,
``rank_decode_wait_share`` and ``rank_pack_ms`` read them: each rank's
trace (``Context.traces``) reduced as program_spans.py reduces one, and
summed over the ranks. A program without the spans read leaves them out of
every trace, and then each function here gives None.
"""

from __future__ import annotations

from benchmark import program_spans


def totals(ctx) -> dict[str, dict] | None:
    """{name: {"count", "seconds", "self_seconds"}} of the program's spans
    in every rank's traced job, summed over the ranks, or None where no
    rank's trace holds a program span."""
    out: dict[str, dict] = {}
    for trace in ctx.traces.values():
        for name, t in (program_spans.totals(trace) or {}).items():
            acc = out.setdefault(name, dict.fromkeys(t, 0))
            for key, value in t.items():
                acc[key] += value
    return out or None


def share(ctx, names: tuple[str, ...]) -> float | None:
    """The summed duration of the spans ``names`` in every rank's traced
    job over the sum of the ranks' traced windows; None where no rank's
    trace holds one of them."""
    tot = totals(ctx) or {}
    window = sum(t.window_s for t in ctx.traces.values())
    if not any(n in tot for n in names) or window <= 0:
        return None
    return sum(tot[n]["seconds"] for n in names if n in tot) / window
