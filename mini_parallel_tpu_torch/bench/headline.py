"""Headline benchmark: batched Smith-Waterman on the card. The counterpart
of the JAX package's root ``bench.py``.

    python -m mini_parallel_tpu_torch.bench.headline [--reads 10000]
        [--device cuda|cpu] [--out FILE]

BASELINE.json config 2, "Batched SW: 10k reads x 150bp": 10,000 seeded
pairs of 150 bp padded to 152, made as ``bench.py`` makes them, scored by
the port's main-path scorer ``ops/sw_cuda.py:sw_score_batch_best`` (the
kernel ``csrc/sw_score.cu`` on the card). Prints one JSON line with
``bench.py``'s keys:

- ``value``: GCUPS over the reads x 150 x 150 cells the data needs;
- ``vs_baseline``: 200 ms / the batch's ms (the reference's only stated
  target, sub-200 ms a chunk);
- ``extra``: ``batch_latency_ms`` (median of 5 CUDA-event runs of 20
  back-to-back launches after a warm-up), its min and max,
  ``reads_per_s``, and the scores' sum and maximum;

and beside them ``bound_ms`` (the larger of cells x 6 instructions over
the card's 16.73 T int32 instructions/s and the bytes over 3.35 TB/s,
``tools/roofline.py``), ``bound_share`` (bound / measured; null on the
CPU), the card fields and ``correct``: the timed call's scores equal the
plain version (``ops/sw.py:sw_score_batch``) on the first 256 pairs, and
on the card the kernel launched.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mini_parallel_tpu_torch.bench._common import (
    REFERENCE_TARGET_MS,
    Emitter,
    Watchdog,
    add_common_flags,
    bench_device,
    card_fields,
    card_times,
    launch_counts,
    launched_since,
    run,
)
from mini_parallel_tpu_torch.ops import encode, sw
from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_best
from mini_parallel_tpu_torch.tools.roofline import (
    HBM_BYTES_PER_S,
    INT32_OPS_PER_S,
    OPS_PER_CELL,
)

METRIC = "batched_sw_10k_reads_150bp"
READS = 10_000
READ_LEN = 150
PAD = 152  # 150 bp rounded up to a multiple of 8, as bench.py pads
LAUNCHES = 20
CHECK_PAIRS = 256


def make_batch(reads: int = READS) -> tuple[np.ndarray, np.ndarray]:
    """(reads, PAD) uint8 operands, PAD_A- and PAD_B-padded, from
    ``np.random.default_rng(0)`` exactly as bench.py draws them."""
    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    reads_a = rng.choice(base, size=(reads, READ_LEN)).astype(np.uint8)
    reads_b = rng.choice(base, size=(reads, READ_LEN)).astype(np.uint8)
    arr_a = np.full((reads, PAD), encode.PAD_A, np.uint8)
    arr_b = np.full((reads, PAD), encode.PAD_B, np.uint8)
    arr_a[:, :READ_LEN] = reads_a
    arr_b[:, :READ_LEN] = reads_b
    return arr_a, arr_b


def bound_ms(reads: int) -> tuple[float, str]:
    """The least time the card could take: (ms, "operations" or "bytes")."""
    ops_ms = (reads * READ_LEN * READ_LEN * OPS_PER_CELL["sw_score"]
              / INT32_OPS_PER_S * 1e3)
    bytes_ms = (2 * reads * PAD + 4 * reads) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mini_parallel_tpu_torch.bench.headline",
        description="Batched SW on BASELINE config 2: one JSON line.")
    ap.add_argument("--reads", type=int, default=READS)
    add_common_flags(ap)
    args = ap.parse_args(argv)
    watchdog = Watchdog(METRIC, "GCUPS")
    device = bench_device(args)
    card = watchdog.card = card_fields(device)
    a, b = (torch.from_numpy(x).to(device) for x in make_batch(args.reads))

    before = launch_counts()
    scores = sw_score_batch_best(a, b)
    n = min(CHECK_PAIRS, args.reads)
    correct = bool(torch.equal(scores[:n], sw.sw_score_batch(a[:n], b[:n])))
    if device.type == "cuda":
        correct &= launched_since(before).get("sw_score", 0) == 1
    t = card_times(lambda: sw_score_batch_best(a, b), device,
                   launches=LAUNCHES if device.type == "cuda" else 1)
    watchdog.cancel()

    cells = args.reads * READ_LEN * READ_LEN
    bound, bound_by = bound_ms(args.reads)
    emitter = Emitter(card, args.out)
    emitter.emit({
        "metric": METRIC,
        "value": cells / t["ms"] / 1e6,
        "unit": "GCUPS",
        "vs_baseline": REFERENCE_TARGET_MS / t["ms"],
        "extra": {
            "batch_latency_ms": t["ms"],
            "min_ms": t["min_ms"], "max_ms": t["max_ms"],
            "reads_per_s": args.reads / t["ms"] * 1e3,
            "device": card["name"],
            "reads": args.reads, "read_len": READ_LEN, "pad": PAD,
            "samples": t["samples"], "launches_per_sample": t["launches"],
            "timer": t["timer"], "checked_pairs": n,
            "score_sum": int(scores.sum()), "score_max": int(scores.max()),
            "scorer": ("csrc/sw_score.cu" if device.type == "cuda"
                       else "ops/sw.py:sw_score_batch (plain)"),
        },
        "bound_ms": bound,
        "bound_by": bound_by,
        "bound_share": bound / t["ms"] if device.type == "cuda" else None,
        "correct": correct,
    })
    return emitter.finish()


if __name__ == "__main__":
    sys.exit(run(main, "bench.headline"))
