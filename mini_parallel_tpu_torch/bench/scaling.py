"""Scaling benchmark: reads/s of the sharded WGS step at increasing mesh
sizes, and the long pair's row-band geometry. The counterpart of the JAX
package's root ``bench_scaling.py``.

    python -m mini_parallel_tpu_torch.bench.scaling [--reads 65536]
        [--len 150] [--sizes 1,2,4,8] [--cpu] [--out FILE]

``parallel/pipeline.py:make_wgs_step`` over meshes of 1, 2, 4 and 8 shards
(``parallel/mesh.py:make_mesh``): on one card ``[cuda:0] x k`` (the local
cards in turn where there are more), with ``--cpu`` ``[cpu] x k``. The
batch is ``--reads`` seeded pairs of ``--len`` bases
(``np.random.default_rng(0)``, as bench_scaling.py draws it), cut to
a multiple of the largest size so every size sees the same rows, and put on
the device before the clock starts. Each size's statistics are compared
key by key with the one-shard run (``stats_bit_exact_vs_local``); each gets
reads/s (median of 5 card-timer runs of 5 steps, min and max) and
``scaling_efficiency``. ``performance_representative`` is true only when
every size's shards are distinct cards: shards of one card share it.

The JAX script's ``long_pair_pipeline_model`` rows describe the TPU's
skewed halo wavefront, which the port does not have. In their place,
``long_pair_row_bands`` rows describe the port's row bands
(``ops/sw_long.py:sweep_plan``, the geometry its host loop allocates): for
an M x N pair in C bands, the bands' rows, the strips and the strips per
group, the stages in diagonal order, and the bytes a band hands the next
across each boundary (the H row with its corner, plus the E row affine).
"""

from __future__ import annotations

import argparse
import hashlib
import sys

import numpy as np
import torch

from mini_parallel_tpu_torch.bench._common import (
    Emitter,
    Watchdog,
    add_common_flags,
    bench_device,
    card_fields,
    card_times,
    run,
)
from mini_parallel_tpu_torch.ops import encode, sw_long
from mini_parallel_tpu_torch.parallel import mesh as mesh_mod
from mini_parallel_tpu_torch.parallel import pipeline

SIZES = (1, 2, 4, 8)
CPU_SHARDS = 8
STEPS = 5  # steps between the card timer's events
BAND_PAIRS = (500_000, 2_000_000)  # M = N, the JAX script's b lengths
BAND_COUNTS = (1, 2, 4, 8)


def make_batch(reads: int, read_len: int):
    """(arr_a, arr_b, lens): bench_scaling.py's seeded batch, padded to a
    multiple of 8."""
    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    pad = -(-read_len // 8) * 8
    arr_a = np.full((reads, pad), encode.PAD_A, np.uint8)
    arr_b = np.full((reads, pad), encode.PAD_B, np.uint8)
    arr_a[:, :read_len] = rng.choice(base, size=(reads, read_len))
    arr_b[:, :read_len] = rng.choice(base, size=(reads, read_len))
    lens = np.full(reads, read_len, np.int32)
    return arr_a, arr_b, lens


def stats_numpy(stats: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in stats.items()}


def stats_summary(stats: dict) -> dict:
    """Each statistic as printed: a scalar as its int, a histogram as the
    SHA-256 of its int32 bytes."""
    return {k: int(v) if v.ndim == 0 else
            hashlib.sha256(v.astype(np.int32).tobytes()).hexdigest()
            for k, v in sorted(stats.items())}


def shard_devices(device: torch.device, size: int) -> list[torch.device]:
    """``size`` shards: the local cards in turn from ``device``'s (one card
    gives ``[cuda:0] x size``), or ``[cpu] x size``."""
    if device.type == "cpu":
        return [device] * size
    n = torch.cuda.device_count()
    return [torch.device("cuda", (device.index + i) % n) for i in range(size)]


def scaling_row(device: torch.device, reads: int, read_len: int,
                sizes: list[int]) -> dict:
    """The ``wgs_step_scaling`` row."""
    B = (reads // max(sizes)) * max(sizes)
    arr_a, arr_b, lens = make_batch(reads, read_len)
    operands = tuple(torch.from_numpy(x[:B]).to(device)
                     for x in (arr_a, arr_b, lens, lens))
    local, rows = None, []
    for size in sizes:
        devices = shard_devices(device, size)
        mesh = mesh_mod.make_mesh((size,), ("data",), devices=devices)
        step = pipeline.make_wgs_step(mesh)
        stats = stats_numpy(step(*operands))
        if local is None:
            local = stats
        exact = stats.keys() == local.keys() and all(
            np.array_equal(stats[k], local[k]) for k in local)
        t = card_times(lambda: step(*operands), device,
                       launches=STEPS if device.type == "cuda" else 1)
        rows.append({"devices": size, "reads_per_s": B / t["ms"] * 1e3,
                     "batch_ms": t["ms"], "min_ms": t["min_ms"],
                     "max_ms": t["max_ms"], "samples": t["samples"],
                     "steps_per_sample": t["launches"],
                     "distinct_devices": len(set(devices)),
                     "stats_bit_exact_vs_local": exact})
    base = rows[0]["reads_per_s"]
    for r in rows:
        r["scaling_efficiency"] = r["reads_per_s"] / (base * r["devices"])
    return {"metric": "wgs_step_scaling",
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "performance_representative": device.type == "cuda" and all(
                r["distinct_devices"] == r["devices"] for r in rows),
            "reads": B, "read_len": read_len,
            "checked_stats": sorted(local), "local_stats": stats_summary(local),
            "timer": t["timer"],
            "rows": rows,
            "correct": all(r["stats_bit_exact_vs_local"] for r in rows)}


def band_geometry(M: int, N: int, bands: int, affine: bool,
                  strip_width: int = sw_long.DEFAULT_STRIP_WIDTH,
                  strips_per_group: int | None = None) -> dict:
    """One band count's geometry of an M x N pair, from the plan the host
    loop runs (``sw_long.sweep_plan``)."""
    plan = sw_long.sweep_plan(M, N, bands, strip_width, affine,
                              strips_per_group)
    K, C = len(plan.groups), len(plan.bounds)
    per_boundary = sum(sw_long.band_handoff_bytes(plan.group_cols(g), affine)
                       for g in range(K))
    return {"band_rows": [r1 - r0 for r0, r1 in plan.bounds],
            "strip_width": plan.width, "strips": plan.n_strips,
            "strips_per_group": plan.strips_per_group, "groups": K,
            "stages": plan.stages, "pipeline_utilization": K / plan.stages,
            "handoff_bytes_per_boundary": per_boundary if C > 1 else 0,
            "handoff_bytes_total": per_boundary * (C - 1)}


def band_row(M: int, N: int) -> dict:
    """The ``long_pair_row_bands`` row of an M x N pair."""
    rows = []
    for C in BAND_COUNTS:
        rows.append({"bands": C,
                     "linear": band_geometry(M, N, C, False),
                     "affine": band_geometry(M, N, C, True)})
    ok = all(sum(r[g]["band_rows"]) == M
             and r[g]["stages"] == r[g]["groups"] + r["bands"] - 1
             for r in rows for g in ("linear", "affine"))
    return {"metric": "long_pair_row_bands", "a_len": M, "b_len": N,
            "rows": rows, "correct": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mini_parallel_tpu_torch.bench.scaling",
        description="reads/s of the sharded WGS step per mesh size.")
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--len", type=int, default=150, dest="read_len")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="comma-separated shard counts")
    add_common_flags(ap, cpu_flag=True)
    args = ap.parse_args(argv)
    sizes = sorted(int(s) for s in args.sizes.split(","))
    watchdog = Watchdog("wgs_step_scaling", "reads_per_s")
    device = bench_device(args)
    if device.type == "cpu" and max(sizes) > CPU_SHARDS:
        ap.error(f"--cpu gives {CPU_SHARDS} shards")
    emitter = Emitter(card_fields(device), args.out)
    watchdog.card = emitter.card
    emitter.emit(scaling_row(device, args.reads, args.read_len, sizes))
    watchdog.cancel()
    for n in BAND_PAIRS:
        emitter.emit(band_row(n, n))
    return emitter.finish()


if __name__ == "__main__":
    sys.exit(run(main, "bench.scaling", "--cpu"))
