"""Generate a WGS-scale synthetic lane set for soak runs. The counterpart
of mini_parallel_tpu/tools/make_scale_data.py: the same arguments write
the same decompressed bytes.

The reference is engineered around 51.8M reads per file
(smith_waterman/src/aligner.rs:214, ~415M reads across the dataset,
main.rs:100-102). A multi-lane set of millions of reads exercises what the
small test fixtures never touch: the k-mer accumulator's staging and
spill, the chunk-checkpoint cadence at real chunk counts, and a steady
state that start-up does not dominate.

Reads are sampled from one seeded 32 Mbp synthetic genome, so k-mer content
is repetitive (realistic for the merge path), with ~0.5% substitutions,
plus 2% of each block as pure-random reads for a distinct-key tail.

Usage:
    python -m mini_parallel_tpu_torch.tools.make_scale_data OUTDIR \\
        [--lanes 8] [--reads-per-lane 1250000] [--read-len 150]

Lanes are written by worker processes, one a lane, each a gzip FASTQ named
SCALE_L00N_R1_001.fastq.gz. Only R1 files are written, so a ``.env`` that
points ``--full-wgs`` at them sets ``WGS_SAMPLE_ID=SCALE``,
``WGS_LANES=<lanes>`` and ``WGS_READS_PER_LANE=1``.
"""

from __future__ import annotations

import argparse
import gzip
import multiprocessing as mp
import os
import time

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_GENOME_MB = 32  # 32 Mbp synthetic genome shared by all lanes (seeded)
BLOCK_READS = 50_000  # reads drawn and written at a time


def _genome(seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return _BASES[rng.integers(0, 4, size=_GENOME_MB * 1_000_000, dtype=np.int64)]


def write_lane(path: str, n_reads: int, read_len: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    genome = _genome()
    qual = np.full(read_len, ord("I"), dtype=np.uint8).tobytes()
    with gzip.open(path, "wb", compresslevel=1) as fh:
        written = 0
        while written < n_reads:
            n = min(BLOCK_READS, n_reads - written)
            starts = rng.integers(0, genome.size - read_len, size=n)
            reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
            # ~0.5% substitution errors keep alignments non-trivial
            err = rng.random(reads.shape) < 0.005
            reads = np.where(err, _BASES[rng.integers(0, 4, size=reads.shape)],
                             reads)
            # 2% pure-random reads: a distinct-k-mer tail for the accumulator
            n_rand = max(1, n // 50)
            reads[:n_rand] = _BASES[rng.integers(0, 4, size=(n_rand, read_len))]
            fh.write(b"".join(b"@r%d_%d\n%s\n+\n%s\n"
                              % (seed, written + i, reads[i].tobytes(), qual)
                              for i in range(n)))
            written += n


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--reads-per-lane", type=int, default=1_250_000)
    ap.add_argument("--read-len", type=int, default=150)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.time()
    jobs = [(os.path.join(args.outdir, f"SCALE_L{lane:03d}_R1_001.fastq.gz"),
             args.reads_per_lane, args.read_len, lane)
            for lane in range(1, args.lanes + 1)]
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(args.lanes, os.cpu_count() or 4)) as pool:
        pool.starmap(write_lane, jobs)
    total = args.lanes * args.reads_per_lane
    print(f"wrote {args.lanes} lanes x {args.reads_per_lane} reads "
          f"({total} total, {args.read_len}bp) in {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
