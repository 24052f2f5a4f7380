#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's entry points once on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions; build
   the eight kernel sources of mini_parallel_tpu_torch/csrc (one nvcc each)
   and the three host libraries of mini_parallel_tpu_torch/native (one g++
   each: the FASTQ decoder, the 2-bit packer, the k-mer store), all started
   together, and report their build seconds, where they went and ptxas's
   register counts. Every read path below (phases 4, 8, 13, 14, 18, 19)
   prints the FASTQ engine its "auto" resolved to, and must be native.
2. SW kernel vs plain PyTorch version on the card, exact integer equality:
   the main path's shape (10,000 seeded pairs x 150 bp, padded to 152),
   ragged geometries (M != N, B not a multiple of the block, empty rows,
   identical strings, N bases, multi-stripe rows, one 2048 x 2048 pair),
   and 16 pairs against the NumPy golden.
3. Times of kernel and plain version at 10,000 x 152 (CUDA events, warm-up,
   median of 14), as ms and GCUPS over 10,000 x 150 x 150 cells.
4. Main path: seeded FASTQ.gz fixtures (4 files x 100,000 reads, ~0.1% N,
   one file ragged), ``cli.main(["--full-wgs", "--mode", "sw", ...])`` and
   the same in kadane mode, then sw again, which must resume from its
   checkpoint and skip every file. The sw total must be 2 x bases, the
   kadane total 2 x the chunks of >= 1000 bases, no chunk may fail, and the
   kernel must have launched once per sw chunk.
5. Affine kernel vs plain ``sw_affine_batch``, exactly: phase 2's cases,
   (0, -2) against the linear kernel, custom gap costs, 16 pairs against
   ``sw_affine_numpy``.
6. Long-pair strip kernel vs the plain per-strip functions, linear and
   affine: one strip with carried columns (a group of one); the
   strip-group kernel vs the plain group with more strips than the card
   holds blocks (a second wave of tickets), M not a multiple of the row
   chunk, M below one chunk, a ragged last strip, strips of 4 warps;
   20,000 x 15,000 host loops at two strip widths, 3,000 x 5,000 against
   the blocked goldens (a segment and a gap across a strip edge), an
   identical 100,000-base pair (2n), empty sides.
7. Times: the affine kernel and its plain version at 10,000 x 152; the
   long kernel at 200,000 x 150,000 (with the group geometry), one strip
   of it alone (one warp's step latency) and, with its plain host loop,
   at 20,000 x 15,000; the batched kernel at B = 1 against the long
   kernel at 2048^2 and 8192^2.
8. This slice's entry points through ``cli.main``: --full-wgs in sw-affine
   (total 2 x bases, one affine launch per chunk) and contiguous; --files
   in all four modes (sw and sw-affine equal to the plain version over the
   same mates); --complementarity on 100,000 mates with exactly 10% broken
   (10.00 %); --long-align at 200,000 x 150,000 with a 50,000-base shared
   segment, sw and sw-affine, each equal to a direct call at a narrower
   strip width and to the plain per-strip host loop at the same size, and
   the pair's first two 200,000 x 8192 strips (strip 1 with strip 0's
   carried columns) kernel == plain on the best score and the carried
   columns, and the same columns as one group of default-width strips.
   Kernel counts are zeroed before each path and read after.
9. Variant-prep fixtures: a seeded 2-contig reference (4,641,652 bases,
   the length of E. coli K-12 MG1655, and a 100 kb plasmid), a donor with
   4,000 SNPs and 400 + 400 1-10-base deletions and insertions, and lanes
   of 150 bp reads (half reverse-complemented, 0.2% substitutions, 5% Q2
   quality bytes, 1% rescue targets whose eight probed seeds are all
   killed): two of 465,000 reads (~30x), one of 100,000 and one of 4,000.
10. The vs-reference kernel (csrc/sw_vs_ref.cu) == plain sw_vs_ref_batch,
    exactly: 256 reads x 20,000 bases with a repeat and all-pad rows, rows
    past one stripe; the segment split at 16-48-column segments and the
    default (a tie across segments, a gapped copy across a segment edge,
    all-pad and all-N reads, M = 300), also == the plain segment mirror;
    8 rescue targets against the whole reference (also
    == the strip engine, anchors == their planted starts), and a real
    --rescue chunk against the whole reference.
11. The traceback kernels (csrc/sw_moves.cu, linear and affine) == the
    plain scans and walks, exactly, on best, bd, bi, positions and every
    cell's move: a real --gapped chunk (10,000 x 152 vs 184, every pair's
    moves in shared memory), a ragged batch whose last block has one pair,
    a batch of one, and the device-memory cases: rows past one stripe and
    1,500-base windows. The pileup kernel (csrc/pileup.cu) == the plain
    torch route on the --gapped chunk's affine positions (10,000 x 152),
    without a quality mask and with its --min-base-quality 10 mask: every
    count, the trash slot 0, one launch a call.
12. Times (CUDA events, medians; each plain version once): the vs-ref
    kernel on the --rescue chunk and on 1,000 reads against the whole
    reference, the traceback kernels on the --gapped chunk, the pileup
    kernel, the plain route and its index_add_ alone on it (with the bytes
    its bound counts). Batched CIGAR
    alignment (``sw_align_batch``, ``sw_affine_align_batch``: the moves
    kernel with its moves out, a host walk of its moves words) on the
    --gapped chunk's 10,000 pairs at 152 x 184 and 64 pairs at 300 x 700
    (moves in device memory): one launch a call, every Alignment == the
    plain CPU route's, and == the golden on a sample; the kernel's ms with
    and without return_moves, the words' host copy, the host walk, and the
    card memory the call takes.
13. ``cli.main(["--variant-prep", ...])`` on the two lanes ungapped,
    --gapped and --gapped --gap-model affine (reads/s, mapping rate, SNP
    recall >= 95%, indel recall printed); --rescue --sam-out on the
    100,000-read lane (one record per read, >= 90% of the targets mapped);
    --min-base-quality 10 (no depth above the unmasked run's); a
    checkpoint resumed through the CLI to the clean run's pileup; the
    4,000-read lane on the card == on the CPU (pileup, candidates, SAM
    bytes), linear and affine. Kernel counts as in phase 8; the pileup
    kernel launches once a chunk on every path.
14. ``cli.main(["--variant-prep", ..., "--gapped", "--gap-model",
    "affine", "--genotype", ...])`` on the two lanes at the defaults: lanes
    scored and recomputed in float64, the Pair-HMM launches (one in each
    precision), the genotyping wall and sites/s, planted SNPs called 1/1
    (>= 95%), and, printed only, planted deletions with a 1/1 <DEL> within
    10 bases and insertions called with their planted bases.
15. The Pair-HMM kernel (csrc/pairhmm.cu) vs plain pairhmm_batch, float32
    and float64, every lane equal (max |dlog10| 0, the same -inf lanes):
    20,000 lanes of phase 14's operand, the whole operand (float32) and all
    its float32-underflowed lanes (float64), neighbouring lanes of very
    different lengths with la = 0 and lb = 0 lanes among them, a batch of
    one, ragged lanes (odd B), two stripes (M = 170) and rows past 256,
    haplotypes longer and shorter than their reads, an all-mismatch lane
    and lanes straddling the float32 floor. Times on the sample (plain
    once) and on the whole operand.
16. The roofline chain (csrc/roofline.cu) == the plain chain exactly on the
    (2048, 512) tile at CHAIN 2048; ``tools.roofline.main()``: the measured
    int32 peak beside the estimate, and sw_score's share of both.
17. Each kernel's share of its bound (int32 kernels: also of the measured
    chain instruction rate).
18. The native host data plane: the three g++ builds; the native FASTQ
    decoder == the Python engine on phase 4's four files and phase 9's two
    465,000-read lanes in the flat and the quality streams (and the list
    streams on phase 4's files); the native packer == the NumPy packer on
    a phase-4 chunk; decode-only seconds and reads/s per engine and
    pack-only ms per packer, interleaved (A, B, A, B..., medians of 3);
    then --full-wgs (sw, kadane) and --variant-prep --gapped reads/s on
    the default (native) plane and on the Python plane.
19. ``--kmer`` on the card: phase 9's two lanes (930,000 reads, k = 21) in
    summary mode and with --kmer-out (full drain): reads/s, distinct
    k-mers, drain ms and bytes, write_counts seconds; summary == full on
    distinct, histogram and top 10; lane 1's dump on the card == on the
    CPU, byte for byte; a forced spill (capacity below the distinct count)
    == the unspilled counts; --canonical at k = 21 and k = 31 on a
    20,000-read subset == count_kmers_python exactly. The drain codec
    beside the drain's raw fetch: the full run's 15.5 M-key store fetched
    raw and through plane_pack and the native decoder in turns, identical,
    each route's bytes and ms, kp and cp.

20. Monitors and profiler traces: ``--full-wgs --mode sw`` on phase 4's
    files from a fresh checkpoint directory with ``--profile`` (its bench
    row must carry a monitor summary with the device-busy estimate from
    nvidia-smi, the peak device memory and the highest power draw, and
    ``nvidia_smi.log`` must hold samples), ``--variant-prep --gapped
    --gap-model affine --genotype`` and ``--kmer`` on phase 9's two lanes
    with ``--profile``: in each trace every port kernel launched as often
    as its wrapper counted (set to 0 just before, read just after), the
    pileup kernel once a first-pass chunk, the
    device-busy share from the trace (kernel, memcpy and memset intervals
    over the traced window), and the wall with --profile beside the wall
    without it.
21. The port's tools: ``tools.kernel_check`` (15 PASS rows; its long rows
    at GATE_LONG), ``tools.smoke`` (13/13), ``linecount`` on phase 4's
    files and ``stdin_linecount`` in a subprocess, ``make_scale_data``
    in a subprocess (4 lanes x 50,000 reads), a clean ``--full-wgs --mode kadane`` over
    them in 500-read chunks, the resilience soak at lane L003, chunk 60
    (the injection must fire once, the file must resume from chunk 50,
    every file equal to the clean run), and ``tools.autotune``'s winners.

22. parallel/: a mesh of 4 shards of cuda:0 against the single-device
    engines: --full-wgs's engine in all four modes on phase 4's files,
    score_read_batch on the main shape's pairs, make_wgs_step and
    make_wgs_step_packed against one shard (every statistic), phase 8's
    complementarity lanes, --variant-prep --gapped --rescue --genotype
    (and its SAM pass) linear and affine on the 4,000-read lane (pileup,
    VCF and SAM bytes), --kmer on the 100,000-read lane (summary and the
    full dump's bytes); the long pair of phase 8 in 4 row bands of a
    (1, 4) seq mesh == sw_score_long, timed beside it, and the kernel
    bands == the plain bands at 3,000 x 2,000; the CLI under
    MPT_MESH_SHAPE=1 and 1x1 (--full-wgs, --long-align); --full-wgs in two
    processes over gloo on the one card (JAX_COORDINATOR_ADDRESS): both
    ranks' merged totals == the single process's, the files split. Every
    path's kernels must have launched.
23. The measurement harness, each module a subprocess on the card:
    ``bench.headline`` at full size (10,000 x 150 bp; its batch ms within
    20% of phase 3's sw_score median, printed side by side),
    ``bench.workloads`` at its defaults (100,000 reads, a 100 kb
    reference; bench_workloads.py's ten rows in its order),
    ``bench.scaling`` at 1, 2 and 4 shards of cuda:0 (every size == one
    shard) and ``bench.multiprocess`` at 1 and 2 processes (identical
    merged totals). Every row must be correct and carry the card's name
    and power limit; the phase must take under 150 s.
24. Every process the script started has ended. The script is the
    subreaper of all it starts (an orphan comes back to it, not to init);
    any process still running below it is named, sent SIGTERM, then
    SIGKILL after STOP_GRACE_S, and reaped. This also runs when a phase
    fails.

Then one JSON line of kernel results (each with its bound: see
tools/roofline.py), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits 1 without.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

SEED = 0
MAIN_B, MAIN_LEN, MAIN_PAD = 10_000, 150, 152
FILE_READS, CHUNK_READS = 100_000, 10_000
N_RATE = 0.001
REPEATS = 7


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rand_reads(rng, n: int, length: int) -> np.ndarray:
    """(n, length) uint8 ACGT reads with ~N_RATE N calls."""
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n, length))
    reads[rng.random((n, length)) < N_RATE] = ord("N")
    return reads


def padded(rows: list[bytes], width: int, pad: int, device):
    import torch

    from mini_parallel_tpu_torch.ops import encode

    arr, _ = encode.pad_batch(rows, pad_to=width, pad_value=pad)
    return torch.from_numpy(arr).to(device)


def pair_batch(rows_a, rows_b, width_a, width_b, device):
    from mini_parallel_tpu_torch.ops import encode

    return (padded(rows_a, width_a, int(encode.PAD_A), device),
            padded(rows_b, width_b, int(encode.PAD_B), device))


def main_shape_pairs(rng):
    """Half related pairs (b = a with ~10% substitutions), half unrelated."""
    a = rand_reads(rng, MAIN_B, MAIN_LEN)
    b = rand_reads(rng, MAIN_B, MAIN_LEN)
    related = a.copy()
    sub = rng.random(related.shape) < 0.1
    related[sub] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(sub.sum()))
    b[0::2] = related[0::2]
    return [r.tobytes() for r in a], [r.tobytes() for r in b]


def ragged(rng, B, max_a, max_b):
    ra = [rand_reads(rng, 1, int(rng.integers(1, max_a)))[0].tobytes() for _ in range(B)]
    rb = [rand_reads(rng, 1, int(rng.integers(1, max_b)))[0].tobytes() for _ in range(B)]
    return ra, rb


def phase_card():
    """Card facts, then one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mini_parallel_tpu_torch import _build, native
    from mini_parallel_tpu_torch.device import device_info
    from mini_parallel_tpu_torch.ops import (
        pairhmm_cuda,
        pileup_cuda,
        sw_cuda,
        sw_long,
        sw_traceback_cuda,
    )
    from mini_parallel_tpu_torch.tools import roofline

    info = device_info()
    print(f"[1 card] {info['nvidia_smi']} | count {info['count']} | "
          f"torch {torch.__version__} | CUDA {torch.version.cuda}", flush=True)
    libs = [(sw_cuda.KERNEL_NAME, sw_cuda.KERNEL_SOURCES),
            (sw_cuda.AFFINE_KERNEL_NAME, sw_cuda.AFFINE_KERNEL_SOURCES),
            (sw_long.KERNEL_NAME, sw_long.KERNEL_SOURCES),
            (sw_cuda.VS_REF_KERNEL_NAME, sw_cuda.VS_REF_KERNEL_SOURCES),
            (sw_traceback_cuda.KERNEL_NAME, sw_traceback_cuda.KERNEL_SOURCES),
            (pairhmm_cuda.KERNEL_NAME, pairhmm_cuda.KERNEL_SOURCES),
            (pileup_cuda.KERNEL_NAME, pileup_cuda.KERNEL_SOURCES),
            (roofline.KERNEL_NAME, roofline.KERNEL_SOURCES)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + len(native.LIBRARIES)) as pool:
        host = pool.map(native.build, native.LIBRARIES)
        built = list(pool.map(lambda lib: _build.build(*lib), libs))
        info["native_builds"] = dict(zip(native.LIBRARIES, host))
    print(f"[1 build] {len(libs)} CUDA sources and {len(native.LIBRARIES)} "
          f"host libraries in parallel: {time.perf_counter() - t0:.2f} s "
          "wall", flush=True)
    for name, (path, seconds) in info["native_builds"].items():
        check(path.is_file(), f"host library {path} missing after build")
        native.load(name)
        print(f"[1 build] g++ {name}: {seconds:.2f} s -> {path}", flush=True)
    for path, seconds in built:
        check(path.is_file(), f"kernel library {path} missing after build")
        print(f"[1 build] {path.name}: {seconds:.2f} s", flush=True)
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.is_file() else []:
            if "registers" in line or "spill" in line:
                print(f"[1 ptxas] {line.strip()}", flush=True)
    return info


def phase_compare(rng, device):
    import torch

    from mini_parallel_tpu_torch.ops import sw, sw_cuda

    ra, rb = main_shape_pairs(rng)
    cases = {"main 10000x150 pad 152": (ra, rb, MAIN_PAD, MAIN_PAD)}
    cases["M != N, B=37"] = (*ragged(rng, 37, 90, 60), 96, 64)
    cases["B=3 (not a block multiple)"] = (*ragged(rng, 3, 80, 60), 96, 64)
    cases["empty rows"] = ([b"", b"AAAA", b""], [b"ACGT", b"TTTT", b""], 16, 16)
    cases["identical ACGTx20"] = ([b"ACGT" * 20], [b"ACGT" * 20], 96, 96)
    cases["N bases"] = ([b"ACNNGTNA" * 10, b"N" * 50],
                        [b"ACNNGTNA" * 9, b"NNNN" + b"ACGT" * 10], 80, 72)
    cases["multi-stripe M=600, B=21"] = (*ragged(rng, 21, 600, 120), 600, 120)
    big_a = rand_reads(rng, 1, 2048)[0].tobytes()
    big_b = bytearray(big_a)
    for k in range(0, 2048, 9):
        big_b[k] = ord("T")
    cases["B=1 2048x2048"] = ([big_a], [bytes(big_b)], 2048, 2048)

    max_err = 0
    for name, (rows_a, rows_b, wa, wb) in cases.items():
        a, b = pair_batch(rows_a, rows_b, wa, wb, device)
        got = sw_cuda.sw_score_batch_cuda(a, b)
        want = sw.sw_score_batch(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if len(rows_a) else 0
        max_err = max(max_err, err)
        print(f"[2 compare] {name}: B={len(rows_a)} kernel==plain "
              f"{bool(torch.equal(got, want))} max_abs_err {err} "
              f"max_score {int(got.max())}", flush=True)
        check(torch.equal(got, want), f"kernel != plain on {name}")
    check(int(sw_cuda.sw_score_batch_cuda(*pair_batch(
        [b"ACGT" * 20], [b"ACGT" * 20], 96, 96, device))[0]) == 160,
        "identical ACGTx20 must score 160")

    a, b = pair_batch(ra[:16], rb[:16], MAIN_PAD, MAIN_PAD, device)
    got = sw_cuda.sw_score_batch_cuda(a, b).cpu().tolist()
    golden = [sw.sw_score_numpy(x, y) for x, y in zip(ra[:16], rb[:16])]
    print(f"[2 golden] 16 pairs vs sw_score_numpy: {got == golden}", flush=True)
    check(got == golden, f"kernel {got} != golden {golden}")
    return (ra, rb), max_err


def time_samples(fn, launches: int = 1, repeats: int = REPEATS
                 ) -> list[float]:
    """``repeats`` CUDA-event times per call (ms), ``launches`` calls
    between the events, after one warm-up call."""
    import torch

    fn()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / launches)
    return samples


def report_time(phase: int, label: str, samples: list[float],
                cells: float) -> float:
    """Print the median, GCUPS over ``cells``, min and max; return the
    median (ms)."""
    ms = statistics.median(samples)
    print(f"[{phase} time] {label}: {ms:.4f} ms median of {len(samples)} "
          f"({cells / ms / 1e6:.1f} GCUPS; min {min(samples):.4f}, max "
          f"{max(samples):.4f} ms)", flush=True)
    return ms


def phase_times(main_pairs, device):
    """Plain, kernel, kernel, plain; each time is the median of its two
    rounds' samples."""
    from mini_parallel_tpu_torch.ops import sw, sw_cuda

    a, b = pair_batch(*main_pairs, MAIN_PAD, MAIN_PAD, device)
    cells = MAIN_B * MAIN_LEN * MAIN_LEN
    plain = time_samples(lambda: sw.sw_score_batch(a, b))
    kernel = time_samples(lambda: sw_cuda.sw_score_batch_cuda(a, b), 20)
    kernel += time_samples(lambda: sw_cuda.sw_score_batch_cuda(a, b), 20)
    plain += time_samples(lambda: sw.sw_score_batch(a, b))
    return (report_time(3, "kernel 10000x150 (pad 152)", kernel, cells),
            report_time(3, "plain 10000x150 (pad 152)", plain, cells))


def write_fixtures(rng, data_dir: str, sample: str) -> tuple[int, int]:
    """4 files x FILE_READS reads; file 3 ragged (100-151 bp). Returns
    (total bases, chunks >= 1000 bases)."""
    total_bases = 0
    chunks = 0
    names = [f"{sample}_L{lane:03d}_R{read}_001.fastq.gz"
             for lane in (1, 2) for read in (1, 2)]
    for k, name in enumerate(names):
        if k == 2:
            lens = rng.integers(100, 152, size=FILE_READS)
            full = rand_reads(rng, FILE_READS, 151)
            reads = [full[i, :n].tobytes() for i, n in enumerate(lens)]
        else:
            reads = [r.tobytes() for r in rand_reads(rng, FILE_READS, MAIN_LEN)]
        text = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
                        for i, r in enumerate(reads))
        with open(os.path.join(data_dir, name), "wb") as f:
            f.write(gzip.compress(text, compresslevel=1))
        lens = [len(r) for r in reads]
        total_bases += sum(lens)
        for c in range(0, len(lens), CHUNK_READS):
            chunks += sum(lens[c:c + CHUNK_READS]) >= 1000
    return total_bases, chunks


def run_cli(mode: str, env_path: str, results_dir: str):
    """One ``--full-wgs`` invocation; returns (its benchmark row, wall s,
    echoed lines)."""
    from mini_parallel_tpu_torch import cli

    lines: list[str] = []
    t0 = time.perf_counter()
    rc = cli.main(["--full-wgs", "--mode", mode, "--env", env_path],
                  echo=lines.append)
    wall = time.perf_counter() - t0
    check(rc == 0, f"--full-wgs --mode {mode} exited {rc}: {lines[-5:]}")
    failed = [ln for ln in lines if "failed" in ln.lower()]
    check(not failed, f"chunks failed in {mode} mode: {failed[:3]}")
    runs = sorted(int(n.split("_")[1]) for n in os.listdir(results_dir)
                  if n.startswith("run_"))
    with open(os.path.join(results_dir,
                           f"run_{runs[-1]}_benchmark_results.json")) as f:
        row = json.load(f)
    return row, wall, lines


def report_engine(phase: int) -> None:
    """The FASTQ engine the read paths' "auto" resolves to: native here."""
    from mini_parallel_tpu_torch.io import fastq

    engine = fastq.resolved_engine("auto")
    print(f"[{phase} engine] FASTQ engine auto -> {engine}", flush=True)
    check(engine == "native", f"the read paths run the {engine} engine")


def phase_main_path(rng, tmp: str):
    """Returns the kernel launches of the sw run and the fixture facts the
    later phases reuse: (launches, env path, results dir, total bases)."""
    import torch

    from mini_parallel_tpu_torch.ops import sw_cuda

    report_engine(4)
    cwd = os.getcwd()
    t0 = time.perf_counter()
    total_bases, big_chunks = write_fixtures(rng, tmp, "SMOKE")
    n_chunks = 4 * -(-FILE_READS // CHUNK_READS)
    print(f"[4 fixtures] 4 files, {4 * FILE_READS} reads, {total_bases} "
          f"bases, {n_chunks} chunks: {time.perf_counter() - t0:.2f} s",
          flush=True)
    results_dir = os.path.join(tmp, "benchmark_results")
    env_path = os.path.join(tmp, "smoke.env")
    with open(env_path, "w") as f:
        f.write(f"WGS_DATA_DIR={tmp}\nWGS_SAMPLE_ID=SMOKE\nWGS_LANES=2\n"
                f"WGS_READS_PER_LANE=2\nGPU_CHUNK_SIZE_READS={CHUNK_READS}\n"
                f"MPT_RESULTS_DIR={results_dir}\n")
    os.chdir(tmp)  # checkpoints land in the working directory
    try:
        sw_cuda.sw_score_batch_cuda.launches = 0
        row, wall, _ = run_cli("sw", env_path, results_dir)
        torch.cuda.synchronize()
        launches = sw_cuda.sw_score_batch_cuda.launches
        print(f"[4 sw] score {row['total_score']} bases {row['total_bases']} "
              f"reads {row['total_reads']} launches {launches} | wall "
              f"{wall:.2f} s, run {row['total_time_seconds']:.2f} s, "
              f"{row['throughput_reads_per_second']:.0f} reads/s",
              flush=True)
        check(row["total_bases"] == total_bases,
              f"sw bases {row['total_bases']} != {total_bases}")
        check(row["total_score"] == 2 * total_bases,
              f"sw total {row['total_score']} != 2 x {total_bases}")
        check(row["total_reads"] == 4 * FILE_READS, "sw read count")
        check(launches == n_chunks,
              f"kernel launched {launches} times for {n_chunks} sw chunks")

        krow, kwall, _ = run_cli("kadane", env_path, results_dir)
        print(f"[4 kadane] score {krow['total_score']} bases "
              f"{krow['total_bases']} | wall {kwall:.2f} s, run "
              f"{krow['total_time_seconds']:.2f} s, "
              f"{krow['throughput_reads_per_second']:.0f} reads/s",
              flush=True)
        check(krow["total_score"] == 2 * big_chunks,
              f"kadane total {krow['total_score']} != 2 x {big_chunks}")
        check(krow["total_bases"] == total_bases, "kadane bases")

        before = sw_cuda.sw_score_batch_cuda.launches
        rrow, _, lines = run_cli("sw", env_path, results_dir)
        skipped = sum("Skipping file" in ln for ln in lines)
        print(f"[4 resume] sw rerun skipped {skipped}/4 files, new reads "
              f"{rrow['total_reads']}", flush=True)
        check(skipped == 4 and rrow["total_reads"] == 0,
              "the sw rerun did not resume from its checkpoint")
        check(sw_cuda.sw_score_batch_cuda.launches == before,
              "the resumed run launched the kernel")
    finally:
        os.chdir(cwd)
    return launches, env_path, results_dir, total_bases


# ---------------------------------------------------------------------------
# Affine kernel (csrc/sw_affine_score.cu) and long-pair strip kernel
# (csrc/sw_long.cu)
# ---------------------------------------------------------------------------

LONG_M, LONG_N, SEGMENT = 200_000, 150_000, 50_000
CMP_M, CMP_N = 20_000, 15_000
NARROW_WIDTH = 512  # 30 strips at CMP_N
COMP_MATES = 100_000
IDENTICAL_LEN = 100_000


def phase_affine_compare(rng, main_pairs, device):
    """The affine kernel == plain sw_affine_batch on the card, exactly."""
    import torch

    from mini_parallel_tpu_torch.ops import sw, sw_cuda

    ra, rb = main_pairs
    cases = {"main 10000x150 pad 152": (ra, rb, MAIN_PAD, MAIN_PAD, -2, -1)}
    cases["M != N, B=37"] = (*ragged(rng, 37, 90, 60), 96, 64, -2, -1)
    cases["B=3 (not a block multiple)"] = (*ragged(rng, 3, 80, 60), 96, 64,
                                           -2, -1)
    cases["empty rows"] = ([b"", b"AAAA", b""], [b"ACGT", b"TTTT", b""], 16,
                           16, -2, -1)
    cases["identical ACGTx20"] = ([b"ACGT" * 20], [b"ACGT" * 20], 96, 96,
                                  -2, -1)
    cases["N bases"] = ([b"ACNNGTNA" * 10, b"N" * 50],
                        [b"ACNNGTNA" * 9, b"NNNN" + b"ACGT" * 10], 80, 72,
                        -2, -1)
    cases["multi-stripe M=600, B=21"] = (*ragged(rng, 21, 600, 120), 600,
                                         120, -2, -1)
    big_a = rand_reads(rng, 1, 2048)[0].tobytes()
    big_b = bytearray(big_a)
    for k in range(0, 2048, 9):
        big_b[k] = ord("T")
    del big_b[1000:1012]  # one 12-base gap
    cases["B=1 2048x2048"] = ([big_a], [bytes(big_b)], 2048, 2048, -2, -1)
    cases["(0, -2) == linear, 10000x152"] = (ra, rb, MAIN_PAD, MAIN_PAD, 0, -2)
    cases["custom (-5, -1), B=37"] = (*ragged(rng, 37, 150, 150), 152, 152,
                                      -5, -1)
    cases["custom (-3, -2), multi-stripe"] = (*ragged(rng, 21, 600, 300),
                                              600, 304, -3, -2)
    max_err = 0
    for name, (rows_a, rows_b, wa, wb, go, ge) in cases.items():
        a, b = pair_batch(rows_a, rows_b, wa, wb, device)
        got = sw_cuda.sw_affine_batch_cuda(a, b, go, ge)
        want = sw.sw_affine_batch(a, b, go, ge)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        print(f"[5 affine] {name}: B={len(rows_a)} (go {go}, ge {ge}) "
              f"kernel==plain {bool(torch.equal(got, want))} max_abs_err "
              f"{err} max_score {int(got.max())}", flush=True)
        check(torch.equal(got, want), f"affine kernel != plain on {name}")
        if (go, ge) == (0, -2):
            lin = sw_cuda.sw_score_batch_cuda(a, b)
            print(f"[5 affine] {name}: == linear kernel "
                  f"{bool(torch.equal(got, lin))}", flush=True)
            check(torch.equal(got, lin), "affine (0, -2) != linear kernel")
    check(int(sw_cuda.sw_affine_batch_cuda(*pair_batch(
        [b"ACGT" * 20], [b"ACGT" * 20], 96, 96, device))[0]) == 160,
        "identical ACGTx20 must score 160")
    a, b = pair_batch(ra[:16], rb[:16], MAIN_PAD, MAIN_PAD, device)
    got = sw_cuda.sw_affine_batch_cuda(a, b).cpu().tolist()
    golden = [sw.sw_affine_numpy(x, y) for x, y in zip(ra[:16], rb[:16])]
    print(f"[5 golden] 16 pairs vs sw_affine_numpy: {got == golden}",
          flush=True)
    check(got == golden, f"affine kernel {got} != golden {golden}")
    return max_err


def long_pair(rng, m: int, n: int, seg: int = 0, a_at: int = 0,
              b_at: int = 0, gap: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random ACGT a (m,) and b (n,) sharing ``seg`` bases (a[a_at:],
    b[b_at:]), b's copy split in the middle by a ``gap``-base insertion."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(acgt, m)
    b = rng.choice(acgt, n)
    if seg:
        shared = rng.choice(acgt, seg)
        a[a_at:a_at + seg] = shared
        half = seg // 2
        copy = np.concatenate([shared[:half], rng.choice(acgt, gap),
                               shared[half:]])
        b[b_at:b_at + copy.size] = copy
    return a, b


def phase_long_compare(rng, device):
    """The strip kernel == the plain per-strip function on the card, linear
    and affine: one strip with random carried columns, then whole host
    loops at two strip widths, against the blocked goldens, and edge
    cases."""
    import torch

    from mini_parallel_tpu_torch.ops import sw_long

    max_err = 0
    a, b = long_pair(rng, CMP_M, 8192)
    ta, tb = (torch.from_numpy(x).to(device) for x in (a, b))
    lh = torch.from_numpy(rng.integers(0, 80, CMP_M).astype(np.int32)).to(device)
    lf = torch.from_numpy(rng.integers(-90, 60, CMP_M).astype(np.int32)).to(device)
    for label, got, want in (
            ("linear", sw_long.sw_strip_cuda(ta, tb, lh),
             sw_long.sw_strip(ta, tb, lh)),
            ("affine", sw_long.sw_affine_strip_cuda(ta, tb, lh, lf),
             sw_long.sw_affine_strip(ta, tb, lh, lf))):
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        max_err = max(max_err, err)
        print(f"[6 strip] {label} one strip {CMP_M} x 8192 (a group of "
              f"one), carried columns in: best {int(got[0])} kernel==plain "
              f"(best and right columns) {err == 0} max_abs_err {err}",
              flush=True)
        check(err == 0, f"{label} strip kernel != plain")
    max_err = max(max_err, compare_groups(device))

    cpu_scores = {}
    # a shared segment with a 40-base gap, across the 8192-column edge
    a, b = long_pair(rng, CMP_M, CMP_N, seg=CMP_N // 5, a_at=CMP_M // 3,
                     b_at=CMP_N // 2, gap=40)
    for affine, fn in ((False, sw_long.sw_score_long),
                       (True, sw_long.sw_affine_score_long)):
        label = "affine" if affine else "linear"
        for width in (sw_long.MAX_STRIP_WIDTH, NARROW_WIDTH):
            k = fn(a, b, device, strip_width=width)
            p = _plain_long(fn, a, b, device, width)
            err = abs(k - p)
            max_err = max(max_err, err)
            print(f"[6 long] {label} {CMP_M} x {CMP_N}, strip width {width} "
                  f"({-(-CMP_N // width)} strips): kernel {k} plain {p} "
                  f"max_abs_err {err}", flush=True)
            check(k == p, f"{label} long kernel != plain at width {width}")
            cpu_scores.setdefault(label, set()).add(k)
        check(len(cpu_scores[label]) == 1, f"{label} score depends on width")

    # a planted common segment (a[600:1400] = b[900:1700], across the
    # 1024-column strip edge) and a planted 30-base gap at column 1299
    a, b = long_pair(rng, 3000, 5000, seg=800, a_at=600, b_at=900, gap=30)
    for affine, fn, golden in (
            (False, sw_long.sw_score_long, sw_long.sw_score_numpy_blocked),
            (True, sw_long.sw_affine_score_long,
             sw_long.sw_affine_numpy_blocked)):
        label = "affine" if affine else "linear"
        k = fn(a, b, device, strip_width=1024)
        p = _plain_long(fn, a, b, device, 1024)
        g = golden(a.tobytes(), b.tobytes())
        max_err = max(max_err, abs(k - p), abs(k - g))
        print(f"[6 golden] {label} 3000 x 5000 (segment and gap across a "
              f"strip edge): kernel {k} plain {p} blocked golden {g}",
              flush=True)
        check(k == p == g, f"{label} long kernel, plain and golden disagree")

    same = rng.choice(np.frombuffer(b"ACGT", np.uint8), IDENTICAL_LEN)
    for fn in (sw_long.sw_score_long, sw_long.sw_affine_score_long):
        t0 = time.perf_counter()
        got = fn(same, same, device)
        dt = time.perf_counter() - t0
        print(f"[6 identical] {fn.__name__} {IDENTICAL_LEN} x "
              f"{IDENTICAL_LEN}: {got} (2n = {2 * IDENTICAL_LEN}) "
              f"{dt:.3f} s", flush=True)
        check(got == 2 * IDENTICAL_LEN, f"{fn.__name__} of an identical "
              "pair != 2n")
        check(fn(b"", same, device) == 0 and fn(same, b"", device) == 0,
              f"{fn.__name__} of an empty side != 0")
    print("[6 empty] empty sides score 0", flush=True)
    return max_err


def compare_groups(device) -> int:
    """The strip-group kernel == the plain group function on the card,
    linear and affine, from random carried-in columns: more strips than
    the card holds blocks (a second wave of tickets), M not a multiple of
    the 32-row chunk, M below one chunk, a ragged last strip and strips of
    several warps. Returns the largest difference. Its own generator keeps
    the later phases' data as it was before these cases."""
    import torch

    from mini_parallel_tpu_torch.ops import sw_long

    rng = np.random.default_rng(SEED + 6)
    fit = max(sw_long.resident_blocks(16, affine, device)
              for affine in (False, True))
    cases = {f"second wave: {fit + 37} strips of 16 > {fit} resident": (
                 45, 16, 16 * (fit + 37)),
             "M = 1000 (not a chunk multiple), 20 strips of 64": (
                 1000, 64, 64 * 20),
             "M = 7 (below one chunk), 9 strips of 32": (7, 32, 32 * 9),
             "ragged last strip: 3 x 512 + 48": (CMP_M, 512, 512 * 3 + 48),
             "strips of 4 warps: 3 x 2048 + 1024": (3000, 2048, 2048 * 3 + 1024)}
    max_err = 0
    for name, (M, W, Wtot) in cases.items():
        a = rng.choice(np.frombuffer(b"ACGTN", np.uint8), M)
        b = rng.choice(np.frombuffer(b"ACGTN", np.uint8), Wtot)
        half = min(M, Wtot) // 2
        b[Wtot // 3:Wtot // 3 + half] = a[:half]
        ta, tb = (torch.from_numpy(x).to(device) for x in (a, b))
        lh = torch.from_numpy(rng.integers(0, 60, M).astype(np.int32)).to(device)
        lf = torch.from_numpy(rng.integers(-70, 50, M).astype(np.int32)
                              ).to(device)
        for label, got, want in (
                ("linear", sw_long.sw_strip_cuda(ta, tb, lh, strip_width=W),
                 sw_long.sw_strip_group(ta, tb, lh, strip_width=W)),
                ("affine", sw_long.sw_affine_strip_cuda(
                    ta, tb, lh, lf, -3, -1, strip_width=W),
                 sw_long.sw_affine_strip_group(ta, tb, lh, lf, -3, -1,
                                               strip_width=W))):
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            max_err = max(max_err, err)
            print(f"[6 group] {label} {name}, {M} rows: best {int(got[0])} "
                  f"kernel==plain group (best and last columns) {err == 0} "
                  f"max_abs_err {err}", flush=True)
            check(err == 0, f"{label} group kernel != plain on {name}")
    return max_err


def _plain_long(fn, a, b, device, width):
    """``fn``'s host loop with the plain group function on the card."""
    from mini_parallel_tpu_torch.ops import sw_long

    real = sw_long.strip_best
    sw_long.strip_best = lambda affine, dev: (sw_long.sw_affine_strip_group
                                              if affine
                                              else sw_long.sw_strip_group)
    try:
        return fn(a, b, device, strip_width=width)
    finally:
        sw_long.strip_best = real


def phase_new_times(rng, main_pairs, device):
    """Affine kernel vs plain at 10,000 x 152 (plain, kernel, kernel,
    plain); the long kernel at 200,000 x 150,000 and its plain host loop
    at 20,000 x 15,000; the batched kernel at B = 1 against the long
    kernel at 2048^2 and 8192^2 (the LONG_PAIR_THRESHOLD crossover)."""
    import torch

    from mini_parallel_tpu_torch.ops import sw, sw_cuda, sw_long
    from mini_parallel_tpu_torch.ops.sw import NEG

    a, b = pair_batch(*main_pairs, MAIN_PAD, MAIN_PAD, device)
    cells = MAIN_B * MAIN_LEN * MAIN_LEN
    plain = time_samples(lambda: sw.sw_affine_batch(a, b))
    kernel = time_samples(lambda: sw_cuda.sw_affine_batch_cuda(a, b), 20)
    kernel += time_samples(lambda: sw_cuda.sw_affine_batch_cuda(a, b), 20)
    plain += time_samples(lambda: sw.sw_affine_batch(a, b))
    times = {"affine_ms": report_time(7, "affine kernel 10000x150 (pad 152)",
                                      kernel, cells),
             "affine_plain_ms": report_time(
                 7, "affine plain 10000x150 (pad 152)", plain, cells)}

    W = sw_long.DEFAULT_STRIP_WIDTH
    for m, n in ((LONG_M, LONG_N), (CMP_M, CMP_N)):
        strips = -(-n // W)
        print(f"[7 geometry] {m} x {n}: {strips} strips of {W} in "
              f"{-(-strips // sw_long.group_strips(m, True))} affine "
              f"group(s); "
              f"the card holds {sw_long.resident_blocks(W, False, device)} "
              f"such blocks linear, "
              f"{sw_long.resident_blocks(W, True, device)} affine", flush=True)
    la, lb = long_pair(rng, LONG_M, LONG_N)
    for fn in (sw_long.sw_score_long, sw_long.sw_affine_score_long):
        report_time(7, f"{fn.__name__} kernel {LONG_M} x {LONG_N}",
                    time_samples(lambda: fn(la, lb, device), repeats=3),
                    float(LONG_M) * LONG_N)
    # one strip of the default width alone: one warp with nothing to wait
    # on, so the time over LONG_M + 31 steps is one step's latency
    ta = torch.from_numpy(la).to(device)
    tb = torch.from_numpy(lb[:W].copy()).to(device)
    h0 = torch.zeros(LONG_M, dtype=torch.int32, device=device)
    f0 = torch.full((LONG_M,), NEG, dtype=torch.int32, device=device)
    for label, fn in (("linear", lambda: sw_long.sw_strip_cuda(ta, tb, h0)),
                      ("affine", lambda: sw_long.sw_affine_strip_cuda(
                          ta, tb, h0, f0))):
        ms = report_time(7, f"one {label} strip alone, {LONG_M} x {W} (one "
                         "warp)", time_samples(fn, repeats=3),
                         float(LONG_M) * W)
        print(f"[7 step] {label}: {1e6 * ms / (LONG_M + 31):.1f} ns a "
              "wavefront step of one warp", flush=True)
    ca, cb = long_pair(rng, CMP_M, CMP_N)
    cmp_cells = float(CMP_M) * CMP_N
    long_times = {}
    for fn in (sw_long.sw_score_long, sw_long.sw_affine_score_long):
        long_times[fn] = (
            report_time(7, f"{fn.__name__} kernel {CMP_M} x {CMP_N}",
                        time_samples(lambda: fn(ca, cb, device), repeats=5),
                        cmp_cells),
            report_time(7, f"{fn.__name__} plain host loop {CMP_M} x {CMP_N}",
                        time_samples(lambda: _plain_long(
                            fn, ca, cb, device, sw_long.MAX_STRIP_WIDTH),
                            repeats=2), cmp_cells))
    times["long_ms"], times["long_plain_ms"] = long_times[
        sw_long.sw_score_long]
    times["long_affine_ms"], times["long_affine_plain_ms"] = long_times[
        sw_long.sw_affine_score_long]
    for n in (2048, 8192):
        x, y = long_pair(rng, n, n, seg=n // 2, a_at=n // 4, b_at=n // 4)
        tx, ty = pair_batch([x.tobytes()], [y.tobytes()], n, n, device)
        batched = statistics.median(time_samples(
            lambda: sw_cuda.sw_score_batch_cuda(tx, ty), repeats=5))
        strips = statistics.median(time_samples(
            lambda: sw_long.sw_score_long(x, y, device), repeats=5))
        print(f"[7 crossover] {n} x {n}: batched kernel B=1 {batched:.4f} ms "
              f"({n * n / batched / 1e6:.2f} GCUPS), long kernel "
              f"{strips:.4f} ms ({n * n / strips / 1e6:.2f} GCUPS)",
              flush=True)
    return times


def write_complementary_lanes(rng, tmp: str) -> tuple[str, str, int]:
    """R1: COMP_MATES ACGT reads of 150 bp; R2: their reverse complements,
    exactly 10% of them with one substitution. Returns the paths and the
    number of mates that are not perfectly complementary."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    r1 = rng.choice(acgt, (COMP_MATES, MAIN_LEN))
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    r2 = comp[r1][:, ::-1].copy()
    bad = rng.choice(COMP_MATES, COMP_MATES // 10, replace=False)
    col = rng.integers(0, MAIN_LEN, bad.size)
    shift = rng.integers(1, 4, bad.size)  # another base, never the same
    code = np.zeros(256, np.int64)
    code[list(b"ACGT")] = [0, 1, 2, 3]
    r2[bad, col] = acgt[(code[r2[bad, col]] + shift) % 4]
    paths = []
    for k, reads in ((1, r1), (2, r2)):
        text = b"".join(b"@m%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * MAIN_LEN)
                        for i, r in enumerate(reads))
        path = os.path.join(tmp, f"COMP_L001_R{k}_001.fastq.gz")
        with open(path, "wb") as f:
            f.write(gzip.compress(text, compresslevel=1))
        paths.append(path)
    return paths[0], paths[1], bad.size


def cli_lines(argv: list[str]) -> tuple[list[str], float]:
    from mini_parallel_tpu_torch import cli

    lines: list[str] = []
    t0 = time.perf_counter()
    rc = cli.main(argv, echo=lines.append)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv[:4])} exited {rc}: {lines[-5:]}")
    return lines, wall


def line_value(lines: list[str], prefix: str) -> str:
    found = [ln[len(prefix):].strip() for ln in lines if ln.startswith(prefix)]
    check(len(found) == 1, f"expected one '{prefix}' line, got {found}")
    return found[0]


def plain_mate_sum(r1: str, r2: str, affine: bool, device) -> int:
    """The sum of the plain version's scores over the mate pairs of two
    FASTQ files, chunk by chunk on the card."""
    import torch

    from mini_parallel_tpu_torch.io import fastq
    from mini_parallel_tpu_torch.ops import sw

    total = 0
    for (f1, o1), (f2, o2) in zip(fastq.iter_flat_chunks(r1, CHUNK_READS),
                                  fastq.iter_flat_chunks(r2, CHUNK_READS)):
        n = min(len(o1), len(o2)) - 1
        rows_a = [f1[o1[i]:o1[i + 1]].tobytes() for i in range(n)]
        rows_b = [f2[o2[i]:o2[i + 1]].tobytes() for i in range(n)]
        a, b = pair_batch(rows_a, rows_b, MAIN_PAD, MAIN_PAD, device)
        scores = sw.sw_affine_batch(a, b) if affine else sw.sw_score_batch(a, b)
        total += int(scores.to(torch.int64).sum())
    return total


def phase_slice_paths(rng, tmp: str, env_path: str, results_dir: str,
                      total_bases: int, device) -> dict:
    """This slice's entry points through cli.main: --full-wgs in sw-affine
    and contiguous mode, --files in all four modes, --complementarity and
    --long-align. Each path's kernel counts are set to 0 just before it
    and read just after. Returns the launches per kernel and the strip
    kernel's largest difference from the plain version at full size."""
    import torch

    from mini_parallel_tpu_torch.ops import sw_cuda, sw_long

    report_engine(8)
    counters = (sw_cuda.sw_score_batch_cuda, sw_cuda.sw_affine_batch_cuda,
                sw_long.sw_strip_cuda, sw_long.sw_affine_strip_cuda)

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts() -> str:
        torch.cuda.synchronize()
        return (f"launches sw_score {counters[0].launches}, sw_affine_score "
                f"{counters[1].launches}, sw_long {counters[2].launches} + "
                f"{counters[3].launches} affine")

    n_chunks = 4 * -(-FILE_READS // CHUNK_READS)
    launches = {}
    cwd = os.getcwd()
    os.chdir(tmp)  # checkpoints land in the working directory
    try:
        zero()
        row, wall, _ = run_cli("sw-affine", env_path, results_dir)
        launches["sw_affine_score"] = counters[1].launches
        print(f"[8 sw-affine] score {row['total_score']} bases "
              f"{row['total_bases']} | {counts()} | wall {wall:.2f} s, run "
              f"{row['total_time_seconds']:.2f} s, "
              f"{row['throughput_reads_per_second']:.0f} reads/s", flush=True)
        check(row["total_score"] == 2 * total_bases,
              f"sw-affine total {row['total_score']} != 2 x {total_bases}")
        check(counters[1].launches == n_chunks,
              f"affine kernel launched {counters[1].launches} times for "
              f"{n_chunks} chunks")
        row, wall, _ = run_cli("contiguous", env_path, results_dir)
        print(f"[8 contiguous] score {row['total_score']} bases "
              f"{row['total_bases']} | wall {wall:.2f} s, run "
              f"{row['total_time_seconds']:.2f} s, "
              f"{row['throughput_reads_per_second']:.0f} reads/s", flush=True)
        check(row["total_bases"] == total_bases, "contiguous bases")
        # every fixture chunk has >= 1000 bases (phase 4's kadane total),
        # and a chunk-concat against itself is one run of matches
        check(row["total_score"] == 2 * total_bases,
              f"contiguous total {row['total_score']} != 2 x {total_bases}")
    finally:
        os.chdir(cwd)

    r1 = os.path.join(tmp, "SMOKE_L001_R1_001.fastq.gz")
    r2 = os.path.join(tmp, "SMOKE_L001_R2_001.fastq.gz")
    env = ["--env", env_path]
    for mode in ("sw", "sw-affine", "kadane", "contiguous"):
        zero()
        lines, wall = cli_lines(["--files", "-1", r1, "-2", r2, "--mode", mode]
                                + env)
        score = int(line_value(lines, "Alignment score:"))
        print(f"[8 files {mode}] score {score} | {counts()} | wall "
              f"{wall:.2f} s | {line_value(lines, 'Processing time:')}",
              flush=True)
        if mode in ("sw", "sw-affine"):
            check(counters[0 if mode == "sw" else 1].launches > 0,
                  f"--files {mode} launched no kernel")
            plain = plain_mate_sum(r1, r2, mode == "sw-affine", device)
            print(f"[8 files {mode}] plain version over the same mates: "
                  f"{plain}", flush=True)
            check(score == plain, f"--files {mode} {score} != plain {plain}")

    c1, c2, n_bad = write_complementary_lanes(rng, tmp)
    zero()
    lines, wall = cli_lines(["--complementarity", "-1", c1, "-2", c2] + env)
    pct = line_value(lines, "Non-complementary:")
    print(f"[8 complementarity] pairs {line_value(lines, 'Pairs:')}, "
          f"perfect {line_value(lines, 'Perfectly complementary:')}, "
          f"non-complementary {pct} ({n_bad} mates planted) | {counts()} | "
          f"wall {wall:.2f} s", flush=True)
    check(pct == "10.00 %", f"--complementarity reported {pct}, not 10.00 %")
    check(int(line_value(lines, "Pairs:")) == COMP_MATES, "complementarity pairs")
    check(counters[0].launches > 0, "--complementarity launched no kernel")

    a, b = long_pair(rng, LONG_M, LONG_N, seg=SEGMENT, a_at=LONG_M // 5,
                     b_at=LONG_N // 3)
    from mini_parallel_tpu_torch.io import fasta

    fa, fb = os.path.join(tmp, "long_a.fa"), os.path.join(tmp, "long_b.fa")
    fasta.write_fasta(fa, {"a": a.tobytes()})
    fasta.write_fasta(fb, {"b": b.tobytes()})
    long_err = 0
    for mode, affine, fn in (("sw", False, sw_long.sw_score_long),
                             ("sw-affine", True, sw_long.sw_affine_score_long)):
        zero()
        lines, wall = cli_lines(["--long-align", "-1", fa, "-2", fb, "--mode",
                                 mode] + env)
        strips = counters[3 if affine else 2].launches
        launches["sw_long_affine" if affine else "sw_long"] = strips
        score = int(line_value(lines, "Alignment score:"))
        narrow = fn(a, b, device, strip_width=2048)
        print(f"[8 long-align {mode}] {LONG_M} x {LONG_N}: score {score}, "
              f"direct at strip width 2048: {narrow} | strip launches "
              f"{strips} | {line_value(lines, 'Processing time:')}",
              flush=True)
        check(strips > 0, f"--long-align {mode} launched no strip kernel")
        check(score == narrow, f"--long-align {mode}: {score} != {narrow} at "
              "a narrower strip width")
        if mode == "sw":
            check(score >= 2 * SEGMENT, f"sw score {score} < {2 * SEGMENT}")
        t0 = time.perf_counter()
        plain = _plain_long(fn, a, b, device, sw_long.MAX_STRIP_WIDTH)
        print(f"[8 long-align {mode}] plain host loop at strip width "
              f"{sw_long.MAX_STRIP_WIDTH}: {plain} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        check(score == plain, f"--long-align {mode}: {score} != plain {plain}")
        long_err = max(long_err, abs(score - plain),
                       compare_strips_at_scale(a, b, affine, device))
    return launches, long_err


def compare_strips_at_scale(a: np.ndarray, b: np.ndarray, affine: bool,
                            device) -> int:
    """The first two strips of a long pair (all of a's rows x
    MAX_STRIP_WIDTH columns each): the strip kernel against the plain
    per-strip function on the best score and the carried-out column(s).
    Strip 1 takes the plain version's carried columns of strip 0. Returns
    the largest difference."""
    import torch

    from mini_parallel_tpu_torch.ops import sw_long
    from mini_parallel_tpu_torch.ops.sw import NEG

    W = sw_long.MAX_STRIP_WIDTH
    ta = torch.from_numpy(a).to(device)
    tb = torch.from_numpy(b[:2 * W].copy()).to(device)
    cols = [torch.zeros(a.size, dtype=torch.int32, device=device)]
    if affine:
        cols.append(torch.full((a.size,), NEG, dtype=torch.int32,
                               device=device))
    kernel, plain = ((sw_long.sw_affine_strip_cuda, sw_long.sw_affine_strip)
                     if affine else (sw_long.sw_strip_cuda, sw_long.sw_strip))
    max_err = 0
    for s in range(2):
        strip = tb[s * W:(s + 1) * W]
        got = kernel(ta, strip, *cols)
        want = plain(ta, strip, *cols)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        max_err = max(max_err, err)
        print(f"[8 strip {'affine' if affine else 'linear'}] strip {s} of the "
              f"long pair, {a.size} x {W}: best {int(got[0])} kernel==plain "
              f"(best and right columns) {err == 0} max_abs_err {err}",
              flush=True)
        check(err == 0, f"strip kernel != plain on strip {s} at {a.size} rows")
        cols = list(want[1:])
        best = want[0] if s == 0 else torch.maximum(best, want[0])
    # the same 2 x MAX_STRIP_WIDTH columns as ONE group of default-width
    # strips, against the plain strips' best and carried columns
    start = [torch.zeros(a.size, dtype=torch.int32, device=device)]
    if affine:
        start.append(torch.full((a.size,), NEG, dtype=torch.int32,
                                device=device))
    W = sw_long.DEFAULT_STRIP_WIDTH
    got = kernel(ta, tb, *start, strip_width=W)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, (best, *cols)))
    max_err = max(max_err, err)
    print(f"[8 group {'affine' if affine else 'linear'}] the same columns as "
          f"one group of {tb.numel() // W} strips of {W}: best "
          f"{int(got[0])} == the plain strips' (best and last columns) "
          f"{err == 0} max_abs_err {err}", flush=True)
    check(err == 0, f"group kernel != plain strips at {a.size} rows")
    return max_err


# ---------------------------------------------------------------------------
# Variant prep (--variant-prep): csrc/sw_vs_ref.cu (--rescue) and
# csrc/sw_moves.cu (--gapped, linear and affine)
# ---------------------------------------------------------------------------

# a bacterial resequencing run: the length of E. coli K-12 MG1655 (RefSeq
# NC_000913.3) and a 100 kb plasmid, ~30x in two lanes of 150 bp reads
VP_CONTIGS = (("chr", 4_641_652), ("plasmid", 100_000))
VP_SNPS, VP_DELS, VP_INS = 4_000, 400, 400
VP_LANE_READS = 465_000
VP_SMALL_READS = 100_000  # the --rescue / --sam-out / checkpoint lane
VP_EXACT_READS = 4_000  # the lane run on the card and on the CPU
VP_READ_LEN = 150
VP_ERR, VP_LOWQ, VP_TARGETS = 0.002, 0.05, 0.01
PILEUP_MIN_QUALITY = 10  # the quality floor of phase 11's masked pileup
# middles of the 8 seed windows _map_reads_both probes in a 150-base read
# (forward offsets 0/17/34/51 and their reverse-complement counterparts):
# a read with all eight substituted maps only through --rescue
SEED_MIDDLES = (7, 24, 41, 58, 91, 108, 125, 142)
VS_REF_TIMED_READS = 1_000
ACGT = np.frombuffer(b"ACGT", np.uint8)
BASE_CODE = np.zeros(256, np.int64)
BASE_CODE[ACGT] = [0, 1, 2, 3]
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[ACGT] = np.frombuffer(b"TGCA", np.uint8)

def substitute(rng, bases: np.ndarray) -> np.ndarray:
    """Each ACGT byte replaced by one of the three others."""
    shift = rng.integers(1, 4, bases.shape)
    return ACGT[(BASE_CODE[bases] + shift) % 4]


def plant_variants(rng, ref: np.ndarray, n_snp: int, n_del: int, n_ins: int):
    """(donor, donor_to_ref, truth): ``ref`` with SNPs and 1-10-base
    deletions and insertions at sites >= 40 bases apart. donor_to_ref[k]
    is the reference index of donor base k (-1 inside an insertion); truth
    is ([(pos, alt)], [deletion pos], [insertion pos], {insertion pos:
    inserted bases}), where a deletion sits at its first deleted base and
    an insertion at the base after it, as the pileup's evidence columns
    count them."""
    n = n_snp + n_del + n_ins
    sites = np.sort(rng.choice(np.arange(200, ref.size - 200, 40), n,
                               replace=False))
    kinds = rng.permutation(np.repeat([0, 1, 2], [n_snp, n_del, n_ins]))
    pieces, maps, snps, dels, ins, ins_bases = [], [], [], [], [], {}
    at = 0
    for site, kind in zip(sites.tolist(), kinds.tolist()):
        pieces.append(ref[at:site])
        maps.append(np.arange(at, site))
        if kind == 0:
            alt = substitute(rng, ref[site:site + 1])
            pieces.append(alt)
            maps.append(np.array([site]))
            snps.append((site, chr(int(alt[0]))))
            at = site + 1
        elif kind == 1:
            dels.append(site)
            at = site + int(rng.integers(1, 11))
        else:
            k = int(rng.integers(1, 11))
            pieces.append(rng.choice(ACGT, k))
            maps.append(np.full(k, -1))
            ins.append(site)
            ins_bases[site] = pieces[-1].tobytes()
            at = site
    pieces.append(ref[at:])
    maps.append(np.arange(at, ref.size))
    return (np.concatenate(pieces), np.concatenate(maps),
            (snps, dels, ins, ins_bases))


def sample_reads(rng, donors: list, n: int) -> dict:
    """n reads of VP_READ_LEN from the donors (a contig by its length), half
    reverse-complemented, VP_ERR substitutions, VP_LOWQ of the quality
    bytes at Q2 ('#', else Q37 'F'), and VP_TARGETS of the reads with all
    eight probed seeds killed. Returns the arrays and, per read, its contig
    and planted reference start (-1 when it starts inside an insertion)."""
    L = VP_READ_LEN
    sizes = np.array([d.size for d, _ in donors], np.float64)
    contig = rng.choice(len(donors), n, p=sizes / sizes.sum())
    seqs = np.empty((n, L), np.uint8)
    start = np.empty(n, np.int64)
    for c, (donor, to_ref) in enumerate(donors):
        rows = np.nonzero(contig == c)[0]
        s = rng.integers(0, donor.size - L, rows.size)
        seqs[rows] = donor[s[:, None] + np.arange(L)[None, :]]
        start[rows] = to_ref[s]
    err = rng.random((n, L)) < VP_ERR
    seqs[err] = substitute(rng, seqs[err])
    rev = rng.random(n) < 0.5
    seqs[rev] = COMPLEMENT[seqs[rev]][:, ::-1]
    targets = np.sort(rng.choice(n, int(n * VP_TARGETS), replace=False))
    for m in SEED_MIDDLES:
        seqs[targets, m] = substitute(rng, seqs[targets, m])
    quals = np.full((n, L), ord("F"), np.uint8)
    quals[rng.random((n, L)) < VP_LOWQ] = ord("#")
    return {"seqs": seqs, "quals": quals, "contig": contig, "start": start,
            "targets": targets}


def write_lane(path: str, reads: dict) -> None:
    seqs, quals = reads["seqs"], reads["quals"]
    text = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), q.tobytes())
                    for i, (s, q) in enumerate(zip(seqs, quals)))
    with open(path, "wb") as f:
        f.write(gzip.compress(text, compresslevel=1))


def phase_variant_fixtures(rng, tmp: str) -> dict:
    """The reference FASTA, the donor's truth, and four lanes: two of
    VP_LANE_READS (the sample), one of VP_SMALL_READS and one of
    VP_EXACT_READS."""
    from mini_parallel_tpu_torch.io import fasta

    t0 = time.perf_counter()
    total = sum(length for _, length in VP_CONTIGS)
    contigs, donors, truth = {}, [], []
    for name, length in VP_CONTIGS:
        ref = rng.choice(ACGT, length)
        share = length / total
        donor, to_ref, planted = plant_variants(
            rng, ref, round(VP_SNPS * share), round(VP_DELS * share),
            round(VP_INS * share))
        contigs[name] = ref.tobytes()
        donors.append((donor, to_ref))
        truth.append(planted)
    fx = {"contigs": contigs, "ref": os.path.join(tmp, "ref.fa"),
          "names": [name for name, _ in VP_CONTIGS],
          "snps": {(VP_CONTIGS[c][0], p, alt) for c, t in enumerate(truth)
                   for p, alt in t[0]},
          "indels": [(VP_CONTIGS[c][0], p, tag) for c, t in enumerate(truth)
                     for tag, sites in (("<DEL>", t[1]), ("<INS>", t[2]))
                     for p in sites],
          "ins_bases": {(VP_CONTIGS[c][0], p): b for c, t in enumerate(truth)
                        for p, b in t[3].items()}}
    fasta.write_fasta(fx["ref"], contigs)
    for key, n in (("L1", VP_LANE_READS), ("L2", VP_LANE_READS),
                   ("small", VP_SMALL_READS), ("exact", VP_EXACT_READS)):
        reads = sample_reads(rng, donors, n)
        path = os.path.join(tmp, f"VP_{key}.fastq.gz")
        write_lane(path, reads)
        fx[key] = path
        fx[f"{key}_reads"] = {k: reads[k] for k in ("contig", "start",
                                                    "targets")}
    G = total + 512 * (len(VP_CONTIGS) - 1)
    print(f"[9 fixtures] reference {' + '.join(f'{n} {l}' for n, l in VP_CONTIGS)}"
          f" bases (G = {G} with the spacer); {len(fx['snps'])} SNPs, "
          f"{len(fx['indels'])} indels planted; lanes {VP_LANE_READS} x 2, "
          f"{VP_SMALL_READS}, {VP_EXACT_READS} reads of {VP_READ_LEN} bp: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return fx


def time_once(fn):
    """(CUDA-event ms of one call, its result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def real_chunk(eng, path: str, device) -> dict:
    """The first CHUNK_READS reads of a lane mapped by the engine's own
    steps: the mapped codes, anchors and quality mask (the engine's
    ``min_base_quality``, turned with the reads mapped reversed), the
    gapped traceback's operands (queries, windows) and the --rescue
    kernel's operand (the forward queries and their reverse complements as
    one (2B, M) batch, every mapped read blanked to pad)."""
    import torch

    from mini_parallel_tpu_torch.io import fastq
    from mini_parallel_tpu_torch.models import variant_prep as vp
    from mini_parallel_tpu_torch.ops import encode

    chunks = fastq.iter_flat_chunks_with_quals(path, CHUNK_READS)
    flat, offs, qflat, qoffs = next(chunks)
    chunks.close()
    arr, lens, pad = eng._prep_batch_flat(flat, offs)
    qual_ok = torch.from_numpy(eng._qual_mask_flat(qflat, qoffs, pad)
                               ).to(device)
    lens = torch.from_numpy(np.asarray(lens, np.int32)).to(device)
    idx = eng.index
    codes, starts, mapped, flipped = vp._map_codes_batch(
        encode.ascii_to_code(torch.from_numpy(arr).to(device)), lens,
        idx.sorted_keys, idx.sorted_pos, idx.ref_ascii_dev, vp.SEED_K, False,
        eng.rescue_min_frac)
    G = len(idx.ref_codes)
    queries, windows, _ = vp._gapped_operands(
        codes, lens, starts, mapped, idx.ref_ascii_dev, G,
        pad + 2 * eng.window_margin, eng.window_margin)
    both = torch.cat([codes, vp._revcomp_codes(codes, lens)])
    qual_ok = torch.where(flipped[:, None], vp._reverse_prefix(qual_ok, lens),
                          qual_ok)
    return {"codes": codes, "starts": starts, "qual_ok": qual_ok,
            "queries": queries, "windows": windows, "lens": lens,
            "mapped": mapped,
            "rescue": vp._codes_to_ascii(both, lens.repeat(2),
                                         keep=(~mapped).repeat(2))}


def phase_vs_ref_compare(rng, eng, fx: dict, chunk: dict, device) -> dict:
    """csrc/sw_vs_ref.cu == plain sw_vs_ref_batch on the card, exactly: 256
    reads against 20,000 bases (a repeat, all-pad and all-N rows), rows
    past one stripe (M = 300), 8 rescue targets at full length (both
    strands; also == the strip engine, and the anchor == the planted
    start), and a real --rescue chunk against the whole reference (timed,
    the plain version once)."""
    import torch

    from mini_parallel_tpu_torch.ops import encode, sw, sw_cuda, sw_long

    ref_full = eng.index.ref_ascii_dev
    G = ref_full.numel()
    chr_ref = np.frombuffer(fx["contigs"]["chr"], np.uint8)
    out = {"max_err": 0}

    def compare(name, reads, ref, segment=0):
        got = sw_cuda.sw_vs_ref_batch_cuda(reads, ref, segment)
        plain_ms, want = time_once(lambda: sw.sw_vs_ref_batch(reads, ref))
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        out["max_err"] = max(out["max_err"], err)
        live = int((reads != int(encode.PAD_A)).any(dim=1).sum())
        print(f"[10 vs-ref] {name}: B={reads.shape[0]} ({live} swept) M="
              f"{reads.shape[1]} N={ref.numel()} kernel==plain "
              f"{err == 0} max_abs_err {err} max_score {int(got[0].max())} | "
              f"plain {plain_ms:.1f} ms", flush=True)
        check(err == 0, f"vs-ref kernel != plain on {name}")
        return got, plain_ms

    for name, (B, M, N) in (("20,000-base reference", (256, 152, 20_000)),
                            ("rows past one stripe", (9, 300, 4_000))):
        ref = chr_ref[:N].copy()
        ref[N // 2:N // 2 + 60] = ref[100:160]  # a repeat: equal ends
        ref[N // 3:N // 3 + 30] = ord("N")
        rows = []
        for k in range(B):
            n = int(rng.integers(1, M + 1))
            s = int(rng.integers(0, N - n))
            cut = ref[s:s + n].copy()
            cut[rng.random(n) < 0.03] = ord("A")
            rows.append([b"", b"N" * n, cut.tobytes(),
                         ref[100:100 + min(n, 60)].tobytes(),
                         COMPLEMENT[cut][::-1].tobytes()][k % 5])
        reads = padded(rows, M, int(encode.PAD_A), device)
        (scores, ends), _ = compare(name, reads,
                                    torch.from_numpy(ref).to(device))
        check(int(scores[0]) == 0 and int(ends[0]) == -1,
              "an all-pad read must give (0, -1)")
    compare_segments(rng, chr_ref, compare, device)

    # 8 rescue targets cut from the reference, 4 of them reverse-complemented
    starts = np.sort(rng.integers(1_000, chr_ref.size - 1_000, 8))
    fwd, planted = [], []
    for k, s in enumerate(starts.tolist()):
        r = chr_ref[s:s + VP_READ_LEN].copy()
        r[list(SEED_MIDDLES)] = substitute(rng, r[list(SEED_MIDDLES)])
        fwd.append(r.tobytes() if k % 2 == 0 else
                   COMPLEMENT[r][::-1].tobytes())
        planted.append(s)
    rcs = [COMPLEMENT[np.frombuffer(r, np.uint8)][::-1].tobytes() for r in fwd]
    both = padded(fwd + rcs, 152, int(encode.PAD_A), device)
    (scores, ends), _ = compare("8 rescue targets x 2 strands, whole "
                                "reference", both, ref_full)
    ref_np = eng.index.ref_ascii_dev.cpu().numpy()
    anchors = []
    for k in range(8):
        s_f, s_r = int(scores[k]), int(scores[8 + k])
        # rows along the reference: one strip of the read's width
        strips = [sw_long.sw_score_long(ref_np, np.frombuffer(r, np.uint8),
                                        device) for r in (fwd[k], rcs[k])]
        check([s_f, s_r] == strips,
              f"target {k}: vs-ref {[s_f, s_r]} != strip engine {strips}")
        end = int(ends[8 + k]) if s_r > s_f else int(ends[k])
        anchors.append(end - VP_READ_LEN + 1)
    print(f"[10 vs-ref] the 8 targets' scores == sw_score_long (strip "
          f"engine) on both strands; anchors {anchors}, planted {planted}",
          flush=True)
    check(anchors == planted, "a rescued anchor is not its planted start")

    got, plain_ms = compare("a --rescue chunk of lane 1 (mapped reads "
                            "blanked)", chunk["rescue"], ref_full)
    kernel = time_samples(
        lambda: sw_cuda.sw_vs_ref_batch_cuda(chunk["rescue"], ref_full),
        repeats=3)
    live = (chunk["rescue"] != int(encode.PAD_A)).any(dim=1)
    cells = float(chunk["lens"].repeat(2)[live].sum()) * G
    rows = chunk["rescue"].shape[0]
    out.update(
        ms=report_time(12, f"sw_vs_ref kernel, a --rescue chunk ({int(live.sum())}"
                       f" of {rows} rows swept, both strands) x G = {G}",
                       kernel, cells),
        plain_ms=plain_ms, cells=cells,
        bytes=float(chunk["rescue"].numel() + G + 8 * rows))
    print(f"[12 time] sw_vs_ref plain, the same chunk, once: {plain_ms:.1f} ms "
          f"({cells / plain_ms / 1e6:.1f} GCUPS)", flush=True)
    many = padded([chr_ref[s:s + VP_READ_LEN].tobytes() for s in
                   rng.integers(0, chr_ref.size - VP_READ_LEN,
                                VS_REF_TIMED_READS)],
                  152, int(encode.PAD_A), device)
    report_time(12, f"sw_vs_ref kernel, {VS_REF_TIMED_READS} reads x G = {G}",
                time_samples(lambda: sw_cuda.sw_vs_ref_batch_cuda(many, ref_full),
                             repeats=3),
                float(VS_REF_TIMED_READS) * VP_READ_LEN * G)
    return out


def compare_segments(rng, chr_ref: np.ndarray, compare, device) -> None:
    """The vs-reference kernel's segment split at narrow segment widths
    (and its default) == plain sw_vs_ref_batch (through ``compare``) ==
    the plain segment mirror: a read twice in a 1,001-base reference
    (equal best in two segments: the smaller end must win), a copy with a
    3-base gap across column 256, all-pad and all-N reads, and rows past
    one stripe (M = 300); 1,001 is no multiple of any segment."""
    import torch

    from mini_parallel_tpu_torch.ops import encode, sw

    ref = chr_ref[:1001].copy()
    read = ref[100:120].copy()
    ref[700:720] = read
    ref[400:430] = ord("N")
    copy = ref[226:286].copy()
    edge_rows = [read.tobytes(), b"", np.concatenate([copy[:25], copy[28:]]
                                                     ).tobytes(),
                 b"N" * 20, read[:7].tobytes()]
    stripe_rows = []
    for k in range(9):
        n = int(rng.integers(1, 301))
        s = int(rng.integers(0, ref.size - n))
        stripe_rows.append([ref[s:s + n].tobytes(), b"", b"N" * n][k % 3])
    tref = torch.from_numpy(ref).to(device)
    for segment in (16, 32, 48, 0):
        for name, rows, M in (("a tie in two segments, a gapped copy "
                               "across column 256, all-pad, all-N",
                               edge_rows, 64),
                              ("rows past one stripe", stripe_rows, 300)):
            reads = padded(rows, M, int(encode.PAD_A), device)
            (scores, ends), _ = compare(
                f"segments of {segment or 'the default'} columns: {name}",
                reads, tref, segment)
            mirror = sw.sweep_segments(reads.cpu(), tref.cpu(), segment or 64)
            same = all(torch.equal(g.cpu(), m) for g, m in
                       zip((scores, ends), mirror))
            check(same, f"vs-ref kernel != the segment mirror on {name}")
            if rows is edge_rows:
                check((int(scores[0]), int(ends[0])) == (40, 119),
                      f"the tie across segments gave ({int(scores[0])}, "
                      f"{int(ends[0])}), not (40, 119)")
    print("[10 vs-ref] every segment case == the plain segment mirror; the "
          "tie across segments keeps the smaller end (40, 119)", flush=True)


def moves_pairs(rng, B: int, M: int, N: int, device):
    """Reads cut from their windows with substitutions and a 3-base gap,
    unrelated reads and empty reads."""
    from mini_parallel_tpu_torch.ops import encode

    rows_a, rows_b = [], []
    for k in range(B):
        win = rng.choice(ACGT, N)
        n = int(rng.integers(1, min(M, N - 8) + 1))
        s = int(rng.integers(0, N - n))
        read = win[s:s + n].copy()
        read[rng.random(n) < 0.05] = ord("T")
        read = np.concatenate([read[:n // 2], read[n // 2 + 3:]])
        rows_a.append([read.tobytes(), b"", rng.choice(ACGT, n).tobytes(),
                       read.tobytes()][k % 4])
        rows_b.append(win.tobytes())
    return pair_batch(rows_a, rows_b, M, N, device)


def phase_moves_compare(rng, chunk: dict, gaps: tuple, device) -> dict:
    """csrc/sw_moves.cu == the plain scans and walks on the card, exactly,
    linear and affine: best, bd, bi, positions and the move of every cell,
    on a real --gapped chunk (10,000 x 152 against 184-base windows, every
    pair's moves in shared memory), a ragged batch whose last block has one
    pair, a batch of one, and the two cases whose moves go to device
    memory: rows past one stripe (M = 300) and 1,500-base windows. Times
    each kernel on the chunk and each plain version once."""
    import torch

    from mini_parallel_tpu_torch.ops import encode
    from mini_parallel_tpu_torch.ops import sw_traceback as tb
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    q, w = chunk["queries"], chunk["windows"]
    cases = {"a --gapped chunk of lane 1 (moves in shared memory)":
                 (q, w, gaps),
             "ragged B=33 M=37 N=50 (a last block of one pair)": (
                 *moves_pairs(rng, 33, 37, 50, device), (-3, -1)),
             "a batch of one B=1 M=152 N=184": (
                 *moves_pairs(rng, 1, 152, 184, device), gaps),
             "rows past one stripe B=21 M=300 N=200 (moves in device "
             "memory)": (*moves_pairs(rng, 21, 300, 200, device), (-3, 0)),
             "windows too long for shared memory B=3 M=200 N=1500": (
                 *moves_pairs(rng, 3, 200, 1500, device), (-2, -1))}
    out = {"max_err": 0}
    for name, (a, b, (go, ge)) in cases.items():
        for label, kernel, plain, walk, args in (
                ("linear", tbc.sw_moves_batch_cuda, tb.sw_moves_batch,
                 tb._positions_walk, ()),
                ("affine", tbc.sw_affine_moves_batch_cuda,
                 tb.sw_affine_moves_batch, tb._affine_walk, (go, ge))):
            got = kernel(a, b, *args, return_moves=True)
            best, bd, bi, moves = plain(a, b, *args)
            pos = walk(best, bd, bi, moves)
            torch.cuda.synchronize()
            err = max(int((g.long() - x.long()).abs().max())
                      for g, x in zip(got[:4], (best, bd, bi, pos)))
            cells_equal = torch.equal(
                tbc.moves_to_cells(got[4], a.shape[1], b.shape[1],
                                   label == "affine"),
                tb.plain_moves_to_cells(moves, b.shape[1]))
            out["max_err"] = max(out["max_err"], err, int(not cells_equal))
            aligned = int((pos >= 0).sum())
            print(f"[11 moves] {label} {name}{f' ({go}, {ge})' if args else ''}:"
                  f" B={a.shape[0]} M={a.shape[1]} N={b.shape[1]} best, bd, "
                  f"bi, positions kernel==plain {err == 0} (max_abs_err "
                  f"{err}); every cell's move equal {cells_equal}; "
                  f"{aligned} aligned bases", flush=True)
            check(err == 0 and cells_equal,
                  f"{label} moves kernel != plain on {name}")

    mapped_bases = float(chunk["lens"][chunk["mapped"]].sum())
    cells = mapped_bases * w.shape[1]
    B, M, N = q.shape[0], q.shape[1], w.shape[1]
    nbytes = float(B * M + B * N + 12 * B + 4 * B * M)
    for key, kernel, plain, args in (
            ("sw_moves", tbc.sw_moves_batch_cuda, tb.sw_positions_batch, ()),
            ("sw_affine_moves", tbc.sw_affine_moves_batch_cuda,
             tb.sw_affine_positions_batch, gaps)):
        ms = report_time(12, f"{key} kernel, the --gapped chunk {B} x {M} vs "
                         f"{N}", time_samples(lambda: kernel(q, w, *args), 5),
                         cells)
        plain_ms, _ = time_once(lambda: plain(q, w, *args))
        print(f"[12 time] {key} plain (scan + walk), the same chunk, once: "
              f"{plain_ms:.1f} ms ({cells / plain_ms / 1e6:.1f} GCUPS)",
              flush=True)
        out[key] = {"ms": ms, "plain_ms": plain_ms, "cells": cells,
                    "bytes": nbytes}
    return out


def phase_pileup_compare(eng, chunk: dict, gaps: tuple, device) -> dict:
    """csrc/pileup.cu == the plain torch route on the card, exactly, at the
    main path's chunk: the real --gapped chunk's affine traceback positions
    (10,000 x 152), without a quality mask (the engine's default) and with
    the chunk's --min-base-quality mask. Each call is one launch into a
    zero accumulator whose trash slot stays 0. Times the kernel, the plain
    route and the plain route's ``index_add_`` alone (the library's
    scatter) on each, and counts the bytes a call needs: its inputs once,
    and each 32-byte sector of the accumulator that takes a count, read
    and written once (a floor: a sector evicted between two of its adds is
    read again)."""
    import torch

    from mini_parallel_tpu_torch.models import variant_prep as vp
    from mini_parallel_tpu_torch.ops import pileup_cuda

    run = pileup_cuda.pileup_positions_cuda
    idx = eng.index
    G = len(idx.ref_codes)
    codes, lens, mapped = chunk["codes"], chunk["lens"], chunk["mapped"]
    B, L = codes.shape
    positions = vp._traceback_positions(
        codes, lens, chunk["starts"], mapped, idx.ref_ascii_dev, G,
        L + 2 * eng.window_margin, eng.window_margin, "affine", *gaps)
    out = {"max_err": 0}
    for key, label, qual_ok in (
            ("unmasked", "no quality mask", None),
            ("masked", f"--min-base-quality {eng.min_base_quality}",
             chunk["qual_ok"])):
        got, want = vp._new_pileup(G, device), vp._new_pileup(G, device)
        launches = run.launches
        run(codes, positions, G, qual_ok, got)
        bins = vp._pileup_bins(codes, positions, G, qual_ok)
        ones = torch.ones(bins.shape[0], dtype=torch.int32, device=device)
        want.index_add_(0, bins, ones)
        torch.cuda.synchronize()
        err = int((got[:-1] - want[:-1]).abs().max())
        trash = int(got[-1])
        events = int(got[:-1].sum())
        sectors = int((got[:-1].nonzero().squeeze(1) // 8)
                      .unique_consecutive().numel())  # 8 int32 a sector
        nbytes = float(B * L * (1 + positions.element_size()
                                + (qual_ok is not None)) + 64 * sectors)
        out["max_err"] = max(out["max_err"], err, trash)
        print(f"[11 pileup] {label}, the --gapped chunk {B} x {L} "
              f"({positions.dtype} positions): kernel == plain {err == 0} "
              f"(max_abs_err {err}), trash slot {trash}, launches "
              f"{run.launches - launches}; {events} counts of {bins.numel()} "
              f"plain entries ({int((bins == G * 7).sum())} to the trash "
              f"slot), {sectors} sectors touched", flush=True)
        check(err == 0 and trash == 0 and run.launches == launches + 1,
              f"pileup kernel != plain on the --gapped chunk, {label}")
        scratch = vp._new_pileup(G, device)
        ms = statistics.median(time_samples(
            lambda: run(codes, positions, G, qual_ok, scratch), 20))
        plain_ms = statistics.median(time_samples(
            lambda: vp._pileup_positions_plain(codes, positions, G, qual_ok,
                                               scratch), 1, 3))
        library_ms = statistics.median(time_samples(
            lambda: scratch.index_add_(0, bins, ones), 1, 5))
        print(f"[12 time] pileup, {label}: kernel {ms:.4f} ms (median of "
              f"{REPEATS}), plain route {plain_ms:.4f} ms, its index_add_ "
              f"alone {library_ms:.4f} ms; bytes {nbytes:.0f} (inputs "
              f"{nbytes - 64 * sectors:.0f}, sectors {64 * sectors})",
              flush=True)
        out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bytes": nbytes}
    return out


ALIGN_INPUTS = ((CHUNK_READS, 152, 184, 6), (64, 300, 700, 3))  # B M N golden


def phase_align(rng, gaps: tuple, device) -> None:
    """sw_align_batch and sw_affine_align_batch on the card (the moves
    kernel with its moves out, the words walked on the host): on
    moves_pairs at the --gapped chunk's 10,000 x 152 x 184 (moves in
    shared memory) and at 64 x 300 x 700 (device memory), every Alignment
    == the plain CPU route's, and == the golden on a sample; the kernel
    launched once a call (counts zeroed just before, read just after).
    Times: the kernel with and without return_moves (CUDA events), the
    host copy of the words, the host walk; the call's peak card memory."""
    import dataclasses

    import torch

    from mini_parallel_tpu_torch.ops import encode
    from mini_parallel_tpu_torch.ops import sw_traceback as tb
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    def fields(alns):
        return [dataclasses.astuple(x) for x in alns]

    for B, M, N, n_golden in ALIGN_INPUTS:
        a, b = moves_pairs(rng, B, M, N, device)
        a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
        for key, kernel, align, golden, args in (
                ("sw_moves", tbc.sw_moves_batch_cuda, tb.sw_align_batch,
                 tb.sw_align_numpy, ()),
                ("sw_affine_moves", tbc.sw_affine_moves_batch_cuda,
                 tb.sw_affine_align_batch, tb.sw_affine_align_numpy, gaps)):
            affine = bool(args)
            kernel.launches = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            got = align(a, b, *args)
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - base
            launches = kernel.launches
            check(launches == 1, f"{key}: sw_align_batch launched "
                  f"{launches} kernels on {B} x {M} x {N}")
            t = time.perf_counter()
            plain = align(a.cpu(), b.cpu(), *args)
            plain_s = time.perf_counter() - t
            check(fields(got) == fields(plain),
                  f"{key}: card Alignments != the plain CPU route's at "
                  f"{B} x {M} x {N}")
            sample = [int(p) for p in np.linspace(0, B - 1, n_golden)]
            for p in sample:
                want = golden(a_np[p][a_np[p] != encode.PAD_A].tobytes(),
                              b_np[p][b_np[p] != encode.PAD_B].tobytes(),
                              *args)
                check(fields([got[p]]) == fields([want]),
                      f"{key}: pair {p} != the golden at {B} x {M} x {N}")
            cells = float(B) * M * N
            bare = report_time(12, f"{key} kernel, positions only, {B} x {M}"
                               f" vs {N}", time_samples(
                                   lambda: kernel(a, b, *args), 5), cells)
            moves = report_time(12, f"{key} kernel, return_moves, {B} x {M} "
                                f"vs {N}", time_samples(
                                    lambda: kernel(a, b, *args,
                                                   return_moves=True), 5),
                                cells)
            best, bd, bi, _, words = kernel(a, b, *args, return_moves=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            host = words.cpu().numpy()
            fetch_s = time.perf_counter() - t
            best, bd, bi = (x.cpu().numpy() for x in (best, bd, bi))
            t = time.perf_counter()
            walked = tb.traceback_words_host(best, bd, bi, host, M, N, affine)
            walk_s = time.perf_counter() - t
            check(fields(walked) == fields(got), f"{key}: re-walk differs")
            aligned = sum(x.score > 0 for x in got)
            print(f"[12 align] {key} sw_align_batch {B} x {M} vs {N}"
                  f"{f' {args}' if args else ''}: 1 launch; card == plain "
                  f"CPU route on {B} pairs ({aligned} aligned), == golden on "
                  f"{n_golden}; kernel {bare:.4f} ms, with return_moves "
                  f"{moves:.4f} ms; words host copy "
                  f"{1e3 * fetch_s:.2f} ms ({host.nbytes} bytes); host walk "
                  f"{1e3 * walk_s:.2f} ms ({1e6 * walk_s / B:.1f} us a pair);"
                  f" whole call {1e3 * wall:.2f} ms, card memory {peak} "
                  f"bytes at its peak; plain CPU route {1e3 * plain_s:.1f} ms",
                  flush=True)


def vcf_calls(path: str) -> set:
    calls = set()
    with open(path) as f:
        for line in f:
            if not line.startswith("#"):
                c = line.split("\t")
                calls.add((c[0], int(c[1]) - 1, c[4]))
    return calls


def indel_recall(calls: set, indels: list, slack: int = 10) -> float:
    """The share of planted indels with a call of their kind within
    ``slack`` bases (a gap's placement in a repeat is ambiguous)."""
    at = {}
    for contig, pos, alt in calls:
        at.setdefault((contig, alt), []).append(pos)
    hit = 0
    for contig, pos, tag in indels:
        near = np.sort(at.get((contig, tag), []))
        k = np.searchsorted(near, pos - slack)
        hit += k < near.size and near[k] <= pos + slack
    return hit / max(len(indels), 1)


def sam_records(path: str) -> list[list[str]]:
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f if not ln.startswith("@")]


def phase_variant_paths(fx: dict, env_path: str, tmp: str, device) -> dict:
    """--variant-prep through cli.main at the full configuration: the
    two-lane sample ungapped, --gapped and --gapped --gap-model affine
    (SNP recall >= 95%, indel recall printed); --rescue --sam-out on the
    small lane (one record per read, >= 90% of the rescue targets mapped);
    --min-base-quality 10 (no depth above the unmasked run's); a
    checkpoint resumed through the CLI to the clean run's pileup; and the
    exact lane on the card == on the CPU (pileup, candidates, SAM bytes).
    Each path's kernel counts are set to 0 just before it and read just
    after."""
    import torch

    from mini_parallel_tpu_torch.models import variant_prep as vp
    from mini_parallel_tpu_torch.ops import pileup_cuda, sw_cuda
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc
    from mini_parallel_tpu_torch.utils.config import Config

    report_engine(13)
    counters = {"sw_vs_ref": sw_cuda.sw_vs_ref_batch_cuda,
                "sw_moves": tbc.sw_moves_batch_cuda,
                "sw_affine_moves": tbc.sw_affine_moves_batch_cuda,
                "pileup": pileup_cuda.pileup_positions_cuda}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in counters.items()}

    base = ["--reference", fx["ref"], "--env", env_path]
    sample = f"{fx['L1']},{fx['L2']}"
    n_sample = 2 * VP_LANE_READS
    chunks = 2 * -(-VP_LANE_READS // CHUNK_READS)
    launches = {}
    for mode, extra, kernel in (
            ("ungapped", [], None),
            ("gapped linear", ["--gapped"], "sw_moves"),
            ("gapped affine", ["--gapped", "--gap-model", "affine"],
             "sw_affine_moves")):
        vcf = os.path.join(tmp, f"vp_{mode.replace(' ', '_')}.vcf")
        zero()
        lines, wall = cli_lines(["--variant-prep", sample, *base, *extra,
                                 "--vcf-out", vcf])
        n = counts()
        calls = vcf_calls(vcf)
        snp = len(fx["snps"] & calls) / len(fx["snps"])
        indel = indel_recall(calls, fx["indels"])
        print(f"[13 variant-prep {mode}] {line_value(lines, 'Reads:')} | "
              f"{n_sample / wall:.0f} reads/s ({wall:.2f} s) | "
              f"{line_value(lines, 'Candidate variant sites:')} candidates, "
              f"SNP recall {100 * snp:.2f} %, indel recall {100 * indel:.2f} "
              f"% | launches {n}", flush=True)
        check(snp >= 0.95, f"{mode}: SNP recall {snp:.4f} < 0.95")
        check(n["sw_vs_ref"] == 0, f"{mode} launched the rescue kernel")
        check(n["pileup"] == chunks, f"{mode}: {n['pileup']} pileup "
              f"launches for {chunks} chunks")
        launches["pileup"] = n["pileup"]  # the same in every mode
        if kernel:
            launches[kernel] = n[kernel]
            check(n[kernel] == chunks, f"{mode}: {n[kernel]} launches for "
                  f"{chunks} chunks")
        else:
            check(n["sw_moves"] == n["sw_affine_moves"] == 0,
                  "ungapped mode launched a traceback kernel")

    small = fx["small"]
    sam = os.path.join(tmp, "vp_small.sam")
    zero()
    lines, wall = cli_lines(["--variant-prep", small, *base, "--gapped",
                             "--rescue", "--sam-out", sam])
    n = counts()
    launches["sw_vs_ref"] = n["sw_vs_ref"]
    recs = sam_records(sam)
    info = fx["small_reads"]
    targets = info["targets"]
    mapped = np.array([not int(r[1]) & 4 for r in recs])
    names = fx["names"]
    at_start = sum(mapped[t] and recs[t][2] == names[info["contig"][t]]
                   and int(recs[t][3]) - 1 == info["start"][t]
                   for t in targets.tolist())
    rate = float(mapped[targets].mean()) if len(recs) == VP_SMALL_READS else 0
    small_chunks = -(-VP_SMALL_READS // CHUNK_READS)
    print(f"[13 rescue] --gapped --rescue --sam-out, {VP_SMALL_READS} reads: "
          f"{line_value(lines, 'Reads:')} | {len(recs)} SAM records | "
          f"rescue targets mapped {int(mapped[targets].sum())}/"
          f"{targets.size} ({100 * rate:.2f} %), {at_start} at their planted "
          f"start | launches {n} | {wall:.2f} s", flush=True)
    check(len(recs) == VP_SMALL_READS, "--sam-out wrote not one record per read")
    check(rate >= 0.9, f"--rescue mapped {rate:.4f} < 0.9 of its targets")
    check(n["sw_vs_ref"] == n["sw_moves"] == n["pileup"] == small_chunks,
          f"--rescue launches {n} for {small_chunks} chunks")

    cfg = Config(chunk_size_reads=CHUNK_READS)
    contigs = fx["contigs"]
    clean = vp.VariantPrepEngine(contigs, cfg, gapped=True,
                                 device=device).process_file(small)
    masked = vp.VariantPrepEngine(contigs, cfg, gapped=True,
                                  min_base_quality=10,
                                  device=device).process_file(small)
    depth0, depth1 = clean.pileup[:, :4].sum(1), masked.pileup[:, :4].sum(1)
    print(f"[13 min-base-quality] --min-base-quality 10 on {VP_SMALL_READS} "
          f"reads: bases in the pileup {int(depth1.sum())} of "
          f"{int(depth0.sum())}, {int((depth1 > depth0).sum())} sites above "
          f"the unmasked depth | mapped {masked.mapped_reads} == "
          f"{clean.mapped_reads}", flush=True)
    check(bool((depth1 <= depth0).all()) and depth1.sum() < depth0.sum(),
          "the quality mask raised a depth or masked nothing")
    check(masked.mapped_reads == clean.mapped_reads,
          "the quality mask changed the mapping")

    ckpt = os.path.join(tmp, "vp_small.npz")

    def crash_after_five(line, seen=[]):  # noqa: B006 (a per-run count)
        seen.append(line)
        if len(seen) == 5:
            raise KeyboardInterrupt("a crash after chunk 5")

    try:
        vp.VariantPrepEngine(contigs, cfg, gapped=True, device=device
                             ).process_file(small, progress=crash_after_five,
                                            checkpoint_path=ckpt,
                                            checkpoint_every=2)
    except KeyboardInterrupt:
        pass
    zero()
    lines, _ = cli_lines(["--variant-prep", small, *base, "--gapped",
                          "--prep-checkpoint", ckpt,
                          "--prep-checkpoint-every", "2"])
    n = counts()
    with np.load(ckpt) as z:
        resumed = z["pileup"]
        meta = json.loads(str(z["meta"]))
    same = bool(np.array_equal(resumed, clean.pileup))
    print(f"[13 checkpoint] crashed after chunk 5 (snapshot at 4), resumed "
          f"through the CLI: {n['sw_moves']} traceback launches for the "
          f"{small_chunks - 4} chunks left, pileup == the clean run's {same}, "
          f"mapped {meta['mapped_reads']} == {clean.mapped_reads}", flush=True)
    check(n["sw_moves"] == n["pileup"] == small_chunks - 4,
          "the CLI did not resume at chunk 4")
    check(same and meta["mapped_reads"] == clean.mapped_reads
          and meta["chunks_done"] == small_chunks,
          "the resumed pileup differs from the clean run's")
    check(line_value(lines, "Reads:").startswith(f"{VP_SMALL_READS}, mapped: "
                                                 f"{clean.mapped_reads} "),
          "the resumed CLI run printed other counts")

    for gap_model in ("linear", "affine"):
        runs = []
        for k, dev in enumerate((device, torch.device("cpu"))):
            sam = os.path.join(tmp, f"vp_exact_{gap_model}_{k}.sam")
            res = vp.VariantPrepEngine(contigs, cfg, gapped=True,
                                       gap_model=gap_model, device=dev
                                       ).process_file(fx["exact"], sam_out=sam)
            with open(sam, "rb") as f:
                runs.append((res, f.read()))
        (g, gsam), (c, csam) = runs
        same = (np.array_equal(g.pileup, c.pileup)
                and g.candidates == c.candidates and gsam == csam
                and g.mapped_reads == c.mapped_reads)
        print(f"[13 exact] {gap_model}, {VP_EXACT_READS} reads: card == CPU "
              f"plain versions (pileup, {len(g.candidates)} candidates, "
              f"{len(gsam)} SAM bytes, {g.mapped_reads} mapped): {same}",
              flush=True)
        check(same, f"{gap_model}: the card's variant prep != the CPU's")
    return launches


# ---------------------------------------------------------------------------
# Genotyping (--genotype): csrc/pairhmm.cu in float32 and float64; the
# roofline probe: csrc/roofline.cu
# ---------------------------------------------------------------------------

PHMM_SAMPLE = 20_000  # lanes of the real operand held against the plain version


def vcf_records(path: str) -> list[list[str]]:
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f if not ln.startswith("#")]


def phase_genotype(fx: dict, env_path: str, device) -> dict:
    """--variant-prep --gapped --gap-model affine --genotype through
    cli.main on the two-lane sample at the defaults (window 50, 64 reads a
    site): lanes scored and recomputed in float64, both Pair-HMM launch
    counts (set to 0 just before, read just after), the genotyping wall
    and sites/s, the share of planted SNPs called 1/1 (held >= 95%: the
    donor is haploid), and, printed only, the share of planted deletions
    with a 1/1 <DEL> call within 10 bases and of planted insertions called
    with their planted bases. Returns the launches and the Pair-HMM
    operand of the run (captured on its way into the batch)."""
    import torch

    from mini_parallel_tpu_torch.models import variant_prep as vp
    from mini_parallel_tpu_torch.ops import pairhmm_cuda

    report_engine(14)
    counters = {"pairhmm": pairhmm_cuda.pairhmm_batch_cuda,
                "pairhmm_f64": pairhmm_cuda.pairhmm_f64_batch_cuda}
    captured, walls = [], []
    batch, genotype = vp.pairhmm_log10_padded, vp.VariantPrepEngine.genotype_candidates

    def capture(*args, **kw):
        captured.append(args)
        return batch(*args, **kw)

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        out = genotype(self, *args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    vcf = os.path.join(os.path.dirname(fx["ref"]), "vp_genotype.vcf")
    vp.pairhmm_log10_padded, vp.VariantPrepEngine.genotype_candidates = (
        capture, timed)
    try:
        for fn in counters.values():
            fn.launches = 0
        lines, wall = cli_lines([
            "--variant-prep", f"{fx['L1']},{fx['L2']}", "--reference",
            fx["ref"], "--env", env_path, "--gapped", "--gap-model", "affine",
            "--genotype", "--vcf-out", vcf])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        vp.pairhmm_log10_padded, vp.VariantPrepEngine.genotype_candidates = (
            batch, genotype)
    lanes = [ln for ln in lines if "Pair-HMM lanes" in ln]
    check(len(lanes) == 1 and len(captured) == 1 and len(walls) == 1,
          f"one Pair-HMM batch expected: {lanes}, {len(captured)} captured")
    recs = vcf_records(vcf)
    gts = {(r[0], int(r[1]) - 1, r[4]): r[9].split(":")[0] for r in recs}
    genotyped = sum(gt != "./." for gt in gts.values())
    hom = {k for k, gt in gts.items() if gt == "1/1"}
    snp = len(fx["snps"] & hom) / len(fx["snps"])
    dels = [d for d in fx["indels"] if d[2] == "<DEL>"]
    del_share = indel_recall(hom, dels)
    # an inferred insertion is called at its anchor, one base before
    alleles = {(k[0], k[1]): k[2][1:] for k, gt in gts.items()
               if gt != "./." and not k[2].startswith("<") and len(k[2]) > 1}
    ins_ok = sum(alleles.get((contig, p - 1)) == bases.decode()
                 for (contig, p), bases in fx["ins_bases"].items())
    ins_share = ins_ok / max(len(fx["ins_bases"]), 1)
    print(f"[14 genotype] {line_value(lines, 'Reads:')} | "
          f"{lanes[0].strip()} | launches {launches} | genotyping "
          f"{walls[0]:.2f} s of a {wall:.2f} s run, {genotyped} sites "
          f"genotyped = {genotyped / walls[0]:.1f} sites/s | planted SNPs "
          f"called 1/1 {100 * snp:.2f} % | planted deletions with a 1/1 "
          f"<DEL> within 10 bases {100 * del_share:.2f} % | planted "
          f"insertions called with their bases {100 * ins_share:.2f} %",
          flush=True)
    check(snp >= 0.95, f"planted SNPs called 1/1: {snp:.4f} < 0.95")
    check(launches["pairhmm"] == 1 and launches["pairhmm_f64"] == 1,
          f"Pair-HMM launches {launches}, not one in each precision")
    return {"launches": launches, "operand": captured[0], "wall": wall}


def phmm_synthetic(rng, device) -> dict:
    """Pair-HMM cases beyond the real operand: neighbouring lanes (a warp
    sweeps two) of very different lengths with la = 0 and lb = 0 lanes
    among them, a batch of one, ragged lanes with empty reads and
    haplotypes (odd B: a last warp of one lane), two stripes (M = 170) and
    rows past 256 (M = 300), a haplotype longer than its read and a read
    longer than its haplotype, the all-mismatch lane of
    tests/test_pairhmm.py, and 150 bp Q30 reads slid base by base across
    101-base windows, whose values straddle the float32 floor. Each is
    (reads, err64, haps, read_lens, hap_lens)."""
    import torch

    from mini_parallel_tpu_torch.ops import encode, pairhmm

    def lanes(reads, haps, quals, M, N):
        arr_r, la = encode.pad_batch(reads, pad_to=M, pad_value=int(encode.PAD_A))
        arr_h, lb = encode.pad_batch(haps, pad_to=N, pad_value=int(encode.PAD_B))
        q = np.zeros((len(reads), M))
        for i, x in enumerate(quals):
            q[i, :len(x)] = x
        err = torch.where(torch.arange(M)[None, :] < torch.from_numpy(la)[:, None],
                          pairhmm.phred_error(torch.from_numpy(q)), 0)
        return tuple(t.to(device) for t in (
            torch.from_numpy(arr_r), err, torch.from_numpy(arr_h),
            torch.from_numpy(la), torch.from_numpy(lb)))

    def cut(B, M, N):
        reads, haps, quals = [], [], []
        for k in range(B):
            hap = rng.choice(ACGT, int(rng.integers(1, N + 1)))
            m = int(rng.integers(1, M + 1))
            s = int(rng.integers(0, max(hap.size - m, 0) + 1))
            read = np.concatenate([hap[s:s + m], rng.choice(ACGT, m)])[:m]
            read[rng.random(m) < 0.03] = ord("A")
            reads.append([read.tobytes(), b"", rng.choice(ACGT, m).tobytes(),
                          read.tobytes()][k % 4])
            haps.append(hap.tobytes() if k % 7 != 6 else b"")
            quals.append(rng.integers(5, 41, m))
        return lanes(reads, haps, quals, M, N)

    hap = rng.choice(ACGT, 140)
    mismatch = COMPLEMENT[hap[:120]]  # every base mismatched
    src = rng.choice(ACGT, 400)
    slid = [src[25 + o:175 + o].tobytes() for o in range(150)]
    # neighbours (one warp holds two lanes) of very different lengths, and
    # the la = 0 and lb = 0 lanes beside full ones
    shapes = [(150, 101), (1, 1), (3, 200), (150, 101), (0, 50), (150, 7),
              (40, 0), (150, 101), (2, 160), (0, 0), (150, 3), (299, 101),
              (60, 1)]
    mixed = [rng.choice(ACGT, m).tobytes() for m, _ in shapes]
    mixed_haps = [rng.choice(ACGT, n).tobytes() for _, n in shapes]
    return {
        "neighbouring lanes of very different la and lb, la = 0 and lb = 0 "
        "lanes, M = 300": lanes(mixed, mixed_haps,
                                [rng.integers(5, 41, m) for m, _ in shapes],
                                300, 200),
        "a batch of one B=1 M=152 N=101": cut(1, 152, 101),
        "two stripes of 160 rows B=33 M=170 N=80": cut(33, 170, 80),
        "ragged B=37 M=60 N=90": cut(37, 60, 90),
        "rows past one stripe B=21 M=300 N=120": cut(21, 300, 120),
        "hap longer than read B=64 M=40 N=200": cut(64, 40, 200),
        "read longer than hap B=64 M=152 N=60": cut(64, 152, 60),
        "all-mismatch 120 x 140, Q40": lanes([mismatch.tobytes()],
                                             [hap.tobytes()],
                                             [np.full(120, 40)], 120, 140),
        "150 bp Q30 slid across 101 bases (straddles the float32 floor)":
            lanes(slid, [src[150:251].tobytes()] * 150,
                  [np.full(150, 30)] * 150, 152, 101),
    }


def phmm_cells_bytes(operand, f64: bool) -> tuple[float, float]:
    """The DP cells these lanes need (sum of read x hap lengths) and the
    bytes the function must move (reads, errors, haplotypes, lengths in;
    one value out per lane)."""
    import torch

    reads, err, haps, la, lb = operand
    B, M = reads.shape
    width = 8 if f64 else 4
    cells = float((la.to(torch.int64) * lb.to(torch.int64)).sum())
    return cells, float(B * M * (1 + width) + B * haps.shape[1] + 8 * B
                        + width * B)


def phase_pairhmm_compare(rng, operand, device) -> dict:
    """csrc/pairhmm.cu vs the plain pairhmm_batch on the card, both
    precisions: PHMM_SAMPLE lanes drawn from the genotype run's operand, its
    float32-underflowed lanes (float64), the whole operand (float32), and
    phmm_synthetic's cases. Holds every lane equal (max |Δlog10| 0, the same
    -inf lanes): the kernel rounds each cell as the plain version does.
    Times each kernel and its plain version on the sample, and the kernels
    on the whole operand."""
    import torch

    from mini_parallel_tpu_torch.ops import pairhmm, pairhmm_cuda

    kernels = {False: pairhmm_cuda.pairhmm_batch_cuda,
               True: pairhmm_cuda.pairhmm_f64_batch_cuda}

    def run(lanes, f64):
        reads, err, haps, la, lb = lanes
        err = err if f64 else err.to(torch.float32)
        got = kernels[f64](reads, err, haps, la, lb)
        want = pairhmm.pairhmm_batch(reads, err, haps, la, lb,
                                     dtype=err.dtype)
        torch.cuda.synchronize()
        return got, want

    B = operand[0].shape[0]
    pick = torch.from_numpy(np.sort(rng.choice(B, min(PHMM_SAMPLE, B),
                                               replace=False))).to(device)
    sample = tuple(t[pick] for t in operand)
    f32_all = kernels[False](operand[0], operand[1].to(torch.float32),
                             *operand[2:])
    under = torch.nonzero(torch.isinf(f32_all) & (operand[3] > 0)
                          & (operand[4] > 0))[:, 0]
    both = (False, True)  # float64?
    cases = [(f"real genotype operand, {pick.numel()} of {B} lanes", sample,
              both),
             # as the genotyper runs them: all lanes in float32, the
             # underflowed ones again in float64
             (f"the whole real genotype operand ({B} lanes)", operand,
              (False,)),
             (f"real float32-underflowed lanes (all {under.numel()} of {B})",
              tuple(t[under] for t in operand), (True,)),
             *((name, lanes, both)
               for name, lanes in phmm_synthetic(rng, device).items())]
    out = {False: {"max_err": 0.0}, True: {"max_err": 0.0}}
    for name, lanes, precisions in cases:
        for f64 in precisions:
            got, want = run(lanes, f64)
            one_sided = int((torch.isinf(got) != torch.isinf(want)).sum())
            fin = torch.isfinite(got) & torch.isfinite(want)
            err = float((got[fin].double() - want[fin].double()).abs().max()) \
                if bool(fin.any()) else 0.0
            out[f64]["max_err"] = max(out[f64]["max_err"], err)
            print(f"[15 pairhmm] {'float64' if f64 else 'float32'} {name}: "
                  f"B={lanes[0].shape[0]} M={lanes[0].shape[1]} "
                  f"N={lanes[2].shape[1]} max |dlog10| {err:.3g}, -inf "
                  f"{int(torch.isinf(got).sum())}, one-sided -inf "
                  f"{one_sided}, every lane equal {torch.equal(got, want)}",
                  flush=True)
            check(torch.equal(got, want),
                  f"pairhmm kernel != plain ({'f64' if f64 else 'f32'}) on {name}")
    for f64 in (False, True):
        lanes = tuple(sample)
        err = lanes[1] if f64 else lanes[1].to(torch.float32)
        args = (lanes[0], err, *lanes[2:])
        label = "float64" if f64 else "float32"
        cells, nbytes = phmm_cells_bytes(lanes, f64)
        ms = report_time(15, f"pairhmm {label} kernel, the {pick.numel()}-lane "
                         "sample", time_samples(lambda: kernels[f64](*args), 5),
                         cells)
        plain_ms, _ = time_once(lambda: pairhmm.pairhmm_batch(
            *args, dtype=err.dtype))
        print(f"[15 time] pairhmm {label} plain, the same sample, once: "
              f"{plain_ms:.1f} ms ({cells / plain_ms / 1e6:.2f} GCUPS)",
              flush=True)
        out[f64].update(ms=ms, plain_ms=plain_ms, cells=cells, bytes=nbytes)
    full = (operand[0], operand[1].to(torch.float32), *operand[2:])
    report_time(15, f"pairhmm float32 kernel, the whole operand ({B} lanes)",
                time_samples(lambda: kernels[False](*full), repeats=3),
                phmm_cells_bytes(operand, False)[0])
    redo = tuple(t[under] for t in operand)
    report_time(15, f"pairhmm float64 kernel, the operand's {under.numel()} "
                "underflowed lanes", time_samples(
                    lambda: kernels[True](*redo), repeats=3),
                phmm_cells_bytes(redo, True)[0])
    return out


def phase_roofline(device) -> dict:
    """csrc/roofline.cu == the plain chain exactly on the (2048, 512) tile
    at the full CHAIN; then the roofline tool's main() as a user runs it
    (launch counts set to 0 just before and read just after): the measured
    int32 peak beside the estimate, and sw_score's share of both."""
    import torch

    from mini_parallel_tpu_torch.ops import sw_cuda
    from mini_parallel_tpu_torch.tools import roofline

    a, b = roofline.chain_operands(device)
    got = roofline.roofline_chain_cuda(a, b, roofline.CHAIN)
    plain_ms, want = time_once(lambda: roofline.roofline_chain(a, b,
                                                               roofline.CHAIN))
    same = bool(torch.equal(got, want))
    err = int((got.long() - want.long()).abs().max())
    print(f"[16 roofline] chain tile {roofline.TILE} x CHAIN {roofline.CHAIN}: "
          f"kernel == plain {same} (max_abs_err {err}); plain once "
          f"{plain_ms:.1f} ms", flush=True)
    check(same, "the roofline chain kernel != the plain chain")
    steps = float(roofline.TILE[0] * roofline.TILE[1]) * roofline.CHAIN
    ms = statistics.median(time_samples(
        lambda: roofline.roofline_chain_cuda(a, b, roofline.CHAIN), 5))
    roofline.roofline_chain_cuda.launches = 0
    sw_cuda.sw_score_batch_cuda.launches = 0
    lines: list[str] = []
    check(roofline.main(echo=lines.append) == 0, f"roofline: {lines}")
    torch.cuda.synchronize()
    launches = roofline.roofline_chain_cuda.launches
    result = json.loads(lines[-1])
    peak = result["extra"]["peak_chain_int32_ops_per_s"] * 1e9
    instr = result["extra"]["peak_chain_int32_instructions_per_s"] * 1e9
    print(f"[16 roofline] main(): {lines[-1]}", flush=True)
    sw_ops = result["extra"]["sw_vector_ops_per_s_gops"] * 1e9
    est = roofline.INT32_OPS_PER_S
    print(f"[16 roofline] measured int32 peak {peak / 1e12:.2f} T ops/s "
          f"({roofline.CHAIN_OPS_PER_STEP} a DPX step) = {instr / 1e12:.2f} T "
          f"instructions/s, {100 * instr / est:.1f} % of the estimated "
          f"{est / 1e12:.2f} T; sw_score at {sw_ops / 1e12:.2f} T "
          f"instructions/s: {100 * result['value']:.1f} % of the measured "
          f"and {100 * sw_ops / est:.1f} % of the estimated instruction rate | "
          f"launches chain {launches}, sw_score "
          f"{sw_cuda.sw_score_batch_cuda.launches}", flush=True)
    check(launches > 0, "the roofline tool launched no chain kernel")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "steps": steps,
            "bytes": 3.0 * 4 * roofline.TILE[0] * roofline.TILE[1],
            "peak_instr": instr}


# ---------------------------------------------------------------------------
# The native host data plane (mini_parallel_tpu_torch/native: the FASTQ
# decoder, the 2-bit packer) and --kmer
# ---------------------------------------------------------------------------

INTERLEAVE = 3  # turns of each engine or packer, A, B, A, B...
PACKS_PER_TURN = 10
KMER_SUBSET_READS = 20_000


def _equal(x, y) -> bool:
    if isinstance(x, tuple):
        return (isinstance(y, tuple) and len(x) == len(y)
                and all(map(_equal, x, y)))
    if isinstance(x, np.ndarray):
        return (isinstance(y, np.ndarray) and x.dtype == y.dtype
                and np.array_equal(x, y))
    return x == y


def same_stream(a, b, what: str) -> int:
    """Two chunk streams equal, chunk by chunk; returns the chunk count."""
    import itertools

    n = 0
    for x, y in itertools.zip_longest(a, b):
        check(x is not None and y is not None,
              f"{what}: the engines yield different chunk counts")
        check(_equal(x, y), f"{what}: chunk {n} differs between the engines")
        n += 1
    return n


class python_plane:
    """The read paths' "auto" FASTQ engine set to python and the packer
    to NumPy for the duration of a ``with`` block."""

    def __enter__(self):
        from mini_parallel_tpu_torch.io import fastq
        from mini_parallel_tpu_torch.ops import packed

        self.saved = fastq._auto_engine, packed._native_lib
        fastq._auto_engine = lambda: "python"
        packed._native_lib = lambda: None
        return self

    def __exit__(self, *exc):
        from mini_parallel_tpu_torch.io import fastq
        from mini_parallel_tpu_torch.ops import packed

        fastq._auto_engine, packed._native_lib = self.saved


def phase_native_plane(info: dict, tmp: str, env_path: str, results_dir: str,
                       total_bases: int, fx: dict) -> dict:
    """The decoder and the packer held to the Python engine and NumPy; the
    decode-only and pack-only times per engine, interleaved; the read
    paths' reads/s on the native and the Python plane."""
    import shutil

    from mini_parallel_tpu_torch.io import fastq
    from mini_parallel_tpu_torch.ops import encode, packed

    report_engine(18)
    for name, (path, seconds) in info["native_builds"].items():
        print(f"[18 build] g++ {name}: {seconds:.2f} s ({path.name})",
              flush=True)
    wgs = [os.path.join(tmp, f"SMOKE_L{lane:03d}_R{read}_001.fastq.gz")
           for lane in (1, 2) for read in (1, 2)]
    lanes = [fx["L1"], fx["L2"]]
    streams = {"flat": fastq.iter_flat_chunks,
               "flat quals": fastq.iter_flat_chunks_with_quals,
               "reads": fastq.iter_read_chunks,
               "quals": fastq.iter_read_chunks_with_quals}
    t0 = time.perf_counter()
    chunks = 0
    for path in wgs + lanes:
        for kind, stream in streams.items():
            if path in lanes and kind in ("reads", "quals"):
                continue
            chunks += same_stream(
                stream(path, CHUNK_READS, engine="native"),
                stream(path, CHUNK_READS, engine="python"),
                f"{kind} {os.path.basename(path)}")
    print(f"[18 decoder] native == python on {len(wgs)} + {len(lanes)} files"
          f" ({4 * FILE_READS + 2 * VP_LANE_READS} reads): {chunks} chunks "
          "of the flat and flat-quality streams, and of the list streams on "
          f"phase 4's files, equal | {time.perf_counter() - t0:.2f} s",
          flush=True)

    stream = fastq.iter_flat_chunks(wgs[2], CHUNK_READS)  # the ragged file
    flat, offs = next(stream)
    stream.close()
    arr, lens = encode.pad_batch_flat(flat, offs, pad_to=MAIN_PAD,
                                      pad_value=int(encode.PAD_A))
    a, b = packed.pack_batch_native(arr, lens), packed.pack_batch_numpy(
        arr, lens)
    check(a.length == b.length and all(
        _equal(getattr(a, f), getattr(b, f))
        for f in ("packed", "exc_col", "exc_val", "lengths")),
        "the native packer differs from the NumPy packer")
    print(f"[18 packer] native == numpy on a {arr.shape[0]} x {arr.shape[1]} "
          f"chunk ({int((a.exc_col < a.length).sum())} exceptions, K = "
          f"{a.exc_col.shape[1]})", flush=True)

    def decode(engine: str) -> float:
        t = time.perf_counter()
        for _ in fastq.iter_flat_chunks_multi(wgs, CHUNK_READS,
                                              engine=engine):
            pass
        return time.perf_counter() - t

    def pack(fn) -> float:
        t = time.perf_counter()
        for _ in range(PACKS_PER_TURN):
            fn(arr, lens)
        return (time.perf_counter() - t) / PACKS_PER_TURN * 1e3

    out = {}
    for label, runs, unit, reads in (
            ("decode", {"native": lambda: decode("native"),
                        "python": lambda: decode("python")}, "s",
             4 * FILE_READS),
            ("pack", {"native": lambda: pack(packed.pack_batch_native),
                      "numpy": lambda: pack(packed.pack_batch_numpy)}, "ms",
             None)):
        samples = {k: [] for k in runs}
        for _ in range(INTERLEAVE):
            for k, fn in runs.items():
                samples[k].append(fn())
        for k, xs in samples.items():
            med = statistics.median(xs)
            out[f"{label}_{k}"] = med
            rate = f", {reads / med:.0f} reads/s" if reads else ""
            print(f"[18 {label}] {k}: {med:.4f} {unit} median of {len(xs)} "
                  f"interleaved ({', '.join(f'{x:.4f}' for x in xs)}){rate}"
                  + (f" | {len(wgs)} files x {FILE_READS} reads, flat stream"
                     if reads else f" | {arr.shape[0]} x {arr.shape[1]}"),
                  flush=True)

    cwd = os.getcwd()
    run_dir = os.path.join(tmp, "p18")
    sample = [fx["L1"], fx["L2"]]
    totals = {}
    try:
        for plane in ("native", "python"):
            with (python_plane() if plane == "python"
                  else contextlib.nullcontext()):
                for mode in ("sw", "kadane"):
                    shutil.rmtree(run_dir, ignore_errors=True)
                    os.makedirs(run_dir)
                    os.chdir(run_dir)  # no checkpoint of an earlier run
                    row, wall, _ = run_cli(mode, env_path, results_dir)
                    rate = row["throughput_reads_per_second"]
                    out[f"full_wgs_{mode}_{plane}"] = rate
                    print(f"[18 read paths] {plane} plane: --full-wgs --mode "
                          f"{mode} {rate:.0f} reads/s (run "
                          f"{row['total_time_seconds']:.2f} s, wall "
                          f"{wall:.2f} s), score {row['total_score']}",
                          flush=True)
                    totals.setdefault(mode, set()).add(
                        (row["total_score"], row["total_bases"]))
                lines, wall = cli_lines(["--variant-prep", ",".join(sample),
                                         "--reference", fx["ref"], "--env",
                                         env_path, "--gapped"])
                rate = 2 * VP_LANE_READS / wall
                out[f"variant_prep_gapped_{plane}"] = rate
                sites = line_value(lines, "Candidate variant sites:")
                totals.setdefault("vp", set()).add(sites)
                print(f"[18 read paths] {plane} plane: --variant-prep "
                      f"--gapped {rate:.0f} reads/s ({wall:.2f} s), {sites} "
                      "candidates", flush=True)
    finally:
        os.chdir(cwd)
    check(all(len(v) == 1 for v in totals.values()),
          f"the planes' read paths disagree: {totals}")
    check(totals["sw"] == {(2 * total_bases, total_bases)},
          "--full-wgs sw total != 2 x bases")
    return out


def phase_kmer(tmp: str, fx: dict, env_path: str, device) -> dict:
    """--kmer on phase 9's two lanes, summary and full; lane 1 on the card
    == on the CPU; a forced spill; --canonical at k = 21 and 31 on a
    subset against count_kmers_python."""
    import hashlib

    import torch

    from mini_parallel_tpu_torch.io import fastq
    from mini_parallel_tpu_torch.models import kmer_model as km
    from mini_parallel_tpu_torch.ops import kmer
    from mini_parallel_tpu_torch.utils.config import Config

    report_engine(19)
    Acc, Eng, Res = (kmer.DeviceKmerAccumulator, km.KmerEngine,
                     km.KmerResult)
    saved = (Acc.drain, Acc.summary, Eng.count_file, Eng._new_accumulator,
             Res.write_counts)
    fetches, results, accs, writes = [], [], [], []

    def drain(self):
        self.flush()  # the last fold is not the drain
        torch.cuda.synchronize()
        t = time.perf_counter()
        keys, counts = saved[0](self)
        fetches.append(("drain", time.perf_counter() - t,
                        keys.nbytes + counts.nbytes))
        return keys, counts

    def summary(self, *a, **kw):
        self.flush()
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = saved[1](self, *a, **kw)
        fetches.append(("summary", time.perf_counter() - t, 0 if s is None
                        else s["hist"].nbytes + 16 * len(s["top"])))
        return s

    def count_file(self, *a, **kw):
        results.append(saved[2](self, *a, **kw))
        return results[-1]

    def new_accumulator(self):
        accs.append(saved[3](self))
        return accs[-1]

    def write_counts(self, path):
        t = time.perf_counter()
        n = saved[4](self, path)
        writes.append(time.perf_counter() - t)
        return n

    def digest(path: str) -> tuple[str, int]:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest(), os.path.getsize(path)

    (Acc.drain, Acc.summary, Eng.count_file, Eng._new_accumulator,
     Res.write_counts) = (drain, summary, count_file, new_accumulator,
                          write_counts)
    out = {}
    try:
        sample = f"{fx['L1']},{fx['L2']}"
        n_reads = 2 * VP_LANE_READS
        env = ["--env", env_path]
        regimes = {}
        for label, extra in (("kmer_k21_summary", []),
                             ("kmer_k21_full_drain",
                              ["--kmer-out", os.path.join(tmp, "k21.tsv")])):
            fetches.clear()
            writes.clear()
            lines, wall = cli_lines(["--kmer", sample, *env, *extra])
            res = results[-1]
            kind, sec, nbytes = fetches[-1]
            w = f"{writes[0]:.2f} s" if writes else "none"
            rate = n_reads / res.seconds
            out[label] = {"reads_per_s": rate, "distinct": res.distinct_kmers,
                          "fetch_ms": 1e3 * sec, "fetch_bytes": nbytes,
                          "write_s": writes[0] if writes else None}
            print(f"[19 {label}] {rate:.0f} reads/s (count {res.seconds:.2f}"
                  f" s, wall {wall:.2f} s) | {res.total_kmers} k-mers, "
                  f"{res.distinct_kmers} distinct | {kind} "
                  f"{1e3 * sec:.2f} ms, {nbytes} bytes | write_counts {w}",
                  flush=True)
            regimes[label] = res, [ln for ln in lines if ln.startswith("  ")]
        full_acc = accs[-1]  # the full run's store stays on the card
        (summ, summ_top), (full, full_top) = regimes.values()
        check(summ.arrays == () and len(full.arrays) == 2,
              "summary mode drained the table, or full mode did not")
        check(summ.total_kmers == full.total_kmers == n_reads * (
            VP_READ_LEN - 20), "the k-mer total is not every window")
        check(summ.distinct_kmers == full.distinct_kmers
              and np.array_equal(summ.histogram(64), full.histogram(64))
              and summ.top(10) == full.top(10) and summ_top == full_top,
              "summary != full (distinct, histogram or top 10)")
        hist = full.histogram(64)
        print(f"[19 summary == full] distinct {full.distinct_kmers}, "
              f"histogram counts 1-8 {hist[:8].tolist()}, tail "
              f"{int(hist[-1])}, top {full.top(1)}", flush=True)

        dumps = {}
        for where in ("card", "cpu"):
            path = os.path.join(tmp, f"k21_L1_{where}.tsv")
            lines, wall = cli_lines(["--kmer", fx["L1"], *env, "--kmer-out",
                                     path] + (["--allow-cpu"] if where == "cpu"
                                              else []))
            dumps[where] = digest(path)
            print(f"[19 lane 1 {where}] {VP_LANE_READS / wall:.0f} reads/s "
                  f"({wall:.2f} s), {line_value(lines, 'Distinct 21-mers:')}"
                  f" distinct, dump {dumps[where][1]} bytes, sha256 "
                  f"{dumps[where][0][:16]}", flush=True)
        check(dumps["card"] == dumps["cpu"], "lane 1: card dump != CPU dump")

        cap = full.distinct_kmers // 3
        accs.clear()
        fetches.clear()
        t = time.perf_counter()
        spilled = km.KmerEngine(Config(chunk_size_reads=CHUNK_READS),
                                device_capacity=cap, device=device
                                ).count_file([fx["L1"], fx["L2"]])
        wall = time.perf_counter() - t
        check(any(a.spilled for a in accs), "the forced run did not spill")
        check(np.array_equal(spilled.arrays[0], full.arrays[0])
              and np.array_equal(spilled.arrays[1], full.arrays[1]),
              "the spilled counts differ from the unspilled ones")
        print(f"[19 spill] capacity {cap}: spilled, counts == unspilled "
              f"({spilled.distinct_kmers} distinct) | {n_reads / wall:.0f} "
              f"reads/s ({wall:.2f} s), drain incl. the spill folds "
              f"{1e3 * fetches[-1][1]:.2f} ms", flush=True)
        kmer_routes(full_acc, full)

        stream = fastq.iter_read_chunks(fx["L1"], KMER_SUBSET_READS)
        reads = next(stream)
        stream.close()
        subset = os.path.join(tmp, "kmer_subset.fastq.gz")
        fastq.write_fastq(subset, reads)
        for k in (21, 31):
            path = os.path.join(tmp, f"subset_k{k}.tsv")
            cli_lines(["--kmer", subset, *env, "-k", str(k), "--canonical",
                       "--kmer-out", path])
            with open(path) as f:
                got = [ln.rstrip("\n").split("\t") for ln in f]
            golden = kmer.count_kmers_python(reads, k, canonical=True)
            check([(s, int(c)) for s, c in got] == sorted(golden.items()),
                  f"--canonical k={k} != count_kmers_python")
            print(f"[19 canonical k={k}] {KMER_SUBSET_READS} reads: "
                  f"{len(got)} distinct == count_kmers_python, in k-mer "
                  "order", flush=True)
    finally:
        (Acc.drain, Acc.summary, Eng.count_file, Eng._new_accumulator,
         Res.write_counts) = saved
    return out


ROUTE_TURNS = 2  # raw, codec, codec, raw: each route's ms is a median


def kmer_routes(acc, full) -> None:
    """The drain codec beside the raw fetch the drain takes, on phase 19's
    full store (15.5 M keys): fetched raw (acc._fetch) and packed on the
    card (plane_pack), copied and decoded by the native decoder, in turns;
    identical arrays, each route's bytes and ms."""
    import torch

    from mini_parallel_tpu_torch.native import kmer_store
    from mini_parallel_tpu_torch.ops import kmer

    keys, counts = acc._store
    m = keys.numel()
    check(m == full.distinct_kmers, "the full run's store is not its table")

    def codec():
        planes, kp, cp, key0 = kmer.plane_pack(keys, counts)
        return kmer_store.decode_planes_native(planes.cpu().numpy(), m, kp,
                                               cp, key0)

    _, kp, cp, _ = kmer.plane_pack(keys, counts)
    route_bytes = {"raw": 16 * m, "codec": (kp + cp) * m + 32}
    times = {"raw": [], "codec": []}
    for route in ("raw", "codec", "codec", "raw") * (ROUTE_TURNS // 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = acc._fetch(keys, counts) if route == "raw" else codec()
        times[route].append(1e3 * (time.perf_counter() - t))
        check(np.array_equal(got[0], full.arrays[0])
              and np.array_equal(got[1], full.arrays[1]),
              f"the {route} fetch of the store != the full drain")
    ms = {r: statistics.median(v) for r, v in times.items()}
    print(f"[19 drain routes] {m} keys: raw {route_bytes['raw']} bytes "
          f"{ms['raw']:.2f} ms; codec kp={kp} cp={cp} {route_bytes['codec']}"
          f" bytes {ms['codec']:.2f} ms (medians of {ROUTE_TURNS}, "
          f"interleaved); identical keys and counts", flush=True)


# ---------------------------------------------------------------------------
# Monitors and profiler traces (utils/perf_logger.py, cli.py --profile)
# ---------------------------------------------------------------------------

def traced_kernels() -> dict:
    """Every kernel wrapper of the port, by kernel: (its wrappers, the
    parts of the kernel's name in a trace, demangled or mangled; the
    template arguments tell the forms apart). sw_long's linear and affine
    wrappers launch one kernel template."""
    from mini_parallel_tpu_torch.ops import (
        pairhmm_cuda,
        pileup_cuda,
        sw_cuda,
        sw_long,
    )
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc
    from mini_parallel_tpu_torch.tools import roofline

    return {
        "sw_score": ((sw_cuda.sw_score_batch_cuda,), ("sw_score_kernel",)),
        "sw_affine_score": ((sw_cuda.sw_affine_batch_cuda,),
                            ("sw_affine_kernel",)),
        "sw_vs_ref": ((sw_cuda.sw_vs_ref_batch_cuda,), ("sw_vs_ref_kernel",)),
        "sw_moves": ((tbc.sw_moves_batch_cuda,),
                     ("sw_moves_kernel", "LinearGap")),
        "sw_affine_moves": ((tbc.sw_affine_moves_batch_cuda,),
                            ("sw_moves_kernel", "AffineGap")),
        "pairhmm": ((pairhmm_cuda.pairhmm_batch_cuda,),
                    ("pairhmm_kernel", "F32")),
        "pairhmm_f64": ((pairhmm_cuda.pairhmm_f64_batch_cuda,),
                        ("pairhmm_kernel", "F64")),
        "sw_long": ((sw_long.sw_strip_cuda, sw_long.sw_affine_strip_cuda),
                    ("sw_group_kernel",)),
        "roofline_chain": ((roofline.roofline_chain_cuda,), ("chain_kernel",)),
        "pileup": ((pileup_cuda.pileup_positions_cuda,), ("pileup_kernel",)),
    }


def read_trace(trace_dir: str) -> dict:
    """The one trace a --profile run wrote into ``trace_dir``: its kernel
    launches by name, the traced window (the span of all its events), and
    the device-busy share: the union of the kernel, memcpy and memset
    intervals over that window."""
    names = os.listdir(trace_dir)
    check(len(names) == 1 and names[0].endswith(".pt.trace.json"),
          f"expected one trace in {trace_dir}: {names}")
    with open(os.path.join(trace_dir, names[0])) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, reach = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {"window_ms": (end - start) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (end - start), "kernels": kernels,
            "cpu_ops": sum(e.get("cat") == "cpu_op" for e in events)}


def profiled_run(label: str, argv: list[str], run_dir: str, need: dict,
                 cli_monitors: bool = False) -> dict:
    """``cli.main(argv + ["--profile", ...])`` from ``run_dir`` (a fresh
    working directory: checkpoints and logs/ land there) under the system
    monitors: the CLI's own (``cli_monitors``: --full-wgs) or, for the
    other modes, the same monitors started around the call. Every kernel
    wrapper's count (set to 0 just before, read just after) must equal the
    launches of its kernel in the trace, each kernel in ``need`` must have
    launched as many times as it says (None: at least once), and
    nvidia_smi.log must hold samples. Peak device memory is this run's."""
    import torch

    from mini_parallel_tpu_torch.utils import perf_logger

    kernels = traced_kernels()
    os.makedirs(run_dir)
    cwd = os.getcwd()
    os.chdir(run_dir)
    torch.cuda.reset_peak_memory_stats()
    try:
        for fns, _ in kernels.values():
            for fn in fns:
                fn.launches = 0
        with (contextlib.nullcontext() if cli_monitors
              else perf_logger.system_monitors(device=torch.device("cuda"))):
            lines, wall = cli_lines([*argv, "--profile", "trace"])
        torch.cuda.synchronize()
        counts = {k: sum(fn.launches for fn in fns)
                  for k, (fns, _) in kernels.items()}
    finally:
        os.chdir(cwd)
    trace = read_trace(os.path.join(run_dir, "trace"))
    in_trace = {k: sum(all(p in name for p in parts)
                       for name in trace["kernels"])
                for k, (_, parts) in kernels.items()}
    print(f"[20 trace] {label}: {len(trace['kernels'])} kernels, "
          f"{trace['cpu_ops']} CPU ops in a {trace['window_ms']:.1f} ms "
          f"window | port kernels in the trace {in_trace} | wrappers counted "
          f"{counts}", flush=True)
    check(in_trace == counts,
          f"{label}: trace launches {in_trace} != wrapper counts {counts}")
    for k, n in need.items():
        check(counts[k] >= 1 if n is None else counts[k] == n,
              f"{label}: {k} launched {counts[k]} times, want "
              f"{'some' if n is None else n}")
    logs = os.path.join(run_dir, "logs", "run_1")
    samples = perf_logger.read_nvidia_smi_log(
        os.path.join(logs, "nvidia_smi.log"))
    summary = perf_logger.summarize_monitor_logs(logs)
    check(len(samples) > 0, f"{label}: nvidia_smi.log holds no sample")
    print(f"[20 busy] {label}: device busy {trace['busy_ms']:.1f} ms of "
          f"{trace['window_ms']:.1f} ms = {100 * trace['busy_share']:.3f} % "
          "(trace: kernel, memcpy and memset intervals, their union) | "
          f"nvidia-smi utilization.gpu (time-weighted, {len(samples)} "
          f"samples) {100 * summary['device_busy_fraction_est']:.2f} % | "
          f"peak device memory {summary.get('peak_device_bytes_in_use')} "
          f"bytes | highest power draw {summary.get('max_power_draw_w')} W",
          flush=True)
    return {"lines": lines, "wall": wall, "trace": trace, "counts": counts,
            "summary": summary}


def phase_profiles(tmp: str, env_path: str, results_dir: str, fx: dict,
                   genotype_wall: float) -> dict:
    """--full-wgs --mode sw (phase 4's files), --variant-prep --gapped
    --gap-model affine --genotype and --kmer (phase 9's two lanes) with
    --profile, each from a fresh working directory under the monitors; the
    --full-wgs and --kmer runs also without --profile, for the wall (phase
    14's run is the genotype path's)."""
    report_engine(20)
    base = os.path.join(tmp, "profiles")
    out = {}
    wgs = ["--full-wgs", "--mode", "sw", "--env", env_path]
    plain_dir = os.path.join(base, "wgs_plain")
    os.makedirs(plain_dir)
    cwd = os.getcwd()
    os.chdir(plain_dir)  # a fresh checkpoint: phase 4's would skip every file
    try:
        _, plain_wall = cli_lines(wgs)
    finally:
        os.chdir(cwd)
    run = profiled_run("--full-wgs --mode sw", wgs, os.path.join(base, "wgs"),
                       {"sw_score": 4 * -(-FILE_READS // CHUNK_READS)},
                       cli_monitors=True)
    runs = sorted(int(n.split("_")[1]) for n in os.listdir(results_dir)
                  if n.startswith("run_"))
    with open(os.path.join(results_dir,
                           f"run_{runs[-1]}_benchmark_results.json")) as f:
        row = json.load(f).get("monitor_summary", {})
    print(f"[20 monitors] --full-wgs --mode sw: its bench row's "
          f"monitor_summary {row}", flush=True)
    for key in ("device_busy_fraction_est", "peak_device_bytes_in_use",
                "max_power_draw_w"):
        check(key in row, f"the bench row's monitor_summary lacks {key}")
    out["full_wgs"] = dict(run, plain_wall=plain_wall)

    vp = ["--variant-prep", f"{fx['L1']},{fx['L2']}", "--reference",
          fx["ref"], "--env", env_path, "--gapped", "--gap-model", "affine",
          "--genotype", "--vcf-out", "profiled.vcf"]
    run = profiled_run("--variant-prep --gapped --gap-model affine "
                       "--genotype", vp, os.path.join(base, "genotype"),
                       {"sw_affine_moves": None, "pairhmm": 1,
                        "pairhmm_f64": 1,
                        "pileup": 2 * -(-VP_LANE_READS // CHUNK_READS)})
    out["genotype"] = dict(run, plain_wall=genotype_wall)

    km = ["--kmer", f"{fx['L1']},{fx['L2']}", "--env", env_path]
    _, km_plain = cli_lines(km)
    run = profiled_run("--kmer (summary)", km, os.path.join(base, "kmer"), {})
    out["kmer"] = dict(run, plain_wall=km_plain)
    for key, label in (("full_wgs", "--full-wgs --mode sw"),
                       ("genotype", "--variant-prep ... --genotype (phase 14 "
                        "without)"),
                       ("kmer", "--kmer summary")):
        r = out[key]
        print(f"[20 overhead] {label}: wall with --profile {r['wall']:.2f} s,"
              f" without {r['plain_wall']:.2f} s ("
              f"{100 * (r['wall'] / r['plain_wall'] - 1):+.1f} %)", flush=True)
    return out


# ---------------------------------------------------------------------------
# The port's tools on the card (mini_parallel_tpu_torch/tools)
# ---------------------------------------------------------------------------

SCALE_LANES, SCALE_READS, SCALE_CHUNK = 4, 50_000, 500
# kernel_check's long rows here (30,000 x 40,000 by default): phases 6-8
# hold the strip kernel at up to 200,000 x 150,000 already, and the two
# NumPy goldens at the default size take tens of seconds of host time
GATE_LONG = {"LONG_M": 6_000, "LONG_N": 8_000, "LONG_SEGMENT": 1_500,
             "LONG_A_AT": 1_000, "LONG_B_AT": 2_800}


@contextlib.contextmanager
def forced_env(**values):
    """Set environment variables for the block, whatever an earlier .env
    left there (load_dotenv never overrides), and restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def captured_stdout(fn, *args):
    """(fn's return, the lines it printed)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    return rc, text.splitlines()


def phase_tools(tmp: str, results_dir: str) -> dict:
    """kernel_check (15 rows), smoke (13/13), linecount on phase 4's files,
    stdin_linecount in a subprocess, make_scale_data, a clean --full-wgs
    kadane run over the scale set and the resilience soak over it, and
    autotune."""
    import subprocess

    from mini_parallel_tpu_torch import cli
    from mini_parallel_tpu_torch.tools import (
        autotune,
        kernel_check,
        linecount,
        smoke,
        soak_resilience,
    )

    out = {}
    saved = {k: getattr(kernel_check, k) for k in GATE_LONG}
    for k, v in GATE_LONG.items():
        setattr(kernel_check, k, v)
    try:
        for tool, fn, argv in (("kernel_check", kernel_check.main, []),
                               ("smoke", smoke.main, [])):
            t0 = time.perf_counter()
            rc, lines = captured_stdout(fn, argv)
            out[tool] = time.perf_counter() - t0
            passed = sum("PASS" in ln for ln in lines)
            print(f"[21 {tool}] exit {rc}, {passed} PASS rows, "
                  f"{out[tool]:.2f} s (long rows at {GATE_LONG['LONG_M']} x "
                  f"{GATE_LONG['LONG_N']})", flush=True)
            # smoke: its 13 rows and the 15 of the kernel gate it runs first
            want = 15 if tool == "kernel_check" else 13 + 15
            check(rc == 0 and passed == want,
                  f"{tool} exited {rc} with {passed} PASS rows, want {want}")
    finally:
        for k, v in saved.items():
            setattr(kernel_check, k, v)

    files = sorted(os.path.join(tmp, n) for n in os.listdir(tmp)
                   if n.startswith("SMOKE_L"))
    rc, lines = captured_stdout(linecount.main, files)
    check(rc == 0 and lines == [f"{p}: {4 * FILE_READS} lines" for p in files],
          f"linecount: {lines}")
    with gzip.open(files[0], "rb") as f:
        data = f.read()
    proc = subprocess.run(
        [sys.executable, "-m", "mini_parallel_tpu_torch.tools.stdin_linecount"],
        input=data, capture_output=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0 and proc.stdout == b"%d\n" % (4 * FILE_READS),
          f"stdin_linecount: {proc.returncode} {proc.stdout[-100:]!r}")
    print(f"[21 linecount] {len(files)} files x {4 * FILE_READS} lines; "
          f"stdin_linecount {proc.stdout.decode().strip()}", flush=True)

    scale = os.path.join(tmp, "scale")
    t0 = time.perf_counter()
    # its spawn pool's resource tracker ends with the subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "mini_parallel_tpu_torch.tools.make_scale_data",
         scale, "--lanes", str(SCALE_LANES), "--reads-per-lane",
         str(SCALE_READS)], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0,
          f"make_scale_data exited {proc.returncode}: {proc.stderr[-2000:]}")
    out["make_scale_data"] = time.perf_counter() - t0
    run = os.path.join(tmp, "soak")
    os.makedirs(run)
    cwd = os.getcwd()
    os.chdir(run)
    try:
        with forced_env(WGS_DATA_DIR=scale, WGS_SAMPLE_ID="SCALE",
                        WGS_LANES=SCALE_LANES, WGS_READS_PER_LANE=1,
                        GPU_CHUNK_SIZE_READS=SCALE_CHUNK,
                        MPT_RESULTS_DIR=results_dir):
            lines, wall = cli_lines(["--full-wgs", "--mode", "kadane"])
            (ckpt,) = [n for n in os.listdir(run) if n.startswith("checkpoint_")]
            soak: list[str] = []
            rc = soak_resilience.main([ckpt], echo=soak.append)
    finally:
        os.chdir(cwd)
    verdict = json.loads(soak[-1] if rc == 0 else soak[-2])
    print(f"[21 soak] make_scale_data {SCALE_LANES} x {SCALE_READS} reads: "
          f"{out['make_scale_data']:.2f} s | clean --full-wgs kadane "
          f"{wall:.2f} s | soak exit {rc}: {verdict} | "
          f"{sum(ln.endswith(' OK') for ln in soak)}/{SCALE_LANES} files "
          "equal to the clean run", flush=True)
    check(rc == 0 and verdict["injection_fired"]
          and verdict["retried_from_chunk"] == 50
          and verdict["bit_exact_vs_clean"],
          f"the soak did not recover its injected failure: {soak[-6:]}")

    t0 = time.perf_counter()
    tune: list[str] = []
    rc = autotune.main([], echo=tune.append)
    out["autotune"] = time.perf_counter() - t0
    for ln in tune:
        print(f"[21 autotune] {ln}", flush=True)
    check(rc == 0 and sum(ln.startswith("winner") for ln in tune) >= 4,
          f"autotune exited {rc}")
    print(f"[21 autotune] {out['autotune']:.2f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 22: device meshes, row bands and two processes (parallel/)
# ---------------------------------------------------------------------------

PAR_SHARDS = 4  # shards of the data mesh and row bands of the seq mesh
PAR_SMALL_M, PAR_SMALL_N = 3_000, 2_000  # the plain bands' pair

_DIST_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from mini_parallel_tpu_torch import cli

out = []
rc = cli.main(["--full-wgs", "--mode", "sw", "--env", sys.argv[2]],
              echo=out.append)
json.dump({"rc": rc, "lines": out}, open(sys.argv[3], "w"))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _vcf_sam_bytes(eng, lane: str, out: str) -> dict:
    """One variant-prep engine on a lane: the pileup, the genotyped VCF
    bytes and the SAM bytes (the SAM pass runs on its own)."""
    from mini_parallel_tpu_torch.models import variant_prep as vp

    res = eng.process_file(lane)
    pileup = res.pileup.copy()
    res = eng.genotype_candidates(lane, res)
    vp.write_candidates_vcf(out + ".vcf", res)
    eng.process_file(lane, sam_out=out + ".sam")
    with open(out + ".vcf", "rb") as f, open(out + ".sam", "rb") as g:
        return {"pileup": pileup, "vcf": f.read(), "sam": g.read(),
                "mapped": res.mapped_reads,
                "called": sum(c.gt is not None for c in res.candidates)}


def phase_parallel(rng, tmp: str, fx: dict, main_pairs, total_bases: int,
                   device) -> dict:
    """Every sharded path of parallel/ against the port's single-device
    engines on the card: a data mesh of PAR_SHARDS shards of cuda:0, a
    (1, PAR_SHARDS) seq mesh for the long pair, the CLI under
    MPT_MESH_SHAPE=1 and 1x1, and --full-wgs in two processes over gloo.
    Each path's kernel counts are set to 0 just before it and read just
    after; every kernel it reaches must have launched. Returns the band
    path's times."""
    import hashlib
    import subprocess

    import torch

    from mini_parallel_tpu_torch.io import fasta
    from mini_parallel_tpu_torch.models import variant_prep as vp
    from mini_parallel_tpu_torch.models.alignment import MODES, AlignmentEngine
    from mini_parallel_tpu_torch.models.complementarity import (
        ComplementarityEngine,
    )
    from mini_parallel_tpu_torch.models.kmer_model import KmerEngine
    from mini_parallel_tpu_torch.ops import encode, sw_long
    from mini_parallel_tpu_torch.ops import packed as packedmod
    from mini_parallel_tpu_torch.parallel import pipeline
    from mini_parallel_tpu_torch.parallel.mesh import make_mesh
    from mini_parallel_tpu_torch.utils.config import Config

    wrappers = {name: fns for name, (fns, _) in traced_kernels().items()}

    def zero():
        for fns in wrappers.values():
            for fn in fns:
                fn.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {name: sum(fn.launches for fn in fns)
                for name, fns in wrappers.items()
                if sum(fn.launches for fn in fns)}

    def need(n: dict, names, what: str):
        missing = [k for k in names if not n.get(k)]
        check(not missing, f"{what} on the mesh launched no {missing}")

    t_phase = time.perf_counter()
    card = torch.device(device.type, 0)
    mesh = make_mesh((PAR_SHARDS,), devices=[card] * PAR_SHARDS)
    one = make_mesh((1,), devices=[card])
    cfg = Config(chunk_size_reads=CHUNK_READS)
    out: dict = {}

    # --full-wgs's engine on phase 4's four files, every mode
    files = [os.path.join(tmp, f"SMOKE_L{lane:03d}_R{r}_001.fastq.gz")
             for lane in (1, 2) for r in (1, 2)]
    for mode in MODES:
        totals = []
        for eng in (AlignmentEngine(cfg, mode=mode, device=device),
                    AlignmentEngine(cfg, mode=mode, mesh=mesh)):
            zero()
            t0 = time.perf_counter()
            res = [eng.self_align_file(f) for f in files]
            n = counts()
            totals.append((sum(r.score for r in res),
                           sum(r.total_reads for r in res),
                           sum(r.total_bases for r in res),
                           sum(r.chunks for r in res),
                           sum(r.failed_chunks for r in res)))
        wall = time.perf_counter() - t0
        print(f"[22 full-wgs {mode}] {PAR_SHARDS} shards: score, reads, "
              f"bases, chunks, failed {totals[1]} | one device {totals[0]} | "
              f"launches {n} | the mesh's pass {wall:.2f} s", flush=True)
        check(totals[1] == totals[0] and totals[1][4] == 0,
              f"--full-wgs {mode} on the mesh {totals[1]} != {totals[0]}")
        if mode in ("sw", "sw-affine"):
            key = "sw_score" if mode == "sw" else "sw_affine_score"
            check(n.get(key) == PAR_SHARDS * totals[1][3],
                  f"{mode}: {n} for {totals[1][3]} chunks x {PAR_SHARDS}")
            check(totals[1][0] == 2 * total_bases, f"{mode} total")

    # per-pair scores of the main shape's pairs, and the WGS step
    rows_a, rows_b = main_pairs
    for mode in ("sw", "sw-affine"):
        scores = []
        for where in ({"device": device}, {"mesh": mesh}):
            zero()
            scores.append(AlignmentEngine(cfg, mode=mode, **where)
                          .score_read_batch(rows_a, rows_b))
            n = counts()
        print(f"[22 pairs {mode}] {len(rows_a)} pairs on {PAR_SHARDS} shards"
              f" == one device: {np.array_equal(*scores)} | launches {n}",
              flush=True)
        check(np.array_equal(*scores), f"score_read_batch {mode} on the mesh")
        need(n, ["sw_score" if mode == "sw" else "sw_affine_score"], mode)
    arr_a, len_a = encode.pad_batch(rows_a, pad_to=MAIN_PAD,
                                    pad_value=int(encode.PAD_A))
    arr_b, len_b = encode.pad_batch(rows_b, pad_to=MAIN_PAD,
                                    pad_value=int(encode.PAD_B))
    zero()
    want = pipeline.make_wgs_step(one)(arr_a, arr_b, len_a, len_b)
    steps = {"unpacked": pipeline.make_wgs_step(mesh)(arr_a, arr_b, len_a,
                                                      len_b),
             "packed": pipeline.make_wgs_step_packed(mesh)(
                 packedmod.pack_batch(arr_a, len_a),
                 packedmod.pack_batch(arr_b, len_b))}
    n = counts()
    for kind, got in steps.items():
        same = all(torch.equal(got[k], want[k]) for k in want)
        print(f"[22 wgs step {kind}] {PAR_SHARDS} shards == one shard on "
              f"every key {same}: parity {int(got['parity_score'])}, sw sum "
              f"{int(got['sw_score_sum'])} max {int(got['sw_score_max'])}, "
              f"pairs {int(got['pairs'])}, complementary "
              f"{int(got['complementary_pairs'])}, base_hist "
              f"{got['base_hist'].tolist()}, kmer_hist sum "
              f"{int(got['kmer_hist'].sum())}", flush=True)
        check(same, f"the {kind} WGS step on the mesh != one shard")
    check(n.get("sw_score") == 2 + 4 * PAR_SHARDS, f"WGS step launches {n}")

    # the complementarity lane pair of phase 8
    c1, c2 = (os.path.join(tmp, f"COMP_L001_R{k}_001.fastq.gz")
              for k in (1, 2))
    stats = []
    for where in ({"device": device}, {"mesh": mesh}):
        zero()
        r = ComplementarityEngine(cfg, **where).analyze_lane_pair(c1, c2)
        stats.append((r.pairs, r.direct_score_sum, r.comp_score_sum,
                      r.perfect_pairs))
        n = counts()
    print(f"[22 complementarity] pairs, direct, comp, perfect {stats[1]} == "
          f"one device {stats[0]} | launches {n}", flush=True)
    check(stats[1] == stats[0], "--complementarity on the mesh")
    need(n, ["sw_score"], "--complementarity")

    # --variant-prep --gapped --rescue --genotype on the exact lane
    for gap_model, moves in (("linear", "sw_moves"),
                             ("affine", "sw_affine_moves")):
        runs = []
        for tag, where in (("one", {"device": device}), ("mesh",
                                                          {"mesh": mesh})):
            zero()
            t0 = time.perf_counter()
            eng = vp.VariantPrepEngine(fx["contigs"], cfg, gapped=True,
                                       rescue=True, gap_model=gap_model,
                                       **where)
            runs.append(_vcf_sam_bytes(
                eng, fx["exact"], os.path.join(tmp, f"par_{gap_model}_{tag}")))
            n = counts()
        same = (np.array_equal(runs[0]["pileup"], runs[1]["pileup"])
                and runs[0]["vcf"] == runs[1]["vcf"]
                and runs[0]["sam"] == runs[1]["sam"])
        print(f"[22 variant-prep {gap_model}] --gapped --rescue --genotype "
              f"(+ --sam-out), the {VP_EXACT_READS}-read lane on "
              f"{PAR_SHARDS} shards == one device (pileup, "
              f"{len(runs[1]['vcf'])} VCF bytes, {len(runs[1]['sam'])} SAM "
              f"bytes): {same} | "
              f"mapped {runs[1]['mapped']}, genotyped {runs[1]['called']} | "
              f"launches {n} | {time.perf_counter() - t0:.2f} s", flush=True)
        check(same, f"--variant-prep {gap_model} on the mesh")
        need(n, ["sw_vs_ref", moves, "pairhmm", "pileup"],
             f"--variant-prep {gap_model}")

    # --kmer on the 100,000-read lane: summary and the full table (the
    # dump's lines are written from it)
    kruns = {}
    t0 = time.perf_counter()
    for tag, where in (("one", {"device": device}), ("mesh", {"mesh": mesh})):
        eng = KmerEngine(cfg, k=21, **where)
        summ = eng.count_file(fx["small"], result_mode="summary")
        table = eng.count_file(fx["small"]).arrays
        digest = hashlib.sha256(b"".join(x.tobytes() for x in table)
                                ).hexdigest()
        kruns[tag] = (summ.distinct_kmers, summ.total_kmers,
                      summ.histogram(64).tolist(), summ.top(10), digest)
    print(f"[22 kmer] {VP_SMALL_READS} reads on {PAR_SHARDS} shards: "
          f"distinct {kruns['mesh'][0]}, summary == one device's "
          f"{kruns['mesh'][:4] == kruns['one'][:4]}, full table sha256 "
          f"{kruns['mesh'][4][:16]} == {kruns['one'][4][:16]} | "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(kruns["mesh"] == kruns["one"], "--kmer on the mesh")

    # the long pair of phase 8 by row bands on a (1, PAR_SHARDS) seq mesh
    seq = make_mesh((1, PAR_SHARDS), devices=[card] * PAR_SHARDS)
    a = fasta.read_first_sequence(os.path.join(tmp, "long_a.fa"))
    b = fasta.read_first_sequence(os.path.join(tmp, "long_b.fa"))
    for affine, single, banded in (
            (False, sw_long.sw_score_long, sw_long.sw_score_long_sharded),
            (True, sw_long.sw_affine_score_long,
             sw_long.sw_affine_score_long_sharded)):
        name = "sw_long_affine" if affine else "sw_long"
        zero()
        score = banded(a, b, seq)
        n = counts()
        t_band = [time_once(lambda: banded(a, b, seq))[0] for _ in range(3)]
        t_one = [time_once(lambda: single(a, b, device))[0] for _ in range(3)]
        want = single(a, b, device)
        sa, sb = long_pair(rng, PAR_SMALL_M, PAR_SMALL_N,
                           seg=PAR_SMALL_N // 2, a_at=PAR_SMALL_M // 3,
                           b_at=PAR_SMALL_N // 5, gap=17)
        cpu4 = make_mesh((1, PAR_SHARDS),
                         devices=[torch.device("cpu")] * PAR_SHARDS)
        small = (banded(sa, sb, seq, strip_width=64),
                 banded(sa, sb, cpu4, strip_width=64))
        out[f"{name}_band_ms"] = statistics.median(t_band)
        out[f"{name}_one_ms"] = statistics.median(t_one)
        print(f"[22 bands {'affine' if affine else 'linear'}] {len(a)} x "
              f"{len(b)} in {PAR_SHARDS} row bands: {score} == sw_score_long "
              f"{want} | {out[f'{name}_band_ms']:.2f} ms (median of 3; one "
              f"device {out[f'{name}_one_ms']:.2f} ms) | launches {n} | "
              f"{PAR_SMALL_M} x {PAR_SMALL_N}: kernel bands {small[0]} == "
              f"plain bands {small[1]}", flush=True)
        check(score == want, f"{name}: bands {score} != one device {want}")
        check(small[0] == small[1], f"{name}: kernel bands != plain bands")
        check(n.get("sw_long", 0) >= PAR_SHARDS, f"{name} band launches {n}")

    # the CLI under MPT_MESH_SHAPE=1 and 1x1 (the one card)
    fa, fb = os.path.join(tmp, "long_a.fa"), os.path.join(tmp, "long_b.fa")
    long_score = sw_long.sw_score_long(a, b, device)
    for shape in ("1", "1x1"):
        run_dir = os.path.join(tmp, f"par_cli_{shape}")
        os.makedirs(run_dir)
        cwd = os.getcwd()
        os.chdir(run_dir)  # a fresh checkpoint directory
        try:
            with forced_env(MPT_MESH_SHAPE=shape,
                            MPT_RESULTS_DIR=os.path.join(run_dir, "results")):
                lines, wall = cli_lines(["--full-wgs", "--mode", "sw", "--env",
                                         os.path.join(tmp, "smoke.env")])
                scores = [int(ln.split("Score=")[1].split(",")[0])
                          for ln in lines if "Score=" in ln]
                llines, _ = cli_lines(["--long-align", "-1", fa, "-2", fb,
                                       "--mode", "sw"])
        finally:
            os.chdir(cwd)
        got = int(line_value(llines, "Alignment score:"))
        print(f"[22 cli MPT_MESH_SHAPE={shape}] --full-wgs sw total "
              f"{sum(scores)} over {len(scores)} files (2 x bases = "
              f"{2 * total_bases}) in {wall:.2f} s | --long-align {got} "
              f"(one device {long_score})", flush=True)
        check(sum(scores) == 2 * total_bases and len(scores) == 4,
              f"--full-wgs under MPT_MESH_SHAPE={shape}")
        check(got == long_score, f"--long-align under MPT_MESH_SHAPE={shape}")

    # --full-wgs in two processes over gloo, both on cuda:0
    worker = os.path.join(tmp, "dist_worker.py")
    with open(worker, "w") as f:
        f.write(_DIST_WORKER)
    env_file = os.path.join(tmp, "dist.env")
    with open(env_file, "w") as f:
        f.write(f"WGS_DATA_DIR={tmp}\nWGS_SAMPLE_ID=SMOKE\nWGS_LANES=2\n"
                f"WGS_READS_PER_LANE=2\nGPU_CHUNK_SIZE_READS={CHUNK_READS}\n")
    port = _free_port()
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(2):
            d = os.path.join(tmp, f"dist{pid}")
            os.makedirs(d)
            env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                       MPT_RESULTS_DIR=os.path.join(d, "results"))
            env.pop("MPT_MESH_SHAPE", None)
            with open(os.path.join(d, "log.txt"), "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, worker, repo, env_file,
                     os.path.join(d, "out.json")], cwd=d, env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    want = (f"Global totals: DistributedTotals(files=4, reads={4 * FILE_READS}"
            f", bases={total_bases}, score={2 * total_bases}, seconds_max=")
    local_files = []
    for pid, p in enumerate(procs):
        with open(os.path.join(tmp, f"dist{pid}", "log.txt"), "rb") as f:
            log = f.read().decode(errors="replace")
        check(p.returncode == 0,
              f"process {pid} exited {p.returncode}: {log[-2000:]}")
        with open(os.path.join(tmp, f"dist{pid}", "out.json")) as f:
            run = json.load(f)
        glob = [ln for ln in run["lines"] if ln.startswith("Global totals:")]
        host = [ln for ln in run["lines"]
                if ln.startswith(f"[host {pid}/2] processing")]
        print(f"[22 two processes] rank {pid}: rc {run['rc']} | "
              f"{host[0] if host else 'no plan line'} | "
              f"{glob[0] if glob else 'no totals'}", flush=True)
        check(run["rc"] == 0 and len(glob) == 1 and glob[0].startswith(want),
              f"rank {pid}'s merged totals are not the single process's")
        local_files.append(int(host[0].split()[3].split("/")[0]))
    print(f"[22 two processes] files per rank {local_files}, {wall:.2f} s "
          "wall (both processes' start included)", flush=True)
    check(sum(local_files) == 4 and min(local_files) > 0,
          f"the files were not partitioned: {local_files}")
    out["wall"] = time.perf_counter() - t_phase
    print(f"[22 wall] phase 22: {out['wall']:.2f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 23: the measurement harness (mini_parallel_tpu_torch/bench/)
# ---------------------------------------------------------------------------

BENCH_RUNS = (  # (module, arguments, time limit s)
    ("headline", [], 300),
    ("workloads", [], 600),
    ("scaling", ["--sizes", "1,2,4"], 300),
    ("multiprocess", ["--sizes", "1,2"], 600),
)
BENCH_PHASE_LIMIT_S = 150
HEADLINE_TOLERANCE = 0.2  # the headline's batch ms against phase 3's


def bench_rows(module: str, argv: list[str], limit: float) -> list[dict]:
    """One bench module as a subprocess on the card, from the repo root:
    its JSON lines. It must exit 0."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"mini_parallel_tpu_torch.bench.{module}",
         *argv], cwd=root, capture_output=True, text=True, timeout=limit)
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    print(f"[23 {module}] {' '.join(argv) or 'defaults'}: exit "
          f"{proc.returncode}, {len(rows)} rows, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(proc.returncode == 0,
          f"bench.{module} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return rows


def phase_bench(info: dict, sw_kernel_ms: float) -> dict:
    """The four bench modules at their card sizes: every row correct and
    carrying the card's name and power limit; the headline's batch within
    HEADLINE_TOLERANCE of phase 3's sw_score median; the battery's ten rows
    in bench_workloads.py's order; scaling exact at 1, 2 and 4 shards of
    cuda:0; the N-process totals identical at N = 1 and 2."""
    from mini_parallel_tpu_torch.bench.workloads import ROWS

    t_phase = time.perf_counter()
    out = {name: bench_rows(name, argv, limit)
           for name, argv, limit in BENCH_RUNS}
    for name, rows in out.items():
        for row in rows:
            card = row.get("device") or {}
            check(row.get("correct") is True,
                  f"bench.{name} row {row.get('metric')} is not correct")
            check(card.get("nvidia_smi") == info["nvidia_smi"]
                  and card.get("power_limit_w") is not None,
                  f"bench.{name} row {row.get('metric')} has card fields "
                  f"{card}, not {info['nvidia_smi']!r}")

    (head,) = out["headline"]
    ms = head["extra"]["batch_latency_ms"]
    print(f"[23 headline] {head['metric']}: {head['value']:.1f} GCUPS, "
          f"{ms:.4f} ms (min {head['extra']['min_ms']:.4f}, max "
          f"{head['extra']['max_ms']:.4f}) beside phase 3's sw_score "
          f"{sw_kernel_ms:.4f} ms; bound {head['bound_ms']:.4f} ms, share "
          f"{head['bound_share']:.3f}; vs_baseline {head['vs_baseline']:.1f}",
          flush=True)
    check(abs(ms - sw_kernel_ms) <= HEADLINE_TOLERANCE * sw_kernel_ms,
          f"headline {ms:.4f} ms is not within "
          f"{HEADLINE_TOLERANCE:.0%} of phase 3's {sw_kernel_ms:.4f} ms")

    names = [r["metric"] for r in out["workloads"]]
    check(names == list(ROWS), f"battery rows {names} != {list(ROWS)}")
    for r in out["workloads"]:
        print(f"[23 workloads] {r['metric']}: {r['value']:.1f} reads/s "
              f"(median of {r['count']}; min {r['min']:.1f}, max "
              f"{r['max']:.1f}) | launches {r['extra']['kernel_launches']}",
              flush=True)

    step = out["scaling"][0]
    for r in step["rows"]:
        print(f"[23 scaling] {r['devices']} shards of cuda:0: "
              f"{r['reads_per_s']:.0f} reads/s, {r['batch_ms']:.4f} ms "
              f"(min {r['min_ms']:.4f}, max {r['max_ms']:.4f}), efficiency "
              f"{r['scaling_efficiency']:.3f}, exact "
              f"{r['stats_bit_exact_vs_local']}", flush=True)
    check([r["devices"] for r in step["rows"]] == [1, 2, 4]
          and all(r["stats_bit_exact_vs_local"] for r in step["rows"]),
          "the sharded WGS step differs from one shard")
    check(step["performance_representative"] is False,
          "shards of one card were called representative")

    sizes = [r for r in out["multiprocess"] if "nproc" in r]
    for r in sizes:
        print(f"[23 multiprocess] N={r['nproc']}: merged {r['merged']}, "
              f"slowest {r['max_wall_seconds']:.2f} s, all-gathers "
              f"{r['allgather_calls']} ({r['allgather_bytes_out']} bytes "
              f"out), work inflation {r['work_inflation']:.3f}", flush=True)
    check([r["nproc"] for r in sizes] == [1, 2]
          and sizes[0]["merged"] == sizes[1]["merged"],
          "the N-process totals differ between N = 1 and 2")
    wall = time.perf_counter() - t_phase
    print(f"[23 wall] phase 23: {wall:.2f} s", flush=True)
    check(wall < BENCH_PHASE_LIMIT_S,
          f"phase 23 took {wall:.2f} s, over {BENCH_PHASE_LIMIT_S} s")
    return out


def report_shares(kernels: list[dict], peak_instr: float) -> None:
    """Each kernel's time against its bound; for the int32 kernels also
    against the measured ceiling: the chain's instruction rate in place of
    the estimated int32 rate."""
    from mini_parallel_tpu_torch.tools.roofline import INT32_OPS_PER_S

    for k in kernels:
        share = k["bound_ms"] / k["ms"]
        line = (f"[17 shares] {k['name']}: {k['ms']:.4f} ms, {100 * share:.1f}"
                f" % of its bound ({k['bound_by']})")
        if not k["name"].startswith("pairhmm") and k["bound_by"] == "operations":
            line += (f", {100 * share * INT32_OPS_PER_S / peak_instr:.1f} % of "
                     "the measured int32 instruction rate")
        print(line, flush=True)


def kernel_entry(name: str, replaces: str, source: str, launches: int,
                 max_err, ms: float, plain_ms: float, cells: float,
                 nbytes: float, rate: float | None = None,
                 library_ms: float | None = None) -> dict:
    """One kernel's line of the JSON result, with its bound computed from
    this run's cells and bytes: the larger of cells x OPS_PER_CELL over
    ``rate`` (the int32 rate unless given) and bytes over the HBM rate. A
    kernel of no DP cells (``cells`` 0) is bound by its bytes alone."""
    from mini_parallel_tpu_torch.tools.roofline import (
        HBM_BYTES_PER_S,
        INT32_OPS_PER_S,
        OPS_PER_CELL,
    )

    ops_ms = (cells * OPS_PER_CELL[name] / (rate or INT32_OPS_PER_S) * 1e3
              if cells else 0.0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"name": name, "route": "cuda",
            "source": f"mini_parallel_tpu_torch/csrc/{source}",
            "replaces": f"mini_parallel_tpu/{replaces}",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


PR_SET_CHILD_SUBREAPER = 36  # linux/prctl.h
STOP_GRACE_S = 5.0  # SIGTERM to SIGKILL


def adopt_orphans() -> None:
    """Make this process the subreaper of every process it starts: one
    whose parent ends first is re-parented here, not to init, so that
    stop_descendants still finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"prctl(PR_SET_CHILD_SUBREAPER): {os.strerror(err)}")


def descendants() -> dict[int, str]:
    """Every live (not zombie) process below this one, from /proc: pid ->
    its command line."""
    children: dict[int, list[int]] = {}
    live = set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue  # ended meanwhile
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        children.setdefault(int(ppid), []).append(int(entry))
        if state != "Z":
            live.add(int(entry))
    found, todo = {}, [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), []):
            todo.append(pid)
            if pid in live:
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        found[pid] = f.read().replace(b"\0", b" ").decode(
                            errors="replace").strip()
                except OSError:
                    found[pid] = "?"
    return found


def reap() -> None:
    """Collect every child of this process that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants() -> int:
    """End every process below this one that is still running: SIGTERM,
    then SIGKILL after STOP_GRACE_S; each reaped. Names what it found on
    stderr and returns how many there were; raises if one outlives
    SIGKILL."""
    import signal

    reap()
    found = descendants()
    for pid, cmd in found.items():
        print(f"chip_smoke: process {pid} still running, stopping it: "
              f"{cmd[:300]}", file=sys.stderr, flush=True)
    left = found
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + STOP_GRACE_S
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            reap()
            left = descendants()
        if not left:
            break
    check(not left, f"processes outlived SIGKILL: {left}")
    return len(found)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "CUDA card", file=sys.stderr)
        return 1
    adopt_orphans()
    try:
        return drive()
    finally:
        stop_descendants()


def drive() -> int:
    """Phases 1-24; main has checked for the card."""
    import torch

    from mini_parallel_tpu_torch.device import require_cuda
    from mini_parallel_tpu_torch.models.variant_prep import VariantPrepEngine
    from mini_parallel_tpu_torch.tools import roofline
    from mini_parallel_tpu_torch.utils.config import Config

    device = require_cuda()
    rng = np.random.default_rng(SEED)
    info = phase_card()
    main_pairs, max_err = phase_compare(rng, device)
    kernel_ms, plain_ms = phase_times(main_pairs, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, env_path, results_dir, total_bases = phase_main_path(
            rng, tmp)
        affine_err = phase_affine_compare(rng, main_pairs, device)
        long_err = phase_long_compare(rng, device)
        times = phase_new_times(rng, main_pairs, device)
        slice_launches, scale_err = phase_slice_paths(
            rng, tmp, env_path, results_dir, total_bases, device)
        fx = phase_variant_fixtures(rng, tmp)
        cfg = Config(chunk_size_reads=CHUNK_READS)
        eng = VariantPrepEngine(fx["contigs"], cfg,
                                min_base_quality=PILEUP_MIN_QUALITY,
                                device=device)
        chunk = real_chunk(eng, fx["L1"], device)
        vs_ref = phase_vs_ref_compare(rng, eng, fx, chunk, device)
        moves = phase_moves_compare(rng, chunk, (cfg.gap_open,
                                                 cfg.gap_extend), device)
        pileup = phase_pileup_compare(eng, chunk, (cfg.gap_open,
                                                   cfg.gap_extend), device)
        phase_align(np.random.default_rng(SEED + 12),
                    (cfg.gap_open, cfg.gap_extend), device)
        del eng, chunk
        vp_launches = phase_variant_paths(fx, env_path, tmp, device)
        genotype = phase_genotype(fx, env_path, device)
        phmm = phase_pairhmm_compare(rng, genotype.pop("operand"), device)
        phase_native_plane(info, tmp, env_path, results_dir, total_bases, fx)
        phase_kmer(tmp, fx, env_path, device)
        phase_profiles(tmp, env_path, results_dir, fx, genotype["wall"])
        phase_tools(tmp, results_dir)
        phase_parallel(rng, tmp, fx, main_pairs, total_bases, device)
        phase_bench(info, kernel_ms)
    chain = phase_roofline(device)
    main_cells = float(MAIN_B) * MAIN_LEN * MAIN_LEN
    main_bytes = float(2 * MAIN_B * MAIN_PAD + 4 * MAIN_B)
    kernels = [
        kernel_entry("sw_score", "ops/sw_pallas.py:106", "sw_score.cu",
                     launches, max_err, kernel_ms, plain_ms, main_cells,
                     main_bytes),
        kernel_entry("sw_affine_score", "ops/sw_pallas.py:585",
                     "sw_affine_score.cu", slice_launches["sw_affine_score"],
                     affine_err, times["affine_ms"], times["affine_plain_ms"],
                     main_cells, main_bytes),
        *(kernel_entry(key, f"ops/sw_long.py:{line}", "sw_long.cu",
                       slice_launches[key], max(long_err, scale_err),
                       times[f"{tkey}_ms"], times[f"{tkey}_plain_ms"],
                       float(CMP_M) * CMP_N, float(CMP_M + CMP_N))
          for key, tkey, line in (("sw_long", "long", 71),
                                  ("sw_long_affine", "long_affine", 539))),
        kernel_entry("sw_vs_ref", "ops/sw_pallas.py:477", "sw_vs_ref.cu",
                     vp_launches["sw_vs_ref"], vs_ref["max_err"],
                     vs_ref["ms"], vs_ref["plain_ms"], vs_ref["cells"],
                     vs_ref["bytes"]),
        *(kernel_entry(key, f"ops/sw_traceback.py:{line}", "sw_moves.cu",
                       vp_launches[key], moves["max_err"], moves[key]["ms"],
                       moves[key]["plain_ms"], moves[key]["cells"],
                       moves[key]["bytes"])
          for key, line in (("sw_moves", 148), ("sw_affine_moves", 800))),
        *(kernel_entry(key, "ops/pairhmm_pallas.py:49", "pairhmm.cu",
                       genotype["launches"][key], phmm[f64]["max_err"],
                       phmm[f64]["ms"], phmm[f64]["plain_ms"],
                       phmm[f64]["cells"], phmm[f64]["bytes"], rate)
          for key, f64, rate in (("pairhmm", False, roofline.FP32_OPS_PER_S),
                                 ("pairhmm_f64", True, roofline.FP64_OPS_PER_S))),
        kernel_entry("roofline_chain", "tools/roofline.py:72", "roofline.cu",
                     chain["launches"], 0, chain["ms"], chain["plain_ms"],
                     chain["steps"], chain["bytes"]),
        kernel_entry("pileup", "models/variant_prep.py:279", "pileup.cu",
                     vp_launches["pileup"], pileup["max_err"],
                     pileup["masked"]["ms"], pileup["masked"]["plain_ms"], 0,
                     pileup["masked"]["bytes"],
                     library_ms=pileup["masked"]["library_ms"]),
    ]
    report_shares(kernels, chain["peak_instr"])
    print(f"[24 stop] processes still running below the script at its end:"
          f" {stop_descendants()} (each named on stderr, stopped and reaped)",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
