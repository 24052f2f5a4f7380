#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's entry points once on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions; build
   the three kernel sources of mini_parallel_tpu_torch/csrc (one nvcc each,
   started together) and report their build seconds and ptxas's register
   counts.
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
   affine: one strip with carried columns, 20,000 x 15,000 host loops at
   two strip widths, 3,000 x 5,000 against the blocked goldens (a segment
   and a gap across a strip edge), an identical 100,000-base pair (2n),
   empty sides.
7. Times: the affine kernel and its plain version at 10,000 x 152; the
   long kernel at 200,000 x 150,000 and, with its plain host loop, at
   20,000 x 15,000; the batched kernel at B = 1 against the long kernel at
   2048^2 and 8192^2.
8. This slice's entry points through ``cli.main``: --full-wgs in sw-affine
   (total 2 x bases, one affine launch per chunk) and contiguous; --files
   in all four modes (sw and sw-affine equal to the plain version over the
   same mates); --complementarity on 100,000 mates with exactly 10% broken
   (10.00 %); --long-align at 200,000 x 150,000 with a 50,000-base shared
   segment, sw and sw-affine, each equal to a direct call at a narrower
   strip width and to the plain per-strip host loop at the same size, and
   the pair's first two 200,000 x 8192 strips (strip 1 with strip 0's
   carried columns) kernel == plain on the best score and the carried
   columns. Kernel counts are zeroed before each path and read after.

Then one JSON line of kernel results, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits 1 without.
"""

from __future__ import annotations

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

    from mini_parallel_tpu_torch import _build
    from mini_parallel_tpu_torch.device import device_info
    from mini_parallel_tpu_torch.ops import sw_cuda, sw_long

    info = device_info()
    print(f"[1 card] {info['nvidia_smi']} | count {info['count']} | "
          f"torch {torch.__version__} | CUDA {torch.version.cuda}", flush=True)
    libs = [(sw_cuda.KERNEL_NAME, sw_cuda.KERNEL_SOURCES),
            (sw_cuda.AFFINE_KERNEL_NAME, sw_cuda.AFFINE_KERNEL_SOURCES),
            (sw_long.KERNEL_NAME, sw_long.KERNEL_SOURCES)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(lambda lib: _build.build(*lib), libs))
    print(f"[1 build] {len(libs)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
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


def phase_main_path(rng, tmp: str):
    """Returns the kernel launches of the sw run and the fixture facts the
    later phases reuse: (launches, env path, results dir, total bases)."""
    import torch

    from mini_parallel_tpu_torch.ops import sw_cuda

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
        print(f"[6 strip] {label} one strip {CMP_M} x 8192, carried columns "
              f"in: best {int(got[0])} kernel==plain (best and right "
              f"columns) {err == 0} max_abs_err {err}", flush=True)
        check(err == 0, f"{label} strip kernel != plain")

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


def _plain_long(fn, a, b, device, width):
    """``fn``'s host loop with the plain per-strip function on the card."""
    from mini_parallel_tpu_torch.ops import sw_long

    real = sw_long.strip_best
    sw_long.strip_best = lambda affine, dev: (sw_long.sw_affine_strip
                                              if affine else sw_long.sw_strip)
    try:
        return fn(a, b, device, strip_width=width)
    finally:
        sw_long.strip_best = real


def phase_new_times(rng, main_pairs, device):
    """Affine kernel vs plain at 10,000 x 152 (plain, kernel, kernel,
    plain); the long kernel at 200,000 x 150,000 and its plain host loop
    at 20,000 x 15,000; the batched kernel at B = 1 against the long
    kernel at 2048^2 and 8192^2 (the LONG_PAIR_THRESHOLD crossover)."""
    from mini_parallel_tpu_torch.ops import sw, sw_cuda, sw_long

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

    la, lb = long_pair(rng, LONG_M, LONG_N)
    for fn in (sw_long.sw_score_long, sw_long.sw_affine_score_long):
        report_time(7, f"{fn.__name__} kernel {LONG_M} x {LONG_N}",
                    time_samples(lambda: fn(la, lb, device), repeats=3),
                    float(LONG_M) * LONG_N)
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
    long_launches = long_err = 0
    for mode, affine, fn in (("sw", False, sw_long.sw_score_long),
                             ("sw-affine", True, sw_long.sw_affine_score_long)):
        zero()
        lines, wall = cli_lines(["--long-align", "-1", fa, "-2", fb, "--mode",
                                 mode] + env)
        strips = counters[2].launches + counters[3].launches
        long_launches += strips
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
    launches["sw_long"] = long_launches
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
    return max_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "CUDA card", file=sys.stderr)
        return 1
    from mini_parallel_tpu_torch.device import require_cuda

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
    print(json.dumps({"kernels": [{
        "name": "sw_score",
        "route": "cuda",
        "source": "mini_parallel_tpu_torch/csrc/sw_score.cu",
        "replaces": "mini_parallel_tpu/ops/sw_pallas.py:106",
        "also_replaces": "mini_parallel_tpu/ops/sw_pallas.py:317",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "sw_affine_score",
        "route": "cuda",
        "source": "mini_parallel_tpu_torch/csrc/sw_affine_score.cu",
        "replaces": "mini_parallel_tpu/ops/sw_pallas.py:585",
        "also_replaces": "mini_parallel_tpu/ops/sw_pallas.py:637",
        "launches": slice_launches["sw_affine_score"],
        "max_abs_err": affine_err,
        "ms": times["affine_ms"],
        "plain_ms": times["affine_plain_ms"],
    }, {
        "name": "sw_long",
        "route": "cuda",
        "source": "mini_parallel_tpu_torch/csrc/sw_long.cu",
        "replaces": "mini_parallel_tpu/ops/sw_long.py:71",
        "also_replaces": "mini_parallel_tpu/ops/sw_long.py:539",
        "launches": slice_launches["sw_long"],
        "max_abs_err": max(long_err, scale_err),
        "ms": times["long_ms"],
        "plain_ms": times["long_plain_ms"],
    }]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
