#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions; build
   the SW kernel from mini_parallel_tpu_torch/csrc and report its build
   seconds and ptxas's register counts.
2. Kernel vs plain PyTorch version on the card, exact integer equality: the
   main path's shape (10,000 seeded pairs x 150 bp, padded to 152), ragged
   geometries (M != N, B not a multiple of the block, empty rows, identical
   strings, N bases, multi-stripe rows, one 2048 x 2048 pair), and 16 pairs
   against the NumPy golden.
3. Times of kernel and plain version at 10,000 x 152 (CUDA events, warm-up,
   median of 7), as ms and GCUPS over 10,000 x 150 x 150 cells.
4. Main path: seeded FASTQ.gz fixtures (4 files x 100,000 reads, ~0.1% N,
   one file ragged), ``cli.main(["--full-wgs", "--mode", "sw", ...])`` and
   the same in kadane mode, then sw again, which must resume from its
   checkpoint and skip every file. The sw total must be 2 x bases, the
   kadane total 2 x the chunks of >= 1000 bases, no chunk may fail, and the
   kernel must have launched once per sw chunk.

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
    import torch

    from mini_parallel_tpu_torch import _build
    from mini_parallel_tpu_torch.device import device_info
    from mini_parallel_tpu_torch.ops import sw_cuda

    info = device_info()
    print(f"[1 card] {info['nvidia_smi']} | count {info['count']} | "
          f"torch {torch.__version__} | CUDA {torch.version.cuda}", flush=True)
    path, seconds = _build.build(sw_cuda.KERNEL_NAME, sw_cuda.KERNEL_SOURCES)
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


def time_samples(fn, launches: int) -> list[float]:
    """REPEATS CUDA-event times per call (ms), ``launches`` calls between
    the events, after one warm-up call."""
    import torch

    fn()
    samples = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / launches)
    return samples


def phase_times(main_pairs, device):
    """Plain, kernel, kernel, plain; each time is the median of its two
    rounds' samples."""
    from mini_parallel_tpu_torch.ops import sw, sw_cuda

    a, b = pair_batch(*main_pairs, MAIN_PAD, MAIN_PAD, device)
    cells = MAIN_B * MAIN_LEN * MAIN_LEN
    plain = time_samples(lambda: sw.sw_score_batch(a, b), 1)
    kernel = time_samples(lambda: sw_cuda.sw_score_batch_cuda(a, b), 20)
    kernel += time_samples(lambda: sw_cuda.sw_score_batch_cuda(a, b), 20)
    plain += time_samples(lambda: sw.sw_score_batch(a, b), 1)
    times = {"kernel": kernel, "plain": plain}
    for name, samples in times.items():
        ms = statistics.median(samples)
        print(f"[3 time] {name} 10000x150 (pad 152): {ms:.4f} ms median of "
              f"{len(samples)} ({cells / ms / 1e6:.1f} GCUPS; min "
              f"{min(samples):.4f}, max {max(samples):.4f} ms)", flush=True)
    return statistics.median(kernel), statistics.median(plain)


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


def phase_main_path(rng):
    import torch

    from mini_parallel_tpu_torch.ops import sw_cuda

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
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
    return launches


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
    launches = phase_main_path(rng)
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
