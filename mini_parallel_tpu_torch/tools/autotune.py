"""Sweep the launch parameters the port's kernel wrappers take, on this
card. The counterpart of mini_parallel_tpu/tools/autotune.py, whose knobs
(MPT_SW_BLOCK, MPT_SW_UNROLL, MPT_SW_CHAIN, MPT_PHMM_UNROLL) shape the TPU
kernels and mean nothing here.

    python -m mini_parallel_tpu_torch.tools.autotune [--allow-cpu] [...]

Three sweeps:

1. ``sw_vs_ref_batch_cuda(reads, ref, segment=S)``: a rescue-sized batch
   (--reads x 150 bp) against --ref-len random bases (0 is the kernel's
   default width).
2. The long engine's ``strip_width`` (``sw_score_long`` and
   ``sw_affine_score_long``) at --long-m x --long-n.
3. One pair of n x n bases, n in --sizes: the batched kernel at B = 1
   (``sw_score_batch_cuda``) against the long engine, the crossover that
   ``AlignmentEngine.LONG_PAIR_THRESHOLD`` (2048) stands for.

Each candidate is first held to the plain version on a small shape; a
candidate that disagrees or fails is reported and left out. Survivors are
timed with CUDA events, the median of --repeats. Each winner is printed as
the call argument that selects it. The tool sets no environment variable
and changes no default. ``--allow-cpu`` runs the same sweeps on the plain
versions (``ops.sw.sweep_segments`` is the plain mirror of the segment
split) with the host clock: it exercises the sweep, its times are not the
card's.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from mini_parallel_tpu_torch.ops import encode

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _put(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dev)


def timed_ms(fn, dev, repeats: int) -> float:
    """Median ms of one call over ``repeats`` after a warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    samples = []
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def sweep(label: str, candidates, run, check, dev, repeats: int, echo):
    """``check(c)`` on a small shape, then ``run(c)`` timed, for each
    candidate -> {candidate: ms} of those that passed."""
    times = {}
    for c in candidates:
        try:
            if not check(c):
                echo(f"{label}{c}: WRONG RESULT on the small shape")
                continue
            times[c] = timed_ms(lambda: run(c), dev, repeats)
            echo(f"{label}{c}: {times[c]:.4f} ms")
        except Exception as e:  # noqa: BLE001 — report and keep sweeping
            echo(f"{label}{c}: FAILED {type(e).__name__}: {str(e)[-160:]}")
    return times


def vs_ref_call(dev, segment: int):
    """The reads-vs-reference call at ``segment``: the kernel on the card,
    the plain segment mirror (or the plain sweep at 0) on the CPU."""
    from mini_parallel_tpu_torch.ops import sw
    from mini_parallel_tpu_torch.ops.sw_cuda import sw_vs_ref_batch_cuda

    if dev.type == "cuda":
        return lambda reads, ref: sw_vs_ref_batch_cuda(reads, ref,
                                                       segment=segment)
    if segment:
        return lambda reads, ref: sw.sweep_segments(reads, ref, segment)
    return sw.sw_vs_ref_batch


def sweep_segments(args, rng, dev, echo) -> dict:
    from mini_parallel_tpu_torch.ops import sw

    def operands(n_reads: int, ref_len: int):
        ref = rng.choice(ACGT, ref_len)
        starts = rng.integers(0, ref_len - 150, n_reads)
        reads = np.stack([ref[s:s + 150] for s in starts])
        reads[rng.random(reads.shape) < 0.02] = ord("T")
        arr = np.full((n_reads, 152), encode.PAD_A, np.uint8)
        arr[:, :150] = reads
        return _put(arr, dev), _put(ref, dev)

    small = operands(16, 20_000)
    want = sw.sw_vs_ref_batch(*small)
    full = operands(args.reads, args.ref_len)
    times = sweep(f"sw_vs_ref {args.reads} x 150 vs {args.ref_len}: segment=",
                  args.segments,
                  lambda s: vs_ref_call(dev, s)(*full),
                  lambda s: all(torch.equal(g, w) for g, w in
                                zip(vs_ref_call(dev, s)(*small), want)),
                  dev, args.repeats, echo)
    if times:
        best = min(times, key=times.get)
        echo(f"winner: sw_vs_ref_batch_cuda(reads, ref, segment={best}) "
             f"{times[best]:.4f} ms")
    return times


def sweep_strips(args, rng, dev, echo) -> dict:
    from mini_parallel_tpu_torch.ops import sw_long

    out = {}
    a_small = rng.choice(ACGT, 1_000).tobytes()
    b_small = rng.choice(ACGT, 1_500).tobytes()
    a = rng.choice(ACGT, args.long_m).tobytes()
    b = rng.choice(ACGT, args.long_n).tobytes()
    for name, fn, golden in (
            ("sw_score_long", sw_long.sw_score_long,
             sw_long.sw_score_numpy_blocked),
            ("sw_affine_score_long", sw_long.sw_affine_score_long,
             sw_long.sw_affine_numpy_blocked)):
        want = golden(a_small, b_small)
        times = sweep(f"{name} {args.long_m} x {args.long_n}: strip_width=",
                      args.strip_widths,
                      lambda w, fn=fn: fn(a, b, dev, strip_width=w),
                      lambda w, fn=fn, want=want: fn(
                          a_small, b_small, dev, strip_width=w) == want,
                      dev, args.repeats, echo)
        if times:
            best = min(times, key=times.get)
            echo(f"winner: {name}(a, b, device, strip_width={best}) "
                 f"{times[best]:.4f} ms")
        out[name] = times
    return out


def sweep_crossover(args, rng, dev, echo) -> dict:
    from mini_parallel_tpu_torch.ops import sw, sw_long
    from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_best

    def batched(a: bytes, b: bytes) -> int:
        ta = _put(np.frombuffer(a, np.uint8), dev)[None, :]
        tb = _put(np.frombuffer(b, np.uint8), dev)[None, :]
        return int(sw_score_batch_best(ta, tb)[0])

    def long_engine(a: bytes, b: bytes) -> int:
        return sw_long.sw_score_long(a, b, dev)

    engines = {"sw_score_batch_cuda at B = 1": batched,
               "sw_score_long": long_engine}
    x = rng.choice(ACGT, 300).tobytes()
    y = rng.choice(ACGT, 300).tobytes()
    want = sw.sw_score_numpy(x, y)
    out = {}
    for n in args.sizes:
        a = rng.choice(ACGT, n).tobytes()
        b = bytearray(rng.choice(ACGT, n).tobytes())
        b[n // 4:n // 2] = a[n // 4:n // 2]  # a shared segment
        b = bytes(b)
        times = sweep(f"one {n} x {n} pair: ", list(engines),
                      lambda e: engines[e](a, b),
                      lambda e: engines[e](x, y) == want,
                      dev, args.repeats, echo)
        if len(times) == len(engines):
            scores = {e: engines[e](a, b) for e in engines}
            if len(set(scores.values())) != 1:
                echo(f"  the engines disagree at {n}: {scores}")
        if times:
            best = min(times, key=times.get)
            echo(f"winner at {n} x {n}: {best} {times[best]:.4f} ms")
        out[n] = times
    longer = [n for n, t in out.items() if len(t) == len(engines)
              and t["sw_score_long"] < t["sw_score_batch_cuda at B = 1"]]
    if longer:
        echo(f"crossover: the long engine wins from {min(longer)} x "
             f"{min(longer)} on (AlignmentEngine.LONG_PAIR_THRESHOLD is "
             "2048; this tool does not change it)")
    return out


def main(argv=None, echo=print) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=222,
                    help="reads of the vs-reference sweep (a --rescue chunk)")
    ap.add_argument("--ref-len", type=int, default=2_000_000)
    ap.add_argument("--segments", type=int, nargs="*",
                    default=[0, 2048, 4096, 16384, 32768])
    ap.add_argument("--long-m", type=int, default=20_000)
    ap.add_argument("--long-n", type=int, default=15_000)
    ap.add_argument("--strip-widths", type=int, nargs="*",
                    default=[256, 512, 1024, 2048, 4096])
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[1024, 2048, 4096, 8192])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--allow-cpu", action="store_true",
                    help="sweep the plain versions on the CPU (host clock; "
                    "not the card's times)")
    args = ap.parse_args(argv)
    if args.allow_cpu:
        dev = torch.device("cpu")
        echo("autotune on the CPU: plain versions, host clock (not card "
             "times)")
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
        echo(f"autotune on {torch.cuda.get_device_name(dev)}")
    else:
        echo("FAIL: autotune times the card's kernels and finds no CUDA "
             "card (--allow-cpu sweeps the plain versions)")
        return 1
    rng = np.random.default_rng(0)
    results = [sweep_segments(args, rng, dev, echo),
               *sweep_strips(args, rng, dev, echo).values(),
               *sweep_crossover(args, rng, dev, echo).values()]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
