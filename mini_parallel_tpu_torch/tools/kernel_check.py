"""Kernel parity gate on the card: every hand-written kernel against its
plain PyTorch version and a golden. The counterpart of
mini_parallel_tpu/tools/kernel_check.py.

    python -m mini_parallel_tpu_torch.tools.kernel_check [--seed N] [--reads B]

Interpret-mode or CPU parity says nothing of what nvcc built, so the gate
runs on the card: each row runs the port's kernel on CUDA tensors and holds
it to its plain version on the same tensors, exactly (every lane equal for
the Pair-HMM), and the plain version to a golden. It has the JAX tool's 14
rows, in its order, and one more for the 11th kernel:

- kadane-parity: the torch Kadane parity score (no kernel) == the
  reference emulation ``kadane.reference_align_score``.
- sw-wavefront / sw-affine: ``csrc/sw_score.cu`` / ``csrc/sw_affine_score.cu``
  == ``sw_score_batch`` / ``sw_affine_batch`` on B pairs; the plain version
  == the quadratic NumPy golden on the first GOLDEN_PAIRS.
- sw-chained / sw-affine-chained: the port has one kernel for the JAX
  package's two forms, so these rows run the same kernels at the chained
  form's shapes: 2B + 1 pairs (a ragged last block), each pair of equal
  lengths, padded to a multiple of 8.
- sw-vs-ref: ``csrc/sw_vs_ref.cu`` == ``sw_vs_ref_batch`` (scores and
  smallest ends) == an anti-diagonal NumPy golden, B reads against 2 kb.
- sw-positions: the traceback positions of the plain scan + walk and of
  ``csrc/sw_moves.cu`` == a host CIGAR walk of ``sw_align_numpy``.
- sw-positions-pallas / sw-affine-positions-pallas (the JAX package's
  packed-moves kernels): ``csrc/sw_moves.cu`` linear / affine == the plain
  scans and walks on best, bd, bi, positions and every cell's move.
- pairhmm-fwd: ``csrc/pairhmm.cu`` in float32 and float64 == plain
  ``pairhmm_batch`` on every lane, and the product API
  (``pairhmm_log10_batch``, float64 recompute of underflowed lanes) within
  1e-3 log10 of the float64 oracle on the first GOLDEN_PAIRS.
- kmer-rle / kmer-summary: the torch k-mer counts (no kernel) and the
  device accumulator's distinct count, histogram and top 10 ==
  ``count_kmers_python``.
- sw-long-strips / sw-affine-long-strips: ``csrc/sw_long.cu`` at LONG_M x
  LONG_N (30,000 x 40,000) with a shared segment planted across a strip
  edge (split by an insertion in the affine row) == the plain group
  functions on the card == ``sw_*_numpy_blocked``.
- roofline-chain (the 11th kernel, ``tools/roofline.py:measure_peak_chain``):
  ``csrc/roofline.cu`` == ``roofline_chain`` == a NumPy chain.

Prints one PASS/FAIL row per check (a crash in a row is a FAIL) and exits 1
on any failure. Without CUDA it prints FAIL and exits 1; ``--allow-cpu``
runs the plain versions against the goldens on the CPU, which is not the
gate. Wired into tools/smoke.py as its first row.
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from mini_parallel_tpu_torch.ops import encode

GOLDEN_PAIRS = 16  # pairs each quadratic Python-loop golden checks
LONG_M, LONG_N = 30_000, 40_000  # the long rows' pair (the JAX tool's)
LONG_SEGMENT, LONG_A_AT, LONG_B_AT = 3_000, 5_000, 31_000
CHAIN_ROWS = 16  # rows of the roofline tile the chain row checks (phase 16
# of chip_smoke.py holds the whole tile)


def _rand_reads(rng, n, lo, hi):
    base = np.frombuffer(b"ACGT", np.uint8)
    return [bytes(rng.choice(base, int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _put(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dev)  # a writable copy


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _pairs(reads_a, reads_b, pad: int, dev):
    arr_a, la = encode.pad_batch(reads_a, pad_to=pad,
                                 pad_value=int(encode.PAD_A))
    arr_b, lb = encode.pad_batch(reads_b, pad_to=pad,
                                 pad_value=int(encode.PAD_B))
    return _put(arr_a, dev), _put(arr_b, dev), la, lb


def check_kadane(rng, B, dev):
    from mini_parallel_tpu_torch.ops import kadane

    reads_a = _rand_reads(rng, B, 40, 200)
    reads_b = _rand_reads(rng, B, 40, 200)
    a, b, la, lb = _pairs(reads_a, reads_b, 256, dev)
    got = kadane.kadane_score_batch(a, b, _put(la, dev), _put(lb, dev))
    want = [kadane.reference_align_score(x, y)
            for x, y in zip(reads_a, reads_b)]
    return got.cpu().tolist() == want, f"{B} pairs (torch ops, no kernel)"


def _score_row(rng, B, dev, lo, hi, pad, plain, kernel, golden,
               chained=False):
    """A batched score kernel == its plain version on every pair; the plain
    version == the golden on the first GOLDEN_PAIRS."""
    if chained:
        B = 2 * B + 1
        reads_a = _rand_reads(rng, B, lo, hi)
        reads_b = [_rand_reads(rng, 1, len(x), len(x))[0] for x in reads_a]
    else:
        reads_a = _rand_reads(rng, B, lo, hi)
        reads_b = _rand_reads(rng, B, lo, hi)
    a, b, _, _ = _pairs(reads_a, reads_b, pad, dev)
    want = plain(a, b)
    n = min(GOLDEN_PAIRS, B)
    ok = want[:n].cpu().tolist() == [golden(x, y) for x, y in
                                     zip(reads_a[:n], reads_b[:n])]
    detail = f"plain == golden on {n} pairs"
    if _on_card(dev):
        ok &= torch.equal(kernel(a, b), want)
        detail = f"kernel == plain on {B} pairs, {detail}"
    return ok, detail + (" (chained-form shapes)" if chained else "")


def check_sw(rng, B, dev, chained=False):
    from mini_parallel_tpu_torch.ops import sw
    from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_cuda

    return _score_row(rng, B, dev, 100, 150, 152, sw.sw_score_batch,
                      sw_score_batch_cuda, sw.sw_score_numpy, chained)


def check_sw_affine(rng, B, dev, chained=False):
    from mini_parallel_tpu_torch.ops import sw
    from mini_parallel_tpu_torch.ops.sw_cuda import sw_affine_batch_cuda

    return _score_row(rng, B, dev, 80, 120, 128, sw.sw_affine_batch,
                      sw_affine_batch_cuda, sw.sw_affine_numpy, chained)


def check_sw_chained(rng, B, dev):
    return check_sw(rng, B, dev, chained=True)


def check_sw_affine_chained(rng, B, dev):
    return check_sw_affine(rng, B, dev, chained=True)


def vs_ref_golden(arr: np.ndarray, ref: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Each padded row of ``arr`` against ``ref`` by an anti-diagonal NumPy
    sweep: (best linear-gap SW scores, the smallest reference index of a
    cell at the best, -1 at 0). Pad bytes never match, so a pad row's
    cells stay below the best of the rows above them."""
    from mini_parallel_tpu_torch.ops.sw import (
        GAP_PENALTY,
        MATCH_SCORE,
        MISMATCH_PENALTY,
    )

    a = arr.astype(np.int64)
    b = np.frombuffer(ref, np.uint8).astype(np.int64)
    B, M = a.shape
    N = b.size
    prev2 = np.zeros((B, M + 1), np.int64)  # H on diagonal d-2, at i + 1
    prev = np.zeros((B, M + 1), np.int64)  # H on diagonal d-1
    best = np.zeros(B, np.int64)
    end = np.full(B, N, np.int64)
    for d in range(M + N - 1):
        i = np.arange(max(0, d - N + 1), min(d, M - 1) + 1)
        j = d - i
        s = np.where(a[:, i] == b[j], MATCH_SCORE, MISMATCH_PENALTY)
        h = np.maximum(np.maximum(prev2[:, i] + s, np.maximum(
            prev[:, i], prev[:, i + 1]) + GAP_PENALTY), 0)
        top = h.max(axis=1)
        first = np.where(h == top[:, None], j[None, :], N).min(axis=1)
        end = np.where(top > best, first,
                       np.where(top == best, np.minimum(end, first), end))
        best = np.maximum(best, top)
        cur = np.zeros((B, M + 1), np.int64)
        cur[:, i + 1] = h
        prev2, prev = prev, cur
    return best, np.where(best > 0, end, -1)


def check_sw_vs_ref(rng, B, dev):
    from mini_parallel_tpu_torch.ops import sw
    from mini_parallel_tpu_torch.ops.sw_cuda import sw_vs_ref_batch_cuda

    ref = _rand_reads(rng, 1, 2000, 2000)[0]
    reads = []
    for i in range(B):
        start = int(rng.integers(0, 1900))
        r = bytearray(ref[start:start + 80])
        if i % 3 == 0 and len(r) > 10:
            r[7] = ord("A") if r[7] != ord("A") else ord("C")
        if i % 3 == 1 and len(r) > 30:
            del r[20:22]
        reads.append(bytes(r))
    arr, _ = encode.pad_batch(reads, pad_to=88, pad_value=int(encode.PAD_A))
    a, r = _put(arr, dev), _put(np.frombuffer(ref, np.uint8), dev)
    want = sw.sw_vs_ref_batch(a, r)
    gs, ge = vs_ref_golden(arr, ref)
    ok = (np.array_equal(want[0].cpu().numpy(), gs)
          and np.array_equal(want[1].cpu().numpy(), ge))
    if _on_card(dev):
        ok &= _equal(sw_vs_ref_batch_cuda(a, r), want)
    return ok, (f"{B} reads x 2 kb ref, scores + ends: "
                f"{'kernel == ' * _on_card(dev)}plain == golden")


def _gapped_pairs(rng, B, affine):
    reads_a, reads_b = [], []
    for i in range(B):
        b = _rand_reads(rng, 1, 60, 60)[0]
        a = bytearray(b[5:55])
        if i % 3 == 0:
            del a[20:24 if affine else 23]  # affine prefers ONE gap run
        if i % 3 == 1:
            a[10:10] = b"GGGTT" if affine else b"GGG"
        reads_a.append(bytes(a))
        reads_b.append(b)
    return reads_a, reads_b


def check_positions(rng, B, dev):
    from mini_parallel_tpu_torch.ops import sw_traceback as tb
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    reads_a, reads_b = _gapped_pairs(rng, B, affine=False)
    a, b, _, _ = _pairs(reads_a, reads_b, 64, dev)
    want_s = np.zeros(B, np.int32)
    want_p = np.full((B, 64), -1, np.int32)
    for k, (x, y) in enumerate(zip(reads_a, reads_b)):
        aln = tb.sw_align_numpy(x, y)
        want_s[k] = aln.score
        if aln.score <= 0:
            continue
        qi, rj = aln.query_start, aln.ref_start
        for count, op in aln.cigar_ops():
            if op == "M":
                want_p[k, qi:qi + count] = np.arange(rj, rj + count)
                qi += count
                rj += count
            elif op == "I":
                qi += count
            else:
                rj += count
    runs = [("plain", tb.sw_positions_batch(a, b))]
    if _on_card(dev):
        best, _, _, pos = tbc.sw_moves_batch_cuda(a, b)
        runs.append(("kernel", (best, pos)))
    ok = all(np.array_equal(s.cpu().numpy(), want_s)
             and np.array_equal(p.cpu().numpy(), want_p) for _, (s, p) in runs)
    return ok, (f"{B} reads: {' and '.join(n for n, _ in runs)} == host "
                "CIGAR walk")


def _moves_row(rng, B, dev, affine):
    from mini_parallel_tpu_torch.ops import sw_traceback as tb
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    reads_a, reads_b = _gapped_pairs(rng, B, affine)
    a, b, _, _ = _pairs(reads_a, reads_b, 64, dev)
    scan = tb.sw_affine_moves_batch if affine else tb.sw_moves_batch
    walk = tb._affine_walk if affine else tb._positions_walk
    best, bd, bi, moves = scan(a, b)
    pos = walk(best, bd, bi, moves)
    positions = (tb.sw_affine_positions_batch if affine
                 else tb.sw_positions_batch)(a, b)
    ok = _equal(positions, (best, pos))
    what = "affine " if affine else ""
    if not _on_card(dev):
        return ok, f"{B} reads, plain {what}scan + walk (no kernel)"
    kernel = tbc.sw_affine_moves_batch_cuda if affine else tbc.sw_moves_batch_cuda
    got = kernel(a, b, return_moves=True)
    ok &= _equal(got[:4], (best, bd, bi, pos)) and torch.equal(
        tbc.moves_to_cells(got[4], a.shape[1], b.shape[1], affine),
        tb.plain_moves_to_cells(moves, b.shape[1]))
    return ok, (f"{B} reads, {what}moves kernel == plain scan + walk (best, "
                "bd, bi, positions, every cell's move)")


def check_positions_pallas(rng, B, dev):
    return _moves_row(rng, B, dev, affine=False)


def check_positions_affine_pallas(rng, B, dev):
    return _moves_row(rng, B, dev, affine=True)


def check_pairhmm(rng, B, dev):
    from mini_parallel_tpu_torch.ops import pairhmm

    reads = _rand_reads(rng, B, 80, 120)
    haps = _rand_reads(rng, B, 150, 250)
    # half the reads are noisy copies of their haplotype window (realistic
    # high-likelihood lanes); the random half underflows float32 and takes
    # the product API's float64 recompute
    for i in range(0, B, 2):
        h = haps[i]
        r = bytearray(h[10:10 + min(100, len(h) - 10)])
        for _ in range(3):
            j = int(rng.integers(0, len(r)))
            r[j] = ord("ACGT"[int(rng.integers(0, 4))])
        reads[i] = bytes(r)
    quals = [np.full(len(r), 30.0) for r in reads]
    got = pairhmm.pairhmm_log10_batch(reads, quals, haps, device=dev)
    n = min(GOLDEN_PAIRS, B)
    worst = max(abs(float(got[i]) - pairhmm.pairhmm_forward_numpy(
        reads[i], quals[i], haps[i])) for i in range(n))
    ok = worst < 1e-3
    detail = f"product API vs the float64 oracle on {n} lanes, max |dlog10| = {worst:.2e}"
    if _on_card(dev):
        from mini_parallel_tpu_torch.ops import pairhmm_cuda

        arr_r, la = encode.pad_batch(reads, pad_value=int(encode.PAD_A))
        arr_h, lb = encode.pad_batch(haps, pad_value=int(encode.PAD_B))
        err = np.where(np.arange(arr_r.shape[1])[None, :] < la[:, None],
                       10.0 ** -3.0, 0.0)
        ops = [_put(arr_r, dev), None, _put(arr_h, dev), _put(la, dev),
               _put(lb, dev)]
        for dtype, kernel in ((torch.float32, pairhmm_cuda.pairhmm_batch_cuda),
                              (torch.float64,
                               pairhmm_cuda.pairhmm_f64_batch_cuda)):
            ops[1] = _put(err, dev).to(dtype)
            ok &= torch.equal(kernel(*ops),
                              pairhmm.pairhmm_batch(*ops, dtype=dtype))
        detail = (f"kernel == plain on {B} lanes in float32 and float64; "
                  + detail)
    return ok, detail


def check_kmer(rng, B, dev):
    from mini_parallel_tpu_torch.ops import kmer

    reads = _rand_reads(rng, B, 40, 80)
    arr, lens = encode.pad_batch(reads, pad_to=96,
                                 pad_value=int(encode.PAD_A))
    keys, counts, _ = kmer.unique_counts_batch(
        encode.ascii_to_code(_put(arr, dev)), _put(lens, dev), k=21)
    got = {kmer.key_to_string(key, 21): c for key, c in
           zip(keys.cpu().tolist(), counts.cpu().tolist())}
    want = kmer.count_kmers_python(reads, k=21)
    return got == want, f"{B} reads, {len(want)} distinct 21-mers (torch ops)"


def check_kmer_summary(rng, B, dev):
    from mini_parallel_tpu_torch.ops import kmer
    from mini_parallel_tpu_torch.ops import packed as packedmod

    reads = _rand_reads(rng, B, 40, 80)
    reads += reads[: B // 3]  # repeats: populate multi-count bins
    acc = kmer.DeviceKmerAccumulator(capacity=80 * len(reads) + 1,
                                     staging_batches=4)
    arr, lens = encode.pad_batch(reads, pad_to=96,
                                 pad_value=int(encode.PAD_A))
    pb = packedmod.pack_batch(arr, lens)
    keys, counts, _ = kmer.unique_counts_packed(
        *packedmod.device_args(pb, dev), k=21)
    acc.add(keys, counts)
    s = acc.summary(top_n=10, hist_bins=64)
    want = kmer.count_kmers_python(reads, k=21)
    mult = collections.Counter(want.values())
    hist = [mult.get(c, 0) for c in range(1, 64)]
    hist.append(sum(n for c, n in mult.items() if c >= 64))
    top_want = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    ok = (s is not None and s["n_unique"] == len(want)
          and s["hist"].tolist() == hist
          and [(kmer.key_to_string(key, 21), c) for key, c in s["top"]]
          == top_want)
    return ok, f"{len(reads)} reads, {len(want)} distinct, top 10 + histogram"


def long_pair(rng, affine: bool) -> tuple[bytes, bytes]:
    """LONG_M x LONG_N random pair sharing a LONG_SEGMENT-base segment that
    crosses a strip edge; in the affine pair an insertion splits it at
    that edge, so the carried F column decides the score."""
    a = bytearray(_rand_reads(rng, 1, LONG_M, LONG_M)[0])
    b = bytearray(_rand_reads(rng, 1, LONG_N, LONG_N)[0])
    seg = _rand_reads(rng, 1, LONG_SEGMENT, LONG_SEGMENT)[0]
    a[LONG_A_AT:LONG_A_AT + LONG_SEGMENT] = seg
    if affine:
        half = LONG_SEGMENT // 2
        ins = _rand_reads(rng, 1, 60, 60)[0]
        b[LONG_B_AT:LONG_B_AT + LONG_SEGMENT + 60] = (seg[:half] + ins
                                                      + seg[half:])
    else:
        b[LONG_B_AT:LONG_B_AT + LONG_SEGMENT] = seg
    return bytes(a), bytes(b)


def plain_long(a: bytes, b: bytes, dev, affine: bool) -> int:
    """The plain group function over every strip of one long pair on
    ``dev``: the plain version of the kernel's host loop."""
    from mini_parallel_tpu_torch.ops import sw_long

    at = _put(np.frombuffer(a, np.uint8), dev)
    bp = np.full(-(-len(b) // sw_long.WIDTH_MULTIPLE) * sw_long.WIDTH_MULTIPLE,
                 encode.PAD_B, np.uint8)
    bp[:len(b)] = np.frombuffer(b, np.uint8)
    cols = [torch.zeros(len(a), dtype=torch.int32, device=dev)]
    if affine:
        cols.append(torch.full((len(a),), sw_long.NEG, dtype=torch.int32,
                               device=dev))
    group = sw_long.sw_affine_strip_group if affine else sw_long.sw_strip_group
    best, *_ = group(at, _put(bp, dev), *cols,
                     strip_width=sw_long.DEFAULT_STRIP_WIDTH)
    return int(best)


def _long_row(rng, dev, affine: bool):
    from mini_parallel_tpu_torch.ops import sw_long

    a, b = long_pair(rng, affine)
    golden = (sw_long.sw_affine_numpy_blocked if affine
              else sw_long.sw_score_numpy_blocked)(a, b)
    plain = plain_long(a, b, dev, affine)
    ok = plain == golden
    if _on_card(dev):
        ok &= plain == (sw_long.sw_affine_score_long if affine
                        else sw_long.sw_score_long)(a, b, dev)
    return ok, (f"{LONG_M} x {LONG_N}, {'kernel == ' * _on_card(dev)}plain "
                f"== golden, score {golden}")


def check_sw_long(rng, B, dev):
    return _long_row(rng, dev, affine=False)


def check_sw_affine_long(rng, B, dev):
    return _long_row(rng, dev, affine=True)


def check_roofline(rng, B, dev):
    from mini_parallel_tpu_torch.tools import roofline

    a, b = (t[:CHAIN_ROWS] for t in roofline.chain_operands(dev))
    want = roofline.roofline_chain(a, b, roofline.CHAIN)
    an, bn = a.cpu().numpy(), b.cpu().numpy()
    y = an.copy()
    for _ in range(roofline.CHAIN):
        y = np.maximum(y + an, bn)
    ok = np.array_equal(want.cpu().numpy(), y)
    if _on_card(dev):
        ok &= torch.equal(roofline.roofline_chain_cuda(a, b, roofline.CHAIN),
                          want)
    return ok, (f"({CHAIN_ROWS}, {a.shape[1]}) x {roofline.CHAIN} steps, "
                f"{'kernel == ' * _on_card(dev)}plain == NumPy chain")


CHECKS = [
    ("kadane-parity", check_kadane),
    ("sw-wavefront", check_sw),
    ("sw-affine", check_sw_affine),
    ("sw-chained", check_sw_chained),
    ("sw-affine-chained", check_sw_affine_chained),
    ("sw-vs-ref", check_sw_vs_ref),
    ("sw-positions", check_positions),
    ("sw-positions-pallas", check_positions_pallas),
    ("sw-affine-positions-pallas", check_positions_affine_pallas),
    ("pairhmm-fwd", check_pairhmm),
    ("kmer-rle", check_kmer),
    ("kmer-summary", check_kmer_summary),
    ("sw-long-strips", check_sw_long),
    ("sw-affine-long-strips", check_sw_affine_long),
    ("roofline-chain", check_roofline),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=200,
                    help="batch size per kernel check")
    ap.add_argument("--allow-cpu", action="store_true",
                    help="run the plain versions against the goldens on the "
                    "CPU (NOT the gate)")
    args = ap.parse_args(argv)

    if args.allow_cpu:
        dev = torch.device("cpu")
        print(f"plain versions vs goldens on the CPU (seed={args.seed}): "
              "not the kernel gate, which runs on the card")
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
        print(f"kernel parity gate on {torch.cuda.get_device_name(dev)} "
              f"(seed={args.seed})")
    else:
        print("FAIL: kernel_check runs the kernels on a CUDA card and finds "
              "none (pass --allow-cpu to check the plain versions on the CPU)")
        return 1

    failures = 0
    for name, fn in CHECKS:
        rng = np.random.default_rng(args.seed)
        try:
            ok, detail = fn(rng, args.reads, dev)
            if _on_card(dev):
                torch.cuda.synchronize()
        except Exception as e:  # a crash is a failure, not an abort
            ok, detail = False, f"EXCEPTION {type(e).__name__}: {str(e)[-200:]}"
        print(f"  {'PASS' if ok else 'FAIL'}  {name:26s} {detail}", flush=True)
        failures += 0 if ok else 1
    what = "kernels == plain == golden" if _on_card(dev) else "plain == golden"
    print(f"{len(CHECKS) - failures}/{len(CHECKS)} checks passed ({what}; "
          "the Pair-HMM product API within 1e-3 log10 of its oracle)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
