"""Per-workload benchmark battery: one JSON line per engine. The counterpart
of the JAX package's root ``bench_workloads.py``.

    python -m mini_parallel_tpu_torch.bench.workloads [--reads 100000]
        [--ref 100000] [--repeats 3] [--device cuda|cpu] [--out FILE]

The same seeded fixtures as ``bench_workloads.py`` (a random reference, a
lane of random 150 bp reads and a lane of reads cut from the reference;
byte-identical once decompressed) and the same ten rows, in its order:

    self_align_kadane, self_align_sw, complementarity_pairs,
    kmer_k21_worst_case (summary mode), kmer_k21_full_drain,
    variant_prep_ungapped, variant_prep_gapped,
    variant_prep_gapped_affine, pairhmm_forward_pairs, genotype_sites

Each engine row runs once to warm up, then ``--repeats`` times on the host
clock (from the engine's construction to its result and a synchronize; each
JAX run builds its engine too), and reports the median reads/s with the
min, max and count. ``pairhmm_forward_pairs`` (10,000 reads of 150 bp
against 300 bp haplotypes, padded to 152 / 304; fewer lanes when
``--reads`` is smaller) is timed by the card timer.
Each row's ``correct`` holds the engine's invariant and, where none
applies beyond it, identical results on every run:

- self_align_sw: total == 2 x bases; self_align_kadane: total == 2 x the
  chunks of >= 1000 bases (the reference's parity accounting); no failed
  chunk;
- the two k-mer rows: summary distinct == full distinct;
- pairhmm: the kernel == the plain version on 256 lanes, max |dlog10| 0;
- genotype: every timed call == the warm-up call.

On the card, a row whose path reaches a kernel (sw: ``sw_score``; gapped:
``sw_moves`` / ``sw_affine_moves``; the Pair-HMM: ``pairhmm``) must have
launched it; ``kernel_launches`` lists what each row launched.
"""

from __future__ import annotations

import argparse
import copy
import gzip
import hashlib
import os
import statistics
import sys
import tempfile

import numpy as np
import torch

from mini_parallel_tpu_torch.bench._common import (
    Emitter,
    Watchdog,
    add_common_flags,
    bench_device,
    card_fields,
    card_times,
    host_clock,
    launch_counts,
    launched_since,
    run,
    synchronize,
)
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.models.complementarity import (
    ComplementarityEngine,
)
from mini_parallel_tpu_torch.models.kmer_model import KmerEngine
from mini_parallel_tpu_torch.models.variant_prep import VariantPrepEngine
from mini_parallel_tpu_torch.ops import encode, pairhmm
from mini_parallel_tpu_torch.utils.config import Config

ROWS = ("self_align_kadane", "self_align_sw", "complementarity_pairs",
        "kmer_k21_worst_case", "kmer_k21_full_drain",
        "variant_prep_ungapped", "variant_prep_gapped",
        "variant_prep_gapped_affine", "pairhmm_forward_pairs",
        "genotype_sites")
READ_LEN = 150
CHUNK_READS, GAPPED_CHUNK_READS = 10_000, 2_000
PHMM_B, PHMM_M, PHMM_HAP, PHMM_M_PAD, PHMM_N_PAD = 10_000, 150, 300, 152, 304
PHMM_CHECK = 256
PHMM_LAUNCHES = 5


def make_fixtures(tmp: str, n_reads: int, ref_len: int):
    """bench_workloads.py's ``_make_fixtures``: (reference bytes, the
    random lane, the lane cut from the reference)."""
    rng = np.random.default_rng(0)
    alpha = np.array(list("ACGT"))
    ref = "".join(rng.choice(alpha, size=ref_len))
    lane = os.path.join(tmp, "lane.fastq.gz")
    with gzip.open(lane, "wt", compresslevel=1) as f:
        for i in range(n_reads):
            f.write(f"@r{i}\n{''.join(rng.choice(alpha, size=150))}\n+\nI\n")
    mapped = os.path.join(tmp, "mapped.fastq.gz")
    with gzip.open(mapped, "wt", compresslevel=1) as f:
        for i in range(n_reads):
            s = int(rng.integers(0, ref_len - 150))
            f.write(f"@m{i}\n{ref[s:s+150]}\n+\nI\n")
    return ref.encode(), lane, mapped


def make_pairhmm_operands(device: torch.device, B: int = PHMM_B) -> tuple:
    """bench_workloads.py's Pair-HMM operand: B reads of 150 bp against B
    haplotypes of 300 bp from ``np.random.default_rng(2)``, padded to 152 /
    304, every error 1e-3 -> (reads, err, haps, read_lens, hap_lens)."""
    rng = np.random.default_rng(2)
    base = np.frombuffer(b"ACGT", np.uint8)
    arr_r, la = encode.pad_batch(
        [bytes(rng.choice(base, PHMM_M)) for _ in range(B)],
        pad_to=PHMM_M_PAD, pad_value=int(encode.PAD_A))
    arr_h, lb = encode.pad_batch(
        [bytes(rng.choice(base, PHMM_HAP)) for _ in range(B)],
        pad_to=PHMM_N_PAD, pad_value=int(encode.PAD_B))
    err = np.full((B, PHMM_M_PAD), 1e-3, np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (arr_r, err, arr_h, la, lb))


def make_genotype_fixture(tmp: str) -> tuple[bytes, str, int]:
    """bench_workloads.py's genotyping fixture: a 20 kb reference, 40 het
    SNP sites, 24 reads of 100 bp over each -> (reference, lane, reads)."""
    rng2 = np.random.default_rng(5)
    alpha2 = np.frombuffer(b"ACGT", np.uint8)
    gref = bytes(rng2.choice(alpha2, 20_000))
    n_sites = 40
    sites = sorted(rng2.choice(
        np.arange(200, 19_800, 120), n_sites, replace=False))
    hap = bytearray(gref)
    for s in sites:
        hap[s] = ord("ACGT"[(b"ACGT".index(gref[s:s+1]) + 1) % 4])
    hap = bytes(hap)
    greads = []
    for s in sites:
        for i in range(24):
            src = hap if i % 2 == 0 else gref  # het everywhere
            st = int(s) - 40 - (i % 12)
            greads.append(src[st:st + 100])
    gpath = os.path.join(tmp, "gt.fastq.gz")
    with gzip.open(gpath, "wt", compresslevel=1) as f:
        for i, r in enumerate(greads):
            f.write(f"@g{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
    return gref, gpath, len(greads)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _self_facts(r) -> tuple:
    return (r.score, r.total_reads, r.total_bases, r.chunks, r.failed_chunks)


def _comp_facts(r) -> tuple:
    return (r.pairs, r.perfect_pairs, r.direct_score_sum, r.comp_score_sum,
            r.unpaired_reads)


def _kmer_facts(r) -> tuple:
    table = _digest(*r.arrays) if r.arrays else None
    hist = None if r.count_histogram is None else _digest(r.count_histogram)
    return (r.distinct_kmers, r.total_kmers, r.total_reads, table, hist,
            [tuple(t) for t in r.top_items])


def _vp_facts(r) -> tuple:
    return (r.total_reads, r.mapped_reads,
            [(c.contig, c.pos, c.ref_base, c.alt_base, c.depth, c.alt_count)
             for c in r.candidates],
            None if r.pileup is None else _digest(r.pileup))


def _genotype_facts(r) -> list:
    return [(c.pos, c.gt, c.gq, c.gl) for c in r.candidates]


class Battery:
    """Runs the rows and emits each."""

    def __init__(self, args, device: torch.device, emitter: Emitter,
                 watchdog: Watchdog):
        self.args, self.device = args, device
        self.emitter, self.watchdog = emitter, watchdog

    def timed(self, name: str, run_once, count_of, facts_of,
              need_kernel: str | None = None, extra_of=None,
              invariant=None) -> tuple:
        """One engine row: a warm-up run, ``--repeats`` timed runs.
        ``invariant(result)`` is the row's check beyond identical facts.
        -> (the row, the last result)."""
        self.watchdog.metric = name
        before = launch_counts()
        warm = run_once()
        synchronize(self.device)
        want = facts_of(warm)
        secs, same = [], True
        res = warm
        for _ in range(self.args.repeats):
            res, dt = host_clock(run_once, self.device)
            secs.append(dt)
            same &= facts_of(res) == want
        launched = launched_since(before)
        correct = same and (invariant(res) if invariant else True)
        if self.device.type == "cuda" and need_kernel:
            correct &= launched.get(need_kernel, 0) > 0
        count = count_of(res)
        rates = [count / s for s in secs]
        row = {"metric": name,
               "value": statistics.median(rates),
               "unit": "reads_per_s",
               "seconds": statistics.median(secs),
               "min": min(rates), "max": max(rates), "count": len(rates),
               "extra": {**(extra_of(res) if extra_of else {}),
                         "identical_runs": same,
                         "kernel_launches": launched},
               "correct": correct}
        return row, res

    def run_all(self) -> None:
        args, dev = self.args, self.device
        cfg = Config(chunk_size_reads=CHUNK_READS)
        with tempfile.TemporaryDirectory(prefix="mpt_bench_") as tmp:
            ref, lane, mapped = make_fixtures(tmp, args.reads, args.ref_len)
            big_chunks = sum(
                READ_LEN * min(CHUNK_READS, args.reads - c) >= 1000
                for c in range(0, args.reads, CHUNK_READS))
            for mode, kernel in (("kadane", None), ("sw", "sw_score")):
                def check(r, m=mode):
                    want = (2 * r.total_bases if m == "sw"
                            else 2 * big_chunks)
                    return r.score == want and r.failed_chunks == 0
                row, _ = self.timed(
                    f"self_align_{mode}",
                    lambda m=mode: AlignmentEngine(cfg, mode=m, device=dev)
                    .self_align_file(lane),
                    lambda r: r.total_reads, _self_facts, kernel,
                    lambda r: {"reads": r.total_reads,
                               "bases": r.total_bases, "score": r.score,
                               "chunks": r.chunks}, check)
                self.emitter.emit(row)
            row, _ = self.timed(
                "complementarity_pairs",
                lambda: ComplementarityEngine(cfg, device=dev)
                .analyze_lane_pair(lane, lane),
                lambda r: r.pairs, _comp_facts, "sw_score",
                lambda r: {"pairs": r.pairs,
                           "perfect_pairs": r.perfect_pairs},
                lambda r: r.pairs == args.reads)
            self.emitter.emit(row)
            self.kmer_rows(cfg, lane)
            self.variant_rows(cfg, ref, mapped)
            self.pairhmm_row()
            self.genotype_row(tmp)

    def kmer_rows(self, cfg: Config, lane: str) -> None:
        """Summary (the CLI's default, nothing drained) and full drain; each
        row holds summary distinct == full distinct, so both run first."""
        rows = []
        for name, mode in (("kmer_k21_worst_case", "summary"),
                           ("kmer_k21_full_drain", "full")):
            rows.append(self.timed(
                name,
                lambda m=mode: KmerEngine(cfg, device=self.device)
                .count_file(lane, result_mode=m),
                lambda r: r.total_reads, _kmer_facts, None,
                lambda r, m=mode: {"distinct": r.distinct_kmers,
                                   "result_mode": m}))
        same = rows[0][1].distinct_kmers == rows[1][1].distinct_kmers
        for row, _ in rows:
            row["extra"]["summary_distinct_equals_full"] = same
            row["correct"] = row["correct"] and same
            self.emitter.emit(row)

    def variant_rows(self, cfg: Config, ref: bytes, mapped: str) -> None:
        gcfg = Config(chunk_size_reads=GAPPED_CHUNK_READS)
        for name, c, kw, kernel in (
                ("variant_prep_ungapped", cfg, {}, None),
                ("variant_prep_gapped", gcfg, {"gapped": True}, "sw_moves"),
                ("variant_prep_gapped_affine", gcfg,
                 {"gapped": True, "gap_model": "affine"}, "sw_affine_moves")):
            row, _ = self.timed(
                name,
                lambda c=c, kw=kw: VariantPrepEngine(
                    ref, c, device=self.device, **kw).process_file(mapped),
                lambda r: r.total_reads, _vp_facts, kernel,
                lambda r: {"mapping_rate": r.mapping_rate,
                           "mapped_reads": r.mapped_reads,
                           "candidates": len(r.candidates)})
            self.emitter.emit(row)

    def pairhmm_row(self) -> None:
        """B read-vs-haplotype likelihoods a call, by the card timer; the
        kernel == the plain version on the first PHMM_CHECK lanes."""
        name = "pairhmm_forward_pairs"
        self.watchdog.metric = name
        B = min(PHMM_B, self.args.reads)
        ops = make_pairhmm_operands(self.device, B)
        before = launch_counts()
        got = pairhmm.pairhmm_batch_best(*ops)
        n = min(PHMM_CHECK, B)
        plain = pairhmm.pairhmm_batch(*(x[:n] for x in ops))
        same_inf = torch.equal(torch.isinf(got[:n]), torch.isinf(plain))
        finite = torch.isfinite(plain)
        err = float((got[:n][finite].double() - plain[finite].double())
                    .abs().max()) if bool(finite.any()) else 0.0
        correct = same_inf and err == 0.0
        t = card_times(lambda: pairhmm.pairhmm_batch_best(*ops), self.device,
                       launches=PHMM_LAUNCHES if self.device.type == "cuda"
                       else 1)
        launched = launched_since(before)
        if self.device.type == "cuda":
            correct &= launched.get("pairhmm", 0) > 0
        dt = t["ms"] / 1e3
        self.emitter.emit({
            "metric": name, "value": B / dt, "unit": "reads_per_s",
            "seconds": dt, "min": B / t["max_ms"] * 1e3,
            "max": B / t["min_ms"] * 1e3, "count": t["samples"],
            "extra": {"gcups": B * PHMM_M * PHMM_HAP / dt / 1e9,
                      "pairs": B, "checked_lanes": n,
                      "max_abs_dlog10": err, "timer": t["timer"],
                      "launches_per_sample": t["launches"],
                      "kernel_launches": launched},
            "correct": correct})

    def genotype_row(self, tmp: str) -> None:
        """Map + pileup + Pair-HMM genotypes of 40 planted het sites: warm
        once, then every timed call must equal the warm one."""
        gref, gpath, n_reads = make_genotype_fixture(tmp)
        geng = VariantPrepEngine(gref, Config(chunk_size_reads=2_000),
                                 min_depth=3, alt_fraction=0.2,
                                 device=self.device)
        gres0 = geng.process_file(gpath)
        row, res = self.timed(
            "genotype_sites",
            lambda: geng.genotype_candidates(gpath, copy.deepcopy(gres0)),
            lambda r: sum(1 for c in r.candidates if c.gt is not None),
            _genotype_facts, "pairhmm",
            lambda r: {"reads": n_reads, "sites": len(r.candidates),
                       "called": sum(1 for c in r.candidates
                                     if c.gt is not None)})
        self.emitter.emit(row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mini_parallel_tpu_torch.bench.workloads",
        description="One JSON line per engine, bench_workloads.py's rows.")
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--ref", type=int, default=100_000, dest="ref_len")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs per engine row, after one warm-up")
    add_common_flags(ap)
    args = ap.parse_args(argv)
    watchdog = Watchdog(ROWS[0], "reads_per_s")
    device = bench_device(args)
    emitter = Emitter(card_fields(device), args.out)
    watchdog.card = emitter.card
    Battery(args, device, emitter, watchdog).run_all()
    watchdog.cancel()
    return emitter.finish()


if __name__ == "__main__":
    sys.exit(run(main, "bench.workloads"))
