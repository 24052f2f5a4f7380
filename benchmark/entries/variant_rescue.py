"""The ``--variant-prep --gapped --gap-model affine --rescue --sam-out
<job>/aln.sam --genotype --vcf-out <job>/candidates.vcf`` job as
``cli.py:_variant_prep`` runs it, on an isolate that carries genes the
reference lacks: ``VariantPrepEngine(rescue=True)``, ``process_file`` over
the sample's lanes with the SAM written, ``genotype_candidates`` over the
same lanes, and ``write_candidates_vcf``.

A run resequences ``sample.isolates`` isolates in turn, a job each, as a lab
runs a series of isolates against one reference (:class:`Entry`): each
job is one isolate's lanes and its own reference copy, so that the
window's card time is the mean over isolates and not one draw's.

The inputs of an isolate (:class:`Isolate`). traffic.py writes the lanes of
the contigs the reference holds (``sample.contigs``) and their FASTA; the
entry then, from the seed and the isolate's index:

- makes the reference copy diverge from the sample in ``sample.islands``:
  that share of the named contig in islands of lengths drawn in the given
  range (scaled to the share), each with that share of its bases
  substituted; the sample keeps the original bases;
- builds the contigs of ``sample.absent``: random bases, so that an
  absent read anchors only on the chance 15-mers it shares with the
  reference;
- draws exactly ``absent.reads_per_file`` reads a lane from them (half of
  them reverse complemented, their quality bytes drawn from the lane's
  own, no substitutions: a read of no reference sequence stays one), puts
  them among the lane's reads at positions drawn from the seed, and writes
  the lane as the generator writes it (gzip members of
  ``traffic.PIECE_RECORDS`` records, at the level its header records):
  the first isolate over the generator's files, the others beside them;
- writes its reference FASTA with the islands.

The isolates share the generator's reads of the present contigs and its
planted variants. The truth gains the islands and the rows of the absent
reads.

The check. For each isolate, the plain reference (reference/rescue.py) maps
every read with the seed mapper. It sweeps in full, on both strands, a
sample of the seed-missed reads, and every read that a job's SAM reports
mapped though no seed anchors it, where its position lies within one
alignment window of a sampled site. Each job is then held to it:

- ``reads_gap`` as in variant_prep;
- ``mapped_gap``: the job's mapped count against its SAM's mapped lines,
  plus the reads the seed mapper anchors that the SAM leaves unmapped;
- ``sam_off``: the SAM lines (FLAG, RNAME, POS, CIGAR, SEQ) of 1,000
  seed-mapped reads, 32 seed-missed absent reads and 32 seed-missed reads of
  the present contigs (the islands'), a run, shared among its isolates,
  against the reference's, plus any line missing or out of order;
- ``rows_off``, ``records_off``, ``gl_gap``, ``vcf_off`` as in
  variant_prep, at its sampled sites and ``ISLAND_SITES`` more in the
  islands (a run, shared among its isolates), each rescued read that the
  reference swept placed as its own sweep places it.

The isolates' numbers add up, but ``gl_gap``, which is the largest. A read
that the reference would rescue next to a sampled site but that a job
leaves unmapped, or maps far from it, is seen only when it is in the
``sam_off`` sample.
"""

from __future__ import annotations

import gzip
import os
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import traffic, work_vs_ref
from benchmark.entries import variant_prep as prep
from benchmark.reference import rescue as plain
from benchmark.reference import variant as plain_prep

# a run's samples of the check, shared evenly among its isolates
SAM_SEED_MAPPED = 1000  # seed-mapped reads whose SAM lines are compared
SAM_SWEPT = 32  # seed-missed reads of each kind, swept in full
ISLAND_SITES = 100  # sampled sites drawn from the islands
GZIP_LEVEL = {4: 1, 2: 9}  # a gzip header's XFL byte -> its level


def islands(rng, length: int, spec: dict) -> list[tuple[int, int]]:
    """[start, end) of each island of a contig of ``length``: lengths drawn
    in ``spec["length"]``, scaled to ``spec["share"]`` of the contig, one in
    each of as many equal slots, at an offset drawn in its slot."""
    target = round(spec["share"] * length)
    lo, hi = spec["length"]
    n = max(1, round(2 * target / (lo + hi)))
    sizes = rng.integers(lo, hi + 1, n).astype(np.float64)
    sizes = np.round(sizes * target / sizes.sum()).astype(np.int64)
    sizes[-1] += target - sizes.sum()
    slot = length // n
    if sizes.max() >= slot:
        raise ValueError(f"islands of up to {sizes.max()} bp in slots of "
                         f"{slot}")
    out = []
    for k, size in enumerate(sizes.tolist()):
        start = k * slot + int(rng.integers(0, slot - size))
        out.append((start, start + size))
    return out


def diverge(rng, seq: np.ndarray, spans: list[tuple[int, int]],
            share: float) -> np.ndarray:
    """``seq`` with ``share`` of the bases of each span substituted."""
    out = seq.copy()
    for s, e in spans:
        at = s + rng.choice(e - s, round(share * (e - s)), replace=False)
        out[at] = traffic.substitute(rng, out[at])
    return out


def gzip_level(path: str) -> int:
    """The level the gzip header of the file at ``path`` records (0 for a
    plain file)."""
    with open(path, "rb") as f:
        head = f.read(10)
    return (GZIP_LEVEL.get(head[8], 6) if head[:2] == b"\x1f\x8b"
            else 0)


def write_lane(path: str, text: bytes, records: int, level: int) -> None:
    """Write a lane's FASTQ text as the generator does: plain (``level``
    0), or gzip members of ``traffic.PIECE_RECORDS`` records at
    ``level``; on disk before it returns."""
    step = traffic.PIECE_RECORDS * (len(text) // max(records, 1))
    with open(path, "wb") as f:
        for lo in range(0, max(len(text), 1), max(step, 1)):
            piece = text[lo:lo + step]
            f.write(gzip.compress(piece, compresslevel=level, mtime=0)
                    if level else piece)
        f.flush()
        os.fsync(f.fileno())


def with_absent_genes(sample: dict, inputs: traffic.Inputs, seed: int,
                      k: int = 0) -> traffic.Inputs:
    """The inputs of isolate ``k`` of a run: the generator's ``inputs``,
    with the islands, the absent reads and the reference written again,
    over the generator's files for the first isolate and under
    ``isolate<k>/`` beside them for the others (the module's
    docstring)."""
    rng = np.random.default_rng([seed, 25, k] if k else [seed, 25])
    level = gzip_level(inputs.files[0])
    here = os.path.dirname(inputs.reference)
    if k:
        here = os.path.join(here, f"isolate{k}")
        os.makedirs(here, exist_ok=True)
    files = [os.path.join(here, os.path.basename(p)) for p in inputs.files]
    reference = os.path.join(here, os.path.basename(inputs.reference))
    names = [n for n, _ in inputs.contigs]
    spec = sample["islands"]
    ci = names.index(spec["contig"])
    seq = np.frombuffer(inputs.contigs[ci][1], np.uint8)
    where = islands(rng, seq.size, spec)
    contigs = list(inputs.contigs)
    contigs[ci] = (names[ci], diverge(rng, seq, where,
                                      spec["divergence"]).tobytes())
    absent = [(name, rng.choice(traffic.ACGT, length))
              for name, length in sample["absent"]["contigs"]]
    donors = [(a, np.arange(a.size)) for _, a in absent]
    per_file = int(sample["absent"]["reads_per_file"])
    gz = inputs.files[0].endswith(".gz")
    seqs, quals, rows, at = [], [], [], 0
    for j, (path, (_, lane, read)) in enumerate(
            zip(files, traffic.file_names(sample, gz))):
        have, hq = inputs.seqs[j], inputs.quals[j]
        L = have.shape[1]
        new = traffic.sample_reads(rng, donors, per_file, L, 0.5)["seqs"]
        nq = hq.reshape(-1)[rng.integers(0, hq.size, (per_file, L))]
        n = have.shape[0] + per_file
        mine = np.zeros(n, bool)
        mine[rng.choice(n, per_file, replace=False)] = True
        s = np.empty((n, L), np.uint8)
        q = np.empty((n, L), np.uint8)
        s[~mine], s[mine] = have, new
        q[~mine], q[mine] = hq, nq
        write_lane(path, traffic.fastq_bytes(rng, s, q, lane, read), n,
                   level)
        seqs.append(s)
        quals.append(q)
        rows.append(at + np.flatnonzero(mine))
        at += n
    with open(reference, "wb") as f:
        f.write(traffic.fasta_bytes(contigs))
    truth = dict(inputs.truth, islands=[(ci, s, e) for s, e in where],
                 absent_rows=np.concatenate(rows),
                 absent=[(n, a.tobytes()) for n, a in absent])
    return traffic.Inputs(files=files, seqs=seqs, quals=quals,
                          reference=reference, contigs=contigs, truth=truth)


def read_sam(path: str, ref: plain.RescueReference) -> dict:
    """A SAM's records by read: ``fields`` {row: (FLAG, RNAME, POS, CIGAR,
    SEQ)} of each record whose QNAME ``r<row>`` is its own row in order,
    ``bad`` the records out of order, unparsed or missing, ``mapped``
    (R,) bool and ``at`` (R,) the absolute reference position of a mapped
    record's first aligned base (-1 elsewhere)."""
    R = ref.seqs.shape[0]
    fields: dict[int, tuple] = {}
    mapped = np.zeros(R, bool)
    at = np.full(R, -1, np.int64)
    offset = dict(zip(ref.names, ref.offsets.tolist()))
    bad = row = 0
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            col = line.rstrip("\n").split("\t")
            try:
                flag, pos = int(col[1]), int(col[3])
                ok = col[0] == f"r{row}" and row < R and len(col) >= 11
            except (IndexError, ValueError):
                ok = False
            if not ok:
                bad += 1
                row += 1
                continue
            fields[row] = (flag, col[2], pos, col[5], col[9])
            if not flag & 4 and col[2] in offset:
                mapped[row] = True
                at[row] = offset[col[2]] + pos - 1
            row += 1
    return {"fields": fields, "bad": bad + max(0, R - row), "mapped": mapped,
            "at": at}


def write_sam(path: str, ref: plain.RescueReference) -> int:
    """Write the SAM line of every read as ``ref`` maps it now, each under
    the QNAME ``r<row>`` that :func:`read_sam` reads; -> the mapped
    lines."""
    n_mapped = 0
    with open(path, "w") as f:
        for r, (flag, rname, pos, cig, seq) in enumerate(
                ref.sam_fields(np.arange(ref.seqs.shape[0]))):
            n_mapped += not flag & 4
            f.write(f"r{r}\t{flag}\t{rname}\t{pos}\t"
                    f"{0 if flag & 4 else 255}\t{cig}\t*\t0\t0\t{seq}\t*\n")
    return n_mapped


class Isolate(prep.Entry):
    """Isolate ``k`` of a run of ``n``: its inputs, its job and its check,
    with ``1 / n`` of the run's samples of the check."""

    def __init__(self, config: dict, inputs, device: torch.device,
                 seed: int, k: int = 0, n: int = 1):
        super().__init__(config, with_absent_genes(config["sample"], inputs,
                                                   seed, k), device, seed)
        self.k, self.n = k, n
        self._ref = None

    def rng(self, stream: int) -> np.random.Generator:
        """The isolate's generator of one stream of the check's draws."""
        return np.random.default_rng(
            [self.seed, stream, self.k] if self.k else [self.seed, stream])

    def job(self, jobdir: str) -> dict:
        """One whole run; -> its result, the VCF's and the SAM's paths and
        the genotyping span."""
        import time

        from torch.profiler import record_function

        from mini_parallel_tpu_torch.io import fasta
        from mini_parallel_tpu_torch.models.variant_prep import (
            VariantPrepEngine,
            write_candidates_vcf,
        )

        os.makedirs(jobdir)
        vcf = os.path.join(jobdir, "candidates.vcf")
        sam = os.path.join(jobdir, "aln.sam")
        lanes = self.files if len(self.files) > 1 else self.files[0]
        with record_function("VariantPrepEngine"):
            veng = VariantPrepEngine(
                fasta.read_fasta(self.inputs.reference), self.cfg,
                min_depth=self.p["min_depth"],
                alt_fraction=self.p["alt_fraction"], gapped=True,
                rescue=self.p["rescue"],
                rescue_min_frac=self.p["rescue_min_frac"],
                gap_model=self.p["gap_model"], device=self.device)
        with record_function("process_file"):
            res = veng.process_file(lanes, sam_out=sam)
        t0 = time.perf_counter()
        with record_function("genotype_candidates"):
            res = veng.genotype_candidates(
                lanes, res, window=self.p["gt_window"],
                max_reads_per_site=self.p["gt_max_reads"])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        genotype_s = time.perf_counter() - t0
        with record_function("write_candidates_vcf"):
            write_candidates_vcf(vcf, res)
        return {"res": res, "vcf": vcf, "sam": sam,
                "spans": {"genotype_candidates": genotype_s}}

    def cells(self) -> int:
        """The cells of the rescue sweep one job needs: each read the
        plain seed mapper leaves unmapped, once, on both strands."""
        ref = self.reference()
        return work_vs_ref.vs_ref_cells(int((~ref.seed_mapped).sum()),
                                        ref.L, ref.G)

    # -- the reference ------------------------------------------------------

    def reference(self, cap: int | None = None) -> plain.RescueReference:
        """The plain reference (one a run); with ``cap``, a fresh one whose
        sweep saturates there."""
        if cap is None and self._ref is not None:
            return self._ref
        ref = plain.RescueReference(
            self.inputs.contigs, np.concatenate(self.inputs.seqs),
            np.concatenate(self.inputs.quals), self.p, self.device, cap)
        if cap is None:
            self._ref = ref
        return ref

    def sites(self, ref, outs: list[dict]) -> np.ndarray:
        """variant_prep's sites and the isolate's share of
        ``ISLAND_SITES`` drawn from the islands."""
        rng = self.rng(26)
        pool = np.concatenate([ref.offsets[c] + np.arange(s, e)
                               for c, s, e in self.inputs.truth["islands"]])
        pick = rng.choice(pool, min(ISLAND_SITES // self.n, pool.size),
                          replace=False)
        return np.unique(np.concatenate([super().sites(ref, outs), pick]))

    def sam_sample(self, ref) -> np.ndarray:
        """The rows whose SAM lines are compared, the isolate's share of
        ``SAM_SEED_MAPPED`` seed-mapped reads, of ``SAM_SWEPT`` seed-missed
        absent reads and of ``SAM_SWEPT`` seed-missed reads of the present
        contigs."""
        rng = self.rng(27)
        missed = ~ref.seed_mapped
        absent = np.zeros_like(missed)
        absent[self.inputs.truth["absent_rows"]] = True
        picks = []
        for pool, n in ((ref.seed_mapped, SAM_SEED_MAPPED // self.n),
                        (missed & absent, SAM_SWEPT // self.n),
                        (missed & ~absent, SAM_SWEPT // self.n)):
            rows = np.flatnonzero(pool)
            picks.append(rng.choice(rows, min(n, rows.size), replace=False))
        return np.unique(np.concatenate(picks))

    def claimed(self, ref, sams: list[dict], sites: np.ndarray) -> np.ndarray:
        """Rows that a SAM maps though no seed anchors them, placed within
        one alignment window of a site."""
        srt = np.sort(sites)
        rows = []
        for sam in sams:
            r = np.flatnonzero(sam["mapped"] & ~ref.seed_mapped)
            at = sam["at"][r]
            k = np.searchsorted(srt, at)
            near = np.zeros(r.size, bool)
            for j in (k - 1, k):
                ok = (j >= 0) & (j < srt.size)
                near |= ok & (np.abs(srt[np.clip(j, 0, srt.size - 1)] - at)
                              < ref.W)
            rows.append(r[near])
        return np.unique(np.concatenate(rows)) if rows else np.zeros(0, int)

    def check(self, outs: list[dict], ref) -> list[tuple]:
        """(name, value, limit) of each number compared, over every job."""
        limits = self.config["limits"]
        sams = [read_sam(o["sam"], ref) for o in outs]
        sample = self.sam_sample(ref)
        ref.rescue(np.concatenate([sample, self.claimed(
            ref, sams, self.sites(ref, outs))]))
        want = dict(zip(sample.tolist(), ref.sam_fields(sample)))
        mapped_gap = sam_off = 0
        for out, sam in zip(outs, sams):
            mapped_gap += (abs(int(out["res"].mapped_reads)
                               - int(sam["mapped"].sum()))
                           + int((ref.seed_mapped & ~sam["mapped"]).sum()))
            sam_off += sam["bad"] + sum(sam["fields"].get(r) != w
                                        for r, w in want.items())
        out = []
        for name, value, limit in super().check(outs, ref):
            if name == "mapped_gap":
                out += [(name, mapped_gap, limit),
                        ("sam_off", sam_off, limits["sam_off"])]
            else:
                out.append((name, value, limit))
        return out

    def control(self, ref, jobdir: str, outs: list[dict]) -> list[dict]:
        """The control in the program's place, one job for each precision
        the configuration states: the rescue sweep saturating at 8 bits
        (:meth:`sweep_control`) and the Pair-HMM in bfloat16
        (:meth:`hmm_control`), on the same inputs as ``outs``."""
        return [self.sweep_control(jobdir, outs),
                self.hmm_control(ref, jobdir, outs)]

    def sweep_control(self, jobdir: str, outs: list[dict]) -> dict:
        """One job's answers from a reference whose rescue sweep saturates
        at 127, the signed 8-bit range below the int16 scores the
        configuration states, with every SAM line its own, its pileup and
        records at the sites the check of ``outs`` (the program's jobs on
        the same inputs) samples, and its VCF by the reference's line
        writer. It sweeps the reads the check sweeps; every other
        seed-missed read stays unmapped, as 127 is below any read's
        threshold."""
        ctl = self.reference(plain.SAT8)
        sites = self.sites(ctl, outs)
        sams = [read_sam(o["sam"], ctl) for o in outs]
        ctl.rescue(np.concatenate([self.sam_sample(ctl),
                                   self.claimed(ctl, sams, sites)]))
        os.makedirs(jobdir, exist_ok=True)
        sam = os.path.join(jobdir, "control.sam")
        n_mapped = write_sam(sam, ctl)
        rows = ctl.pileup_rows(sites)
        recs = ctl.genotype([r for s, row in zip(sites.tolist(), rows)
                             for r in ctl.records_at(s, row)])
        pileup = np.zeros((ctl.G, 7), np.int64)
        pileup[sites] = rows
        cands = [SimpleNamespace(contig=r["contig"], pos=r["pos"],
                                 ref_base=r["ref"], alt_base=r["alt"],
                                 depth=r["depth"], alt_count=r["alt_count"],
                                 gl=r["gl"]) for r in recs]
        res = SimpleNamespace(total_reads=ctl.seqs.shape[0],
                              mapped_reads=n_mapped, pileup=pileup,
                              candidates=cands)
        vcf = os.path.join(jobdir, "control.vcf")
        genotyped = any(r["gl"] is not None for r in recs)
        with open(vcf, "w") as f:
            f.writelines(plain_prep.vcf_line(r, genotyped) + "\n"
                         for r in recs)
        return {"res": res, "vcf": vcf, "sam": sam, "spans": {}}

    def hmm_control(self, ref, jobdir: str, outs: list[dict]) -> dict:
        """variant_prep's control (the reference's Pair-HMM in bfloat16) on
        the reads as ``ref``'s own full sweep places them: it first sweeps
        the rows the check of ``outs`` sweeps, and writes ``ref``'s SAM
        line of every read (a seed-missed read it did not sweep stays
        unmapped there)."""
        sams = [read_sam(o["sam"], ref) for o in outs]
        ref.rescue(np.concatenate([self.sam_sample(ref), self.claimed(
            ref, sams, self.sites(ref, outs))]))
        jobdir = os.path.join(jobdir, "hmm")
        out = super().control(ref, jobdir, outs)[0]
        out["sam"] = os.path.join(jobdir, "control.sam")
        out["res"].mapped_reads = write_sam(out["sam"], ref)
        return out


class Entry:
    """A run's ``sample.isolates`` isolates, resequenced in turn, a job
    each. The set-up's warm-up job (the first) runs the last isolate, so
    that the window's first job, the one a traced run traces, runs the
    first, whose sweep :meth:`cells` counts. A check holds each isolate's
    jobs to its own plain reference; a control runs in a job's place on its
    isolate's inputs."""

    def __init__(self, config: dict, inputs, device: torch.device,
                 seed: int):
        n = int(config["sample"]["isolates"])
        self.isolates = [Isolate(config, inputs, device, seed, k, n)
                         for k in range(n)]
        self.calls = 0

    @property
    def files(self) -> list[str]:
        return self.isolates[0].files

    def job(self, jobdir: str) -> dict:
        k = (self.calls - 1) % len(self.isolates)
        self.calls += 1
        return dict(self.isolates[k].job(jobdir), isolate=k)

    def reads(self, out: dict) -> int:
        return self.isolates[out["isolate"]].reads(out)

    def chunks(self, out: dict) -> tuple[int, int]:
        return self.isolates[out["isolate"]].chunks(out)

    def cells(self) -> int:
        return self.isolates[0].cells()

    def reference(self) -> list[plain.RescueReference]:
        """Each isolate's plain reference, in order."""
        return [iso.reference() for iso in self.isolates]

    def by_isolate(self, outs: list[dict]):
        """(k, isolate, its outputs among ``outs``) of each isolate that
        has some."""
        for k, iso in enumerate(self.isolates):
            mine = [o for o in outs if o["isolate"] == k]
            if mine:
                yield k, iso, mine

    def check(self, outs: list[dict], refs) -> list[tuple]:
        """(name, value, limit) of each number compared: the sum over the
        isolates, and the largest ``gl_gap``."""
        parts = [iso.check(mine, refs[k])
                 for k, iso, mine in self.by_isolate(outs)]
        return [(name, (max if name == "gl_gap" else sum)(
                    p[i][1] for p in parts), limit)
                for i, (name, _, limit) in enumerate(parts[0])]

    def control(self, refs, jobdir: str, outs: list[dict]) -> list[dict]:
        """Each isolate's controls (:meth:`Isolate.control`) on the
        isolates of ``outs``."""
        return [dict(c, isolate=k)
                for k, iso, mine in self.by_isolate(outs)
                for c in iso.control(refs[k],
                                     os.path.join(jobdir, f"isolate{k}"),
                                     mine)]
