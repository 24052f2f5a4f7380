"""The ``--variant-prep --gapped --gap-model affine --genotype`` job as
``cli.py:_variant_prep`` runs it: read the reference FASTA, build
``VariantPrepEngine``, ``process_file`` over the sample's lanes,
``genotype_candidates`` over the same lanes, and ``write_candidates_vcf``.

A job's answers are its read and mapped counts, its pileup, its candidate
records with their genotype likelihoods, and the VCF it wrote. The plain
reference (reference/variant.py) maps every read again, and at reference
positions drawn from the seed (uniform, planted, and the program's own
candidates) works out the pileup rows, the candidate records and their
likelihoods from the reads; every VCF line is checked against the record
it prints.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference import variant as plain

SAMPLED = 200  # positions drawn from each of the three sources


def _record(c) -> dict:
    return {"contig": c.contig, "pos": int(c.pos), "ref": c.ref_base,
            "alt": c.alt_base, "depth": int(c.depth),
            "alt_count": int(c.alt_count), "gl": c.gl}


def _site_key(rec: dict) -> tuple:
    """(contig, pileup site) of a record: an inferred insertion is printed
    at its anchor, the base before its site."""
    ins = len(rec["alt"]) > 1 and not rec["alt"].startswith("<")
    return rec["contig"], rec["pos"] + (1 if ins else 0)


def _same(rec: dict) -> tuple:
    return (rec["contig"], rec["pos"], rec["ref"], rec["alt"], rec["depth"],
            rec["alt_count"], rec["gl"] is None)


class Entry:
    def __init__(self, config: dict, inputs, device: torch.device,
                 seed: int):
        from mini_parallel_tpu_torch.utils.config import Config

        self.config, self.inputs, self.device = config, inputs, device
        self.seed = seed
        self.p = config["engine"]
        self.cfg = Config(chunk_size_reads=self.p["chunk_size_reads"],
                          gap_open=self.p["gap_open"],
                          gap_extend=self.p["gap_extend"])

    @property
    def files(self) -> list[str]:
        return self.inputs.files

    def job(self, jobdir: str) -> dict:
        """One whole run; -> its result, the VCF's path and the
        genotyping span."""
        import time

        from torch.profiler import record_function

        from mini_parallel_tpu_torch.io import fasta
        from mini_parallel_tpu_torch.models.variant_prep import (
            VariantPrepEngine,
            write_candidates_vcf,
        )

        os.makedirs(jobdir)
        vcf = os.path.join(jobdir, "candidates.vcf")
        lanes = self.files if len(self.files) > 1 else self.files[0]
        with record_function("VariantPrepEngine"):
            veng = VariantPrepEngine(
                fasta.read_fasta(self.inputs.reference), self.cfg,
                min_depth=self.p["min_depth"],
                alt_fraction=self.p["alt_fraction"], gapped=True,
                gap_model=self.p["gap_model"], device=self.device)
        with record_function("process_file"):
            res = veng.process_file(lanes)
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
        return {"res": res, "vcf": vcf,
                "spans": {"genotype_candidates": genotype_s}}

    def reads(self, out: dict) -> int:
        return int(out["res"].total_reads)

    def chunks(self, out: dict) -> tuple[int, int]:
        """(chunks handed to the program: each lane in chunks, once for
        the pileup and once for genotyping; chunks it reported failed)."""
        c = self.p["chunk_size_reads"]
        per_pass = sum(-(-s.shape[0] // c) for s in self.inputs.seqs)
        return 2 * per_pass, 0

    # -- the reference ------------------------------------------------------

    def reference(self):
        return plain.VariantReference(
            self.inputs.contigs, np.concatenate(self.inputs.seqs),
            np.concatenate(self.inputs.quals), self.p, self.device)

    def sites(self, ref, outs: list[dict]) -> np.ndarray:
        """Reference positions drawn from the seed: uniform over the
        contigs, the planted variants' sites, and the sites of the
        program's records."""
        rng = np.random.default_rng([self.seed, 7])
        uniform = np.concatenate([
            o + rng.integers(0, n, SAMPLED * n // ref.lengths.sum() + 1)
            for o, n in zip(ref.offsets.tolist(), ref.lengths.tolist())])
        t = self.inputs.truth
        planted = np.array(
            [ref.offsets[c] + p for c, p, _ in t["snps"]]
            + [ref.offsets[c] + p for c, p in t["deletions"]]
            + [ref.offsets[c] + p for c, p in t["insertions"]], np.int64)
        found = np.array(sorted({ref.site(*_site_key(_record(c)))
                                 for out in outs
                                 for c in out["res"].candidates}), np.int64)
        picks = [uniform]
        for pool in (planted, found):
            if pool.size:
                picks.append(rng.choice(pool, min(SAMPLED, pool.size),
                                        replace=False))
        return np.unique(np.concatenate(picks))

    def check(self, outs: list[dict], ref) -> list[tuple]:
        """(name, value, limit) of each number compared, over every job."""
        limits = self.config["limits"]
        sites = self.sites(ref, outs)
        rows = ref.pileup_rows(sites)
        want = ref.genotype([r for s, row in zip(sites.tolist(), rows)
                             for r in ref.records_at(s, row)])
        by_site: dict = {}
        for r in want:
            by_site.setdefault((r["contig"], r["site"] - int(
                ref.offsets[ref.names.index(r["contig"])])), []).append(r)
        keys = [(ref.names[ref.contig_of(s)],
                 s - int(ref.offsets[ref.contig_of(s)])) for s in sites]
        n = {"reads_gap": 0, "mapped_gap": 0, "rows_off": 0,
             "records_off": 0, "gl_gap": 0.0, "vcf_off": 0}
        for out in outs:
            res = out["res"]
            n["reads_gap"] += abs(int(res.total_reads) - ref.seqs.shape[0])
            n["mapped_gap"] += abs(int(res.mapped_reads)
                                   - int(ref.mapped.sum()))
            got_rows = res.pileup[sites]
            n["rows_off"] += int((got_rows != rows).any(1).sum())
            recs = [_record(c) for c in res.candidates]
            got: dict = {}
            for r in recs:
                got.setdefault(_site_key(r), []).append(r)
            for key in keys:
                g = sorted(got.get(key, []), key=lambda r: r["alt"])
                w = sorted(by_site.get(key, []), key=lambda r: r["alt"])
                if [_same(r) for r in g] != [_same(r) for r in w]:
                    n["records_off"] += 1
                    continue
                for a, b in zip(g, w):
                    if a["gl"] is not None:
                        n["gl_gap"] = max(n["gl_gap"], float(np.abs(
                            np.subtract(a["gl"], b["gl"])).max()))
            n["vcf_off"] += self.vcf_off(out["vcf"], recs)
        return [(k, v, limits[k]) for k, v in n.items()]

    @staticmethod
    def vcf_off(path: str, recs: list[dict]) -> int:
        """VCF data lines that differ from the line of the record they
        print, in order, plus the count of missing or extra lines."""
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
        genotyped = any(r["gl"] is not None for r in recs)
        want = [plain.vcf_line(r, genotyped) for r in recs]
        return (abs(len(lines) - len(want))
                + sum(a != b for a, b in zip(lines, want)))

    def control(self, ref, jobdir: str, outs: list[dict]) -> list[dict]:
        """The control in the program's place: one job's answers from the
        reference with its Pair-HMM in bfloat16, the precision below the
        float32 the configuration states (with the float32 path's 2**120
        scale, and float64 on the lanes it underflows), at the positions
        the check of ``outs`` (the program's jobs on the same inputs)
        samples; its VCF written by the reference's own line writer."""
        from types import SimpleNamespace

        sites = self.sites(ref, outs)
        rows = ref.pileup_rows(sites)
        recs = ref.genotype([r for s, row in zip(sites.tolist(), rows)
                             for r in ref.records_at(s, row)],
                            torch.bfloat16, 120.0)
        pileup = np.zeros((ref.G, 7), np.int64)
        pileup[sites] = rows
        cands = [SimpleNamespace(contig=r["contig"], pos=r["pos"],
                                 ref_base=r["ref"], alt_base=r["alt"],
                                 depth=r["depth"], alt_count=r["alt_count"],
                                 gl=r["gl"]) for r in recs]
        res = SimpleNamespace(total_reads=ref.seqs.shape[0],
                              mapped_reads=int(ref.mapped.sum()),
                              pileup=pileup, candidates=cands)
        os.makedirs(jobdir, exist_ok=True)
        vcf = os.path.join(jobdir, "control.vcf")
        genotyped = any(r["gl"] is not None for r in recs)
        with open(vcf, "w") as f:
            f.writelines(plain.vcf_line(r, genotyped) + "\n" for r in recs)
        return [{"res": res, "vcf": vcf, "spans": {}}]
