"""The one generator of the benchmark's inputs.

A configuration's ``sample`` fixes the scale and layout of what a job reads
(lanes, files, reads a file, read length, the reference's contigs); a
traffic mix (``traffic/<mix>.json``) fixes the shape of the reads (gzip or
plain, planted variants, substitution errors, N bases, the quality bins).
:func:`generate` writes the lanes, and the reference FASTA where there is
one, under a directory and returns what it wrote with the truth, all from
one seed: the same seed gives the same bytes, and every seed the same
sizes.

The variant fixture (``plant_variants``, ``sample_reads``) is chip_smoke.py's,
copied; the FASTQ writer is vectorised: records are fixed-width rows of one
byte matrix, with Illumina CASAVA 1.8 headers and a full quality line.
"""

from __future__ import annotations

import gzip
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
BASE_CODE = np.zeros(256, np.int64)
BASE_CODE[ACGT] = [0, 1, 2, 3]
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[ACGT] = np.frombuffer(b"TGCA", np.uint8)
COMPLEMENT[ord("N")] = ord("N")

INSTRUMENT = b"A00153:42:HFWV2DSXY"  # NovaSeq run and flow cell id
INDEX = b"CAGATCTG+TTAGGCAT"  # dual index of the sample
FASTA_LINE = 80
PIECE_RECORDS = 1 << 16  # records a gzip member holds


@dataclass
class Inputs:
    """What :func:`generate` wrote: the lane files in job order, each
    file's reads as written (rows of ``read_length`` ASCII bytes) and their
    quality bytes, the reference FASTA and its contigs where the
    configuration has one, and the planted truth in the coordinates of each
    contig: ``(contig index, 0-based position)``."""

    files: list[str]
    seqs: list[np.ndarray]
    quals: list[np.ndarray]
    reference: str | None = None
    contigs: list[tuple[str, bytes]] = field(default_factory=list)
    truth: dict = field(default_factory=dict)


def substitute(rng, bases: np.ndarray) -> np.ndarray:
    """Each ACGT byte replaced by one of the three others."""
    shift = rng.integers(1, 4, bases.shape)
    return ACGT[(BASE_CODE[bases] + shift) % 4]


def plant_variants(rng, ref: np.ndarray, n_snp: int, n_del: int, n_ins: int,
                   max_indel: int = 10, spacing: int = 40):
    """(donor, donor_to_ref, truth): ``ref`` with SNPs and 1-``max_indel``
    base deletions and insertions at sites ``spacing`` or more bases apart.
    donor_to_ref[k] is the reference index of donor base k (-1 inside an
    insertion); truth is ([(pos, alt)], [deletion pos], [insertion pos],
    {insertion pos: inserted bases}), where a deletion sits at its first
    deleted base and an insertion at the base after it, as the pileup's
    evidence columns count them."""
    n = n_snp + n_del + n_ins
    sites = np.sort(rng.choice(np.arange(200, ref.size - 200, spacing), n,
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
            at = site + int(rng.integers(1, max_indel + 1))
        else:
            k = int(rng.integers(1, max_indel + 1))
            pieces.append(rng.choice(ACGT, k))
            maps.append(np.full(k, -1))
            ins.append(site)
            ins_bases[site] = pieces[-1].tobytes()
            at = site
    pieces.append(ref[at:])
    maps.append(np.arange(at, ref.size))
    return (np.concatenate(pieces), np.concatenate(maps),
            (snps, dels, ins, ins_bases))


def sample_reads(rng, donors: list, n: int, length: int,
                 reverse_share: float) -> dict:
    """n reads of ``length`` from the donors (a contig by its length),
    ``reverse_share`` of them reverse-complemented. Returns the rows and,
    per read, its contig and planted reference start (-1 when it starts
    inside an insertion)."""
    sizes = np.array([d.size for d, _ in donors], np.float64)
    contig = rng.choice(len(donors), n, p=sizes / sizes.sum())
    seqs = np.empty((n, length), np.uint8)
    start = np.empty(n, np.int64)
    for c, (donor, to_ref) in enumerate(donors):
        rows = np.nonzero(contig == c)[0]
        s = rng.integers(0, donor.size - length, rows.size)
        seqs[rows] = donor[s[:, None] + np.arange(length)[None, :]]
        start[rows] = to_ref[s]
    rev = rng.random(n) < reverse_share
    seqs[rev] = COMPLEMENT[seqs[rev]][:, ::-1]
    return {"seqs": seqs, "contig": contig, "start": start, "reverse": rev}


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative integers, zero-padded."""
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // powers[None, :]) % 10 + 48).astype(np.uint8)


def fastq_bytes(rng, seqs: np.ndarray, quals: np.ndarray, lane: int,
                read: int) -> bytes:
    """The FASTQ text of one file: CASAVA 1.8 headers
    ``@<instrument>:<lane>:<tile>:<x>:<y> <read>:N:0:<index>``, the
    sequence, ``+`` and the quality line, each record a fixed-width row."""
    n, length = seqs.shape
    head = b"@" + INSTRUMENT + b":%d:" % lane
    tail = b" %d:N:0:" % read + INDEX + b"\n"
    tiles = 1101 + (np.arange(n, dtype=np.int64) * 1578) // max(n, 1)
    x = rng.integers(1000, 32000, n)
    y = rng.integers(1000, 37000, n)
    parts = [np.frombuffer(head, np.uint8), _digits(tiles, 4), b":",
             _digits(x, 5), b":", _digits(y, 5),
             np.frombuffer(tail, np.uint8), seqs, b"\n+\n", quals, b"\n"]
    widths = [p.shape[1] if isinstance(p, np.ndarray) and p.ndim == 2
              else len(p) for p in parts]
    rec = np.empty((n, sum(widths)), np.uint8)
    at = 0
    for p, w in zip(parts, widths):
        rec[:, at:at + w] = (p if isinstance(p, np.ndarray)
                             else np.frombuffer(p, np.uint8))
        at += w
    return rec.tobytes()


def fasta_bytes(contigs: list[tuple[str, bytes]]) -> bytes:
    out = []
    for name, seq in contigs:
        out.append(b">" + name.encode() + b"\n")
        for i in range(0, len(seq), FASTA_LINE):
            out.append(seq[i:i + FASTA_LINE] + b"\n")
    return b"".join(out)


def file_names(sample: dict, gz: bool) -> list[tuple[str, int, int]]:
    """(name, lane, read) of every file in job order: the reference's
    ``{SAMPLE}_L{lane:03}_R{read}_001.fastq[.gz]`` layout."""
    ext = ".fastq.gz" if gz else ".fastq"
    return [(f"{sample['sample_id']}_L{lane:03d}_R{read}_001{ext}", lane, read)
            for lane in range(1, sample["lanes"] + 1)
            for read in range(1, sample["reads_per_lane"] + 1)]


def quality_rows(rng, n: int, length: int, bins: dict) -> np.ndarray:
    """(n, length) Phred+33 bytes drawn from ``bins`` ({char: share}),
    through a 16-bit lookup table."""
    chars = np.frombuffer("".join(bins).encode(), np.uint8)
    share = np.array(list(bins.values()), np.float64)
    edges = np.cumsum(share / share.sum())
    lut = chars[np.minimum(np.searchsorted(
        edges, (np.arange(1 << 16) + 0.5) / (1 << 16), "right"),
        chars.size - 1)]
    return lut[rng.integers(0, 1 << 16, (n, length), dtype=np.uint16)]


def scatter(rng, shape: tuple, rate: float) -> np.ndarray:
    """Flat indices of about ``rate`` of the cells of ``shape``, drawn with
    replacement."""
    size = int(np.prod(shape))
    return rng.integers(0, size, rng.binomial(size, rate)) if rate else \
        np.zeros(0, np.int64)


def generate(sample: dict, traffic: dict, seed: int, out_dir: str,
             workers: int = 8) -> Inputs:
    """Write one job's inputs under ``out_dir`` from ``seed``."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    L = int(sample["read_length"])
    names = file_names(sample, traffic["gzip_level"] > 0)
    per_file = int(sample["reads_per_file"])
    n = per_file * len(names)
    inputs = Inputs(files=[], seqs=[], quals=[])
    if sample.get("contigs"):
        variants = traffic.get("variants") or {}
        total = sum(length for _, length in sample["contigs"])
        donors = []
        truth = {"snps": [], "deletions": [], "insertions": {}}
        for ci, (name, length) in enumerate(sample["contigs"]):
            ref = rng.choice(ACGT, length)
            share = length / total
            donor, to_ref, (snps, dels, ins, ins_bases) = plant_variants(
                rng, ref, round(variants.get("snps", 0) * share),
                round(variants.get("deletions", 0) * share),
                round(variants.get("insertions", 0) * share),
                variants.get("max_indel", 10), variants.get("spacing", 40))
            inputs.contigs.append((name, ref.tobytes()))
            donors.append((donor, to_ref))
            truth["snps"] += [(ci, p, a) for p, a in snps]
            truth["deletions"] += [(ci, p) for p in dels]
            truth["insertions"].update(
                {(ci, p): b for p, b in ins_bases.items()})
        inputs.truth = truth
        reads = sample_reads(rng, donors, n, L,
                             traffic.get("reverse_share", 0.5))
        seqs = reads["seqs"]
        inputs.reference = os.path.join(out_dir, "reference.fa")
        with open(inputs.reference, "wb") as f:
            f.write(fasta_bytes(inputs.contigs))
    else:  # reads of no genome: i.i.d. bases
        seqs = ACGT[rng.integers(0, 4, (n, L), dtype=np.uint8)]
    flat = seqs.reshape(-1)
    err = scatter(rng, seqs.shape, traffic.get("substitution_rate", 0.0))
    flat[err] = substitute(rng, flat[err])
    flat[scatter(rng, seqs.shape, traffic.get("n_rate", 0.0))] = ord("N")
    quals = quality_rows(rng, n, L, traffic["quality"])
    texts = []
    for k, (name, lane, read) in enumerate(names):
        rows = slice(k * per_file, (k + 1) * per_file)
        inputs.files.append(os.path.join(out_dir, name))
        inputs.seqs.append(seqs[rows])
        inputs.quals.append(quals[rows])
        texts.append(fastq_bytes(rng, seqs[rows], quals[rows], lane, read))

    def pack(k: int, lo: int, hi: int) -> bytes:
        data = texts[k][lo:hi]
        if traffic["gzip_level"] > 0:
            return gzip.compress(data, compresslevel=traffic["gzip_level"],
                                 mtime=0)
        return data

    # each file in pieces of whole records, compressed in parallel as
    # the members of one multi-member gzip file (as BGZF writes them)
    step = PIECE_RECORDS * (len(texts[0]) // max(per_file, 1))
    with ThreadPoolExecutor(workers) as pool:
        futures = [[pool.submit(pack, k, lo, lo + step)
                    for lo in range(0, max(len(t), 1), max(step, 1))]
                   for k, t in enumerate(texts)]
        for path, parts in zip(inputs.files, futures):
            with open(path, "wb") as f:
                for fut in parts:
                    f.write(fut.result())
                # on disk now, so that no write-back runs in the window
                f.flush()
                os.fsync(f.fileno())
    return inputs
