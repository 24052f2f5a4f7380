"""``--variant-prep --rescue --sam-out`` on the CPU route (the plain
``sw_vs_ref_batch`` sweep, the plain affine traceback and pileup) against
the benchmark's plain reference (benchmark/reference/rescue.py), which
imports nothing of the port: on a small isolate generated as the
``ecoli_rescue.accessory_3x`` cell's (benchmark/tests/rescue_tiny.py: a 14
kb reference with a 10 %-divergent island, reads of a 2 kb absent contig),
with every seed-missed read swept by the reference, every SAM line, the
mapped count and the whole pileup are exact; with rescue off the island's
reads stay unmapped. Reads rescued at the contigs' edges, next to the
N spacer, get their own contig and position."""

import numpy as np
import pytest
import torch

from benchmark.entries.variant_rescue import read_sam
from benchmark.reference import rescue as plain
from benchmark.tests.rescue_tiny import tiny_entry
from mini_parallel_tpu_torch.io import fasta, fastq
from mini_parallel_tpu_torch.models import variant_prep as vp
from mini_parallel_tpu_torch.utils.config import Config

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the CPU routes here are many small torch ops,
    and with a thread per core in each of the suite's workers every op
    waits for threads the other workers hold (about 20x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def isolate(tmp_path_factory):
    """(entry, reference with every seed-missed read swept)."""
    entry = tiny_entry(str(tmp_path_factory.mktemp("isolate") / "in"))
    ref = entry.reference()
    ref.rescue(np.flatnonzero(~ref.seed_mapped))
    return entry, ref


def _engine(entry, rescue: bool):
    p = entry.p
    return vp.VariantPrepEngine(
        fasta.read_fasta(entry.inputs.reference), entry.cfg,
        min_depth=p["min_depth"], alt_fraction=p["alt_fraction"],
        gapped=True, rescue=rescue, rescue_min_frac=p["rescue_min_frac"],
        gap_model=p["gap_model"], device=CPU)


def test_sam_lines_mapped_count_and_pileup_are_the_references(isolate,
                                                              tmp_path):
    entry, ref = isolate
    R = ref.seqs.shape[0]
    absent = np.zeros(R, bool)
    absent[entry.inputs.truth["absent_rows"]] = True
    rescued = ref.rescued()
    # the fixture exercises both kinds of seed-missed read
    assert rescued.size >= 10 and not absent[rescued].any()
    assert (absent & ~ref.seed_mapped).sum() >= 30
    sam = str(tmp_path / "aln.sam")
    res = _engine(entry, True).process_file(entry.files, sam_out=sam)
    got = read_sam(sam, ref)
    assert got["bad"] == 0
    want = ref.sam_fields(np.arange(R))
    assert [got["fields"][r] for r in range(R)] == want
    assert res.total_reads == R
    assert res.mapped_reads == int(got["mapped"].sum()) \
        == sum(f[0] & 4 == 0 for f in want)
    assert (res.pileup == ref.pileup_rows(np.arange(ref.G))).all()


def test_with_rescue_off_the_islands_reads_stay_unmapped(isolate, tmp_path):
    entry, ref = isolate
    sam = str(tmp_path / "aln.sam")
    res = _engine(entry, False).process_file(entry.files, sam_out=sam)
    got = read_sam(sam, ref)
    assert not got["mapped"][ref.rescued()].any()
    assert (got["mapped"] == ref.seed_mapped).all()
    assert res.mapped_reads == int(ref.seed_mapped.sum())


def _every_sixth_substituted(seq: bytes, first: int = 3) -> bytes:
    """``seq`` with every sixth base from ``first`` on replaced: each
    15-mer then holds two or more, so no seed anchors it, while a 150-base
    read keeps 125 matches (score 225 against the threshold of 180)."""
    out = bytearray(seq)
    swap = {ord("A"): ord("C"), ord("C"): ord("G"), ord("G"): ord("T"),
            ord("T"): ord("A")}
    for k in range(first, len(out), 6):
        out[k] = swap[out[k]]
    return bytes(out)


def test_reads_rescued_at_a_spacer_get_their_contig_and_position(tmp_path):
    """Reads from the last bases of c1 and the first bases of c2, with
    the last two bases of some changed too, so that the best end comes
    short and the anchor falls in the spacer: the SAM names the contig of
    the first aligned base and its position there, as the reference
    does."""
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    c1 = rng.choice(acgt, 3000).tobytes()
    c2 = rng.choice(acgt, 3000).tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for src in (c1[-150:], c2[:150]):
        read = _every_sixth_substituted(src)
        short = read[:-2] + read[-2:].translate(comp)
        for r in (read, short):
            reads += [r, r.translate(comp)[::-1]]
    lane = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(lane, reads)
    ref_fa = str(tmp_path / "ref.fa")
    with open(ref_fa, "w") as f:
        f.write(f">c1\n{c1.decode()}\n>c2\n{c2.decode()}\n")
    p = {"gap_open": -2, "gap_extend": -1, "rescue_min_frac": 0.6}
    seqs = np.frombuffer(b"".join(reads), np.uint8).reshape(len(reads), 150)
    ref = plain.RescueReference([("c1", c1), ("c2", c2)], seqs,
                                np.full_like(seqs, ord("I")), p, CPU)
    assert not ref.seed_mapped.any()
    assert ref.rescue(np.arange(len(reads))).size == len(reads)
    # the shortened reads' forward anchors lie before c2's first base
    assert ref.starts[6] < ref.offsets[1]
    eng = vp.VariantPrepEngine(fasta.read_fasta(ref_fa),
                               Config(chunk_size_reads=16), gapped=True,
                               rescue=True, gap_model="affine", device=CPU)
    sam = str(tmp_path / "aln.sam")
    res = eng.process_file(lane, sam_out=sam)
    got = read_sam(sam, ref)
    want = ref.sam_fields(np.arange(len(reads)))
    assert [got["fields"][r] for r in range(len(reads))] == want
    assert res.mapped_reads == len(reads)
    assert [(f[1], f[2]) for f in want] == [("c1", 2851)] * 4 + [
        ("c2", 1)] * 4
