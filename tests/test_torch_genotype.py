"""The port's ``--genotype`` on the CPU against the JAX package on the
same seeded fixtures (the JAX package's own genotype fixtures of
tests/test_workloads.py): candidates, GT and GQ equal, GL within 1e-3
(the float32 Pair-HMM sums in another order on the two platforms; GL
sums ~30 reads' log10 values), the same inferred insertion alleles and
identical VCF bytes. JAX runs its Pallas kernels in interpret mode."""

import dataclasses

import numpy as np
import pytest
import torch

from mini_parallel_tpu import cli as jcli
from mini_parallel_tpu.io import fastq as jfastq
from mini_parallel_tpu.models import variant_prep as jvp
from mini_parallel_tpu.utils.config import Config as JaxConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fasta
from mini_parallel_tpu_torch.models import variant_prep as vp
from mini_parallel_tpu_torch.ops import encode
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
GL_TOL = 1e-3
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _mutate(ref: bytes, pos: int, alt: bytes) -> bytes:
    return ref[:pos] + alt + ref[pos + 1:]


def _het_hom(rng):
    ref = random_dna(rng, 2000)
    het_pos, hom_pos = 600, 1400
    het_alt = b"A" if ref[het_pos:het_pos + 1] != b"A" else b"C"
    hom_alt = b"G" if ref[hom_pos:hom_pos + 1] != b"G" else b"T"
    hap_het = _mutate(ref, het_pos, het_alt)
    hap_hom = _mutate(ref, hom_pos, hom_alt)
    reads = []
    for i in range(40):  # 20 reads per site, het: half carry the alt
        src = hap_het if i % 2 == 0 else ref
        s = het_pos - 20 - (i % 10)
        reads.append(src[s:s + 60])
    for i in range(20):
        s = hom_pos - 20 - (i % 10)
        reads.append(hap_hom[s:s + 60])
    return ref, reads, {}, {het_pos: "0/1", hom_pos: "1/1"}


def _rc_only(rng):
    ref = random_dna(rng, 1200)
    pos = 500
    alt = b"T" if ref[pos:pos + 1] != b"T" else b"A"
    hap = _mutate(ref, pos, alt)
    reads = [hap[pos - 25 - (i % 8):pos + 35 - (i % 8)].translate(_RC)[::-1]
             for i in range(20)]
    return ref, reads, {}, {pos: "1/1"}


def _deletion(rng):
    ref = random_dna(rng, 1500)
    dpos = 700
    hap = ref[:dpos] + ref[dpos + 1:]
    reads = [hap[dpos - 30 - (i % 10):dpos + 30 - (i % 10)] for i in range(24)]
    return ref, reads, dict(gapped=True), {}


def _multi_contig(rng):
    c1 = random_dna(rng, 700)
    c2 = random_dna(rng, 500)
    edge = 5  # the window clips at the contig's start
    alt = b"G" if c2[edge:edge + 1] != b"G" else b"T"
    hap2 = c2[:edge] + alt + c2[edge + 1:]
    reads = []
    for _ in range(30):
        s = int(rng.integers(0, 600))
        reads.append(c1[s:s + 100])
    for i in range(20):
        reads.append(hap2[0:60 + (i % 7)])
    return ({"chr1": c1, "chr2": c2}, reads,
            dict(alt_fraction=0.5, read_pad=112), {})


def _insertion(rng):
    ref = random_dna(rng, 1500)
    anchor = 700  # a 3 bp insertion between ref[700] and ref[701]
    hap = ref[:anchor + 1] + b"TGA" + ref[anchor + 1:]
    reads = [hap[anchor - 30 - (i % 10):anchor + 34 - (i % 10)]
             for i in range(24)]
    return ref, reads, dict(gapped=True, gap_model="affine"), {}


FIXTURES = {"het-hom": _het_hom, "rc-only": _rc_only,
            "deletion": _deletion, "multi-contig-edge": _multi_contig,
            "insertion-affine": _insertion}


def _engines(ref, kw):
    kw = dict(kw)
    cfg = Config(chunk_size_reads=16, read_pad=kw.pop("read_pad", 64))
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    kw.setdefault("alt_fraction", 0.2)
    return (vp.VariantPrepEngine(ref, cfg, min_depth=3, device=CPU, **kw),
            jvp.VariantPrepEngine(ref, jcfg, min_depth=3, **kw))


def _fields(res):
    return [(c.contig, c.pos, c.ref_base, c.alt_base, c.depth, c.alt_count,
             c.gt, c.gq) for c in res.candidates]


def _vcf(mod, res, path) -> bytes:
    mod.write_candidates_vcf(path, res)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", list(FIXTURES))
def test_genotype_matches_jax(tmp_path, name):
    """Each fixture through both engines: the same candidates with the
    same GT and GQ, GL within GL_TOL, identical VCF bytes."""
    rng = np.random.default_rng(0)
    ref, reads, kw, want_gt = FIXTURES[name](rng)
    path = str(tmp_path / "gt.fastq.gz")
    jfastq.write_fastq(path, reads)
    eng, jeng = _engines(ref, kw)
    got = eng.genotype_candidates(path, eng.process_file(path))
    want = jeng.genotype_candidates(path, jeng.process_file(path))
    assert _fields(got) == _fields(want)
    for g, w in zip(got.candidates, want.candidates):
        assert (g.gl is None) == (w.gl is None)
        if g.gl is not None:
            np.testing.assert_allclose(g.gl, w.gl, rtol=0, atol=GL_TOL)
    assert _vcf(vp, got, str(tmp_path / "a.vcf")) == \
        _vcf(jvp, want, str(tmp_path / "b.vcf"))
    by_pos = {(c.contig, c.pos): c.gt for c in got.candidates}
    for pos, gt in want_gt.items():
        assert by_pos[("ref", pos)] == gt
    assert any(c.gt for c in got.candidates)


def test_insertion_allele_inferred(tmp_path):
    """The 3 bp insertion is inferred, rewritten to the anchor convention
    and called 1/1, as in the JAX package's test."""
    rng = np.random.default_rng(0)
    ref, reads, kw, _ = _insertion(rng)
    path = str(tmp_path / "ins.fastq.gz")
    jfastq.write_fastq(path, reads)
    eng, _ = _engines(ref, kw)
    res = eng.process_file(path)
    assert any(c.alt_base == "<INS>" for c in res.candidates)
    res = eng.genotype_candidates(path, res)
    called = [c for c in res.candidates if c.gt is not None
              and len(c.alt_base) > 1 and not c.alt_base.startswith("<")]
    assert called
    c = called[0]
    assert (c.pos, c.ref_base, c.alt_base) == (700, chr(ref[700]),
                                                chr(ref[700]) + "TGA")
    assert c.gt == "1/1" and c.gl[2] > c.gl[0]


@pytest.mark.parametrize("gap_model", ["linear", "affine"])
def test_insertion_positions_match_jax_host_walk(tmp_path, gap_model):
    """_infer_insertions takes its per-base positions from the port's fused
    traceback walk; they equal the JAX package's XLA scan + host CIGAR walk
    (``_gapped_positions``) on the insertion fixture's reads."""
    rng = np.random.default_rng(0)
    ref, reads, _, _ = _insertion(rng)
    eng, jeng = _engines(ref, dict(gapped=True, gap_model=gap_model))
    reads = reads + [r.translate(_RC)[::-1] for r in reads[:4]] + [b"ACGT" * 5]
    starts = np.array([eng.index.reference.find(r[:20]) for r in reads],
                      np.int32)
    pad = eng._pad_for(max(map(len, reads)))
    arr, lens = encode.pad_batch(reads, pad_to=pad, pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(torch.from_numpy(arr))
    got = vp._traceback_positions(
        codes, torch.from_numpy(lens), torch.from_numpy(starts),
        torch.ones(len(reads), dtype=torch.bool), eng.index.ref_ascii_dev,
        len(eng.index.ref_codes), pad + 2 * eng.window_margin,
        eng.window_margin, gap_model, eng.cfg.gap_open, eng.cfg.gap_extend)
    want = jeng._gapped_positions(codes.numpy(), lens, starts,
                                  np.ones(len(reads), bool))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == -1).any() and (got >= 0).sum() > 1000


def test_cli_genotype_matches_jax(tmp_path, monkeypatch):
    """--variant-prep --gapped --genotype --gt-window 30 --vcf-out through
    both CLIs on a two-lane, two-contig sample: the same VCF bytes and the
    same echoed candidate lines (with GT= and GQ=)."""
    rng = np.random.default_rng(5)
    contigs = {"chr1": random_dna(rng, 1500), "chr2": random_dna(rng, 900)}
    reads = []
    for name, seq in contigs.items():
        for pos in (300, 600):
            hap = _mutate(seq, pos, b"A" if seq[pos:pos + 1] != b"A" else b"C")
            for i in range(14):
                s = pos - 25 - (i % 9)
                src = hap if (name == "chr1" or i % 2) else seq
                r = src[s:s + 60]
                reads.append(r if i % 3 else r.translate(_RC)[::-1])
    ref = str(tmp_path / "ref.fa")
    fasta.write_fasta(ref, contigs)
    lanes = [str(tmp_path / f"L{k}.fastq.gz") for k in (1, 2)]
    jfastq.write_fastq(lanes[0], reads[::2])
    jfastq.write_fastq(lanes[1], reads[1::2])
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "16")
    outs = []
    for main, name in ((cli.main, "a.vcf"), (jcli.main, "b.vcf")):
        lines = []
        vcf = str(tmp_path / name)
        argv = ["--variant-prep", ",".join(lanes), "--reference", ref,
                "--gapped", "--genotype", "--gt-window", "30",
                "--vcf-out", vcf, "--allow-cpu"]
        assert main(argv, echo=lines.append) == 0
        with open(vcf, "rb") as f:
            outs.append((f.read(), [ln for ln in lines if " GT=" in ln]))
    assert outs[0] == outs[1]
    assert b"0/1" in outs[0][0] and b"1/1" in outs[0][0]
    assert len(outs[0][1]) == 4
