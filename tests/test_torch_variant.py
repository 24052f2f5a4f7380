"""The port's ``--variant-prep`` on the CPU against the JAX package on the
same seeded fixture: seed mapping, pileups, rescue, the quality mask,
gapped linear/affine traceback pileups, multi-lane samples, checkpoints,
SAM and VCF bytes and the CLI. Exact equality throughout.

The fixture is a 2-contig reference (4,000 + 2,000 bases) and a donor
with planted SNPs, deletions and insertions; two lanes of reads of
100-150 bp (half reverse-complemented, ~0.5% errors, some N, ~5% Q2
bases, a few seed-killed reads for the rescue, random junk, one empty and
one 10-base read); chunks of 128 reads."""

import dataclasses
import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu import cli as jcli
from mini_parallel_tpu.models import variant_prep as jvp
from mini_parallel_tpu.ops import encode as jencode
from mini_parallel_tpu.ops import packed as jpacked
from mini_parallel_tpu.utils.config import Config as JaxConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fasta, fastq
from mini_parallel_tpu_torch.models import variant_prep as vp
from mini_parallel_tpu_torch.ops import encode, packed
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
CHUNK = 128
_RC = bytes.maketrans(b"ACGT", b"TGCA")
_ACGT = np.frombuffer(b"ACGT", np.uint8)
# middles of the 8 seed windows _map_reads_both probes in a 150-base read
_SEED_MIDDLES = (7, 24, 41, 58, 91, 108, 125, 142)


def _donor(rng, ref: bytes, n_snp: int, n_del: int, n_ins: int) -> bytes:
    """ref with SNPs and 1-5 base indels at sites >= 30 bases apart."""
    sites = np.sort(rng.choice(np.arange(40, len(ref) - 40, 30),
                               n_snp + n_del + n_ins, replace=False))
    kinds = rng.permutation(["S"] * n_snp + ["D"] * n_del + ["I"] * n_ins)
    out, at = [], 0
    for site, kind in zip(sites.tolist(), kinds):
        out.append(ref[at:site])
        if kind == "S":
            out.append(bytes([int(rng.choice(
                [c for c in _ACGT if c != ref[site]]))]))
            at = site + 1
        elif kind == "D":
            at = site + int(rng.integers(1, 6))
        else:
            out.append(rng.choice(_ACGT, int(rng.integers(1, 6))).tobytes())
            at = site
    out.append(ref[at:])
    return b"".join(out)


def _lane(rng, donors: list[bytes], n: int) -> list[tuple[bytes, bytes]]:
    """n (sequence, quality) records sampled from the donors."""
    recs = []
    for k in range(n):
        d = donors[k % len(donors)]
        length = 150 if k % 3 else int(rng.integers(100, 150))
        s = int(rng.integers(0, len(d) - length))
        r = np.frombuffer(d[s:s + length], np.uint8).copy()
        err = rng.random(length) < 0.005
        r[err] = rng.choice(_ACGT, int(err.sum()))
        if k % 41 == 5:
            r[rng.integers(0, length, 2)] = ord("N")
        if k % 23 == 7 and length == 150:  # kill every probed seed
            for m in _SEED_MIDDLES:
                r[m] = _ACGT[(list(_ACGT).index(r[m]) + 1) % 4]
        seq = r.tobytes()
        if k % 2:
            seq = seq.translate(_RC)[::-1]
        qual = np.full(length, ord("I"), np.uint8)
        qual[rng.random(length) < 0.05] = ord("#")
        recs.append((seq, qual.tobytes()))
    recs.append((rng.choice(_ACGT, 120).tobytes(), b"I" * 120))  # junk
    recs.append((b"", b""))
    recs.append((donors[0][100:110], b"IIIII#IIII"))
    return recs


def _write_lane(path: str, recs, truncate: bool = False) -> None:
    text = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, q)
                    for i, (s, q) in enumerate(recs))
    if truncate:  # the last record loses its quality line
        text = text[: text.rstrip(b"\n").rfind(b"\n") + 1]
    with open(path, "wb") as f:
        f.write(gzip.compress(text))


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    rng = np.random.default_rng(2026)
    contigs = {"chr1": rng.choice(_ACGT, 4000).tobytes(),
               "chr2": rng.choice(_ACGT, 2000).tobytes()}
    donors = [_donor(rng, contigs["chr1"], 16, 3, 3),
              _donor(rng, contigs["chr2"], 8, 2, 2)]
    d = tmp_path_factory.mktemp("variant")
    ref = str(d / "ref.fa")
    fasta.write_fasta(ref, contigs)
    lanes = [str(d / f"L{k}.fastq.gz") for k in (1, 2)]
    _write_lane(lanes[0], _lane(rng, donors, 300))
    _write_lane(lanes[1], _lane(rng, donors, 290))
    return {"contigs": contigs, "ref": ref, "lanes": lanes, "dir": d}


def _cfgs(jax_packed: bool = True, **kw):
    """The port's Config and the JAX package's; ``jax_packed`` picks the
    JAX package's transfer route (the port has the packed one only)."""
    cfg = Config(chunk_size_reads=CHUNK, **kw)
    return cfg, JaxConfig(**dataclasses.asdict(cfg),
                          packed_transfer=jax_packed)


def _cands(res):
    """The candidates' fields both packages fill (the JAX package's
    genotype fields stay empty without --genotype)."""
    return [(c.pos, c.ref_base, c.alt_base, c.depth, c.alt_count, c.contig,
             getattr(c, "gt", None)) for c in res.candidates]


def _assert_same(got, want):
    assert (got.total_reads, got.mapped_reads, got.reference_length) == \
        (want.total_reads, want.mapped_reads, want.reference_length)
    assert got.pileup.dtype == np.int32
    np.testing.assert_array_equal(got.pileup, np.asarray(want.pileup))
    assert _cands(got) == _cands(want)
    assert got.contigs == want.contigs


def _vcf_bytes(res, path, mod) -> bytes:
    mod.write_candidates_vcf(path, res)
    with open(path, "rb") as f:
        return f.read()


CASES = {
    "ungapped": dict(),
    "gapped-linear": dict(gapped=True),
    "gapped-affine": dict(gapped=True, gap_model="affine"),
    "min-base-quality": dict(min_base_quality=10),
    "gapped-affine-min-base-quality": dict(gapped=True, gap_model="affine",
                                           min_base_quality=10),
}


@pytest.mark.parametrize("jax_packed", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_process_file_matches_jax(sample, tmp_path, case, jax_packed):
    """Both lanes as one sample, every engine mode: pileup, counts,
    candidates and VCF bytes equal the JAX package's, on its packed and
    its raw route."""
    cfg, jcfg = _cfgs(jax_packed=jax_packed, gap_open=-3, gap_extend=-1)
    kw = CASES[case]
    got = vp.VariantPrepEngine(sample["contigs"], cfg, device=CPU,
                               **kw).process_file(sample["lanes"])
    want = jvp.VariantPrepEngine(sample["contigs"], jcfg,
                                 **kw).process_file(sample["lanes"])
    _assert_same(got, want)
    assert got.total_reads == 596 and 0.8 < got.mapping_rate < 1.0
    assert _vcf_bytes(got, str(tmp_path / "a.vcf"), vp) == \
        _vcf_bytes(want, str(tmp_path / "b.vcf"), jvp)
    if kw.get("gapped"):
        assert any(c.alt_base in ("<DEL>", "<INS>") for c in got.candidates)


@pytest.mark.parametrize("gapped", [False, True])
def test_rescue_matches_jax(sample, gapped):
    """rescue=True on lane 1: the seed-killed reads come back through the
    vs-reference SW (plain version here, interpret-mode Pallas in JAX)."""
    cfg, jcfg = _cfgs()
    kw = dict(rescue=True, gapped=gapped)
    got = vp.VariantPrepEngine(sample["contigs"], cfg, device=CPU,
                               **kw).process_file(sample["lanes"][0])
    want = jvp.VariantPrepEngine(sample["contigs"], jcfg,
                                 **kw).process_file(sample["lanes"][0])
    _assert_same(got, want)
    plain = vp.VariantPrepEngine(sample["contigs"], cfg, device=CPU,
                                 gapped=gapped).process_file(
                                     sample["lanes"][0])
    assert got.mapped_reads >= plain.mapped_reads + 10


def test_single_reference_and_lane_order(sample):
    """A bare bytes reference (one contig named "ref") and the lanes in the
    other order."""
    cfg, jcfg = _cfgs(read_pad=150)
    ref = sample["contigs"]["chr1"]
    lanes = sample["lanes"][::-1]
    got = vp.VariantPrepEngine(ref, cfg, device=CPU, gapped=True,
                               min_depth=3, alt_fraction=0.5
                               ).process_file(lanes)
    want = jvp.VariantPrepEngine(ref, jcfg, gapped=True, min_depth=3,
                                 alt_fraction=0.5).process_file(lanes)
    _assert_same(got, want)
    assert got.contigs == [("ref", 4000)]


@pytest.mark.parametrize("gap_model", ["linear", "affine"])
def test_sam_bytes_match_jax(sample, tmp_path, gap_model):
    cfg, jcfg = _cfgs()
    a, b = str(tmp_path / "a.sam"), str(tmp_path / "b.sam")
    got = vp.write_sam(a, vp.VariantPrepEngine(
        sample["contigs"], cfg, device=CPU, gap_model=gap_model),
        sample["lanes"])
    want = jvp.write_sam(b, jvp.VariantPrepEngine(
        sample["contigs"], jcfg, gap_model=gap_model), sample["lanes"])
    assert got == want and got["records"] == 596
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_checkpoint_resume_and_refusals(sample, tmp_path, monkeypatch):
    """A run that dies after chunk 2's snapshot resumes to the clean run's
    result; the JAX package resumes from the port's snapshot too; a changed
    fingerprint is refused with the JAX package's message."""
    cfg, jcfg = _cfgs()
    contigs, lanes = sample["contigs"], sample["lanes"]
    clean = vp.VariantPrepEngine(contigs, cfg, device=CPU,
                                 gapped=True).process_file(lanes)
    ckpt = str(tmp_path / "prep.npz")
    real = fastq.iter_flat_chunks

    def dying(path, n, **kw):
        for i, c in enumerate(real(path, n, **kw)):
            if path == lanes[1] and i == 1:
                raise RuntimeError("injected crash")
            yield c

    monkeypatch.setattr(fastq, "iter_flat_chunks", dying)
    with pytest.raises(RuntimeError, match="injected crash"):
        vp.VariantPrepEngine(contigs, cfg, device=CPU, gapped=True
                             ).process_file(lanes, checkpoint_path=ckpt,
                                            checkpoint_every=2)
    monkeypatch.setattr(fastq, "iter_flat_chunks", real)
    with np.load(ckpt) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["chunks_done"] == 4 and meta["total_reads"] == 431
    jres = jvp.VariantPrepEngine(contigs, jcfg, gapped=True).process_file(
        lanes, checkpoint_path=ckpt, checkpoint_every=2)
    res = vp.VariantPrepEngine(contigs, cfg, device=CPU, gapped=True
                               ).process_file(lanes, checkpoint_path=ckpt,
                                              checkpoint_every=2)
    _assert_same(res, clean)
    _assert_same(res, jres)
    for kw, key in ((dict(gapped=False), "gapped"),
                    (dict(gapped=True, rescue=True), "rescue")):
        with pytest.raises(ValueError, match=key):
            vp.VariantPrepEngine(contigs, cfg, device=CPU, **kw).process_file(
                lanes, checkpoint_path=ckpt, checkpoint_every=2)
    with pytest.raises(ValueError, match="file_path"):
        vp.VariantPrepEngine(contigs, cfg, device=CPU, gapped=True
                             ).process_file(lanes[0], checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="checkpointing with sam_out"):
        vp.VariantPrepEngine(contigs, cfg, device=CPU, gapped=True
                             ).process_file(lanes, sam_out=str(tmp_path / "x"),
                                            checkpoint_path=ckpt)


def test_quality_stream_truncated_record(tmp_path):
    """A record without its quality line gets an empty quality string, as
    in the JAX package's Python decoder."""
    from mini_parallel_tpu.io import fastq as jfastq

    recs = [(b"ACGTACGTAC", b"IIIII#IIII"), (b"TTTTGGGG", b"########"),
            (b"CCCCAAAAT", b"IIIIIIIII")]
    path = str(tmp_path / "t.fastq.gz")
    _write_lane(path, recs, truncate=True)
    got = list(fastq.iter_read_chunks_with_quals(path, 2))
    want = list(jfastq.iter_read_chunks_with_quals(path, 2, engine="python"))
    assert got == want == [([b"ACGTACGTAC", b"TTTTGGGG"],
                            [b"IIIII#IIII", b"########"]),
                           ([b"CCCCAAAAT"], [b""])]
    flat = list(fastq.iter_flat_chunks_with_quals_multi([path, path], 2))
    assert len(flat) == 4 and flat[-1][3].tolist() == [0, 0]


def test_engine_helpers_match_jax(sample):
    """pad rule, spacer guard, quality masks, contig table."""
    cfg, jcfg = _cfgs(read_pad=100)
    eng = vp.VariantPrepEngine(sample["contigs"], cfg, device=CPU)
    jeng = jvp.VariantPrepEngine(sample["contigs"], jcfg)
    assert [eng._pad_for(n) for n in (1, 101, 200, 256)] == \
        [jeng._pad_for(n) for n in (1, 101, 200, 256)] == [104, 104, 200, 256]
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="contig spacer"):
            e._pad_for(257)
    assert eng.contig_table() == jeng.contig_table() == [("chr1", 4000),
                                                         ("chr2", 2000)]
    eng.min_base_quality = jeng.min_base_quality = 10
    quals = [b"II#I", b"", b"#" * 9]
    qflat = np.frombuffer(b"".join(quals), np.uint8)
    qoffs = np.cumsum([0] + [len(q) for q in quals])
    for pad in (8, 16):
        np.testing.assert_array_equal(
            eng._qual_mask_flat(qflat, qoffs, pad),
            jeng._qual_mask_flat(qflat, qoffs, pad))
        np.testing.assert_array_equal(
            eng._qual_mask_flat(qflat, qoffs, pad),
            jeng._qual_mask([b"ACGT", b"", b"A" * 9], quals, pad))
    with pytest.raises(ValueError, match="gap_model"):
        vp.VariantPrepEngine(b"ACGT" * 10, cfg, device=CPU, gap_model="x")
    # MPT_MESH_SHAPE is the CLI's to turn into a mesh, as in the JAX
    # package: the engine holds a mesh of one shard
    assert vp.VariantPrepEngine(b"ACGT" * 10, Config(mesh_shape=(2,)),
                                device=CPU).mesh.devices.size == 1


# ----------------------------------------------------------------------
# Device functions against their JAX counterparts
# ----------------------------------------------------------------------


def _read_batch(rng, B=40, L=64):
    """Codes (B, L) with ragged lengths, N bases, and reads copied from a
    reference so that seeds hit; returns (ref bytes, codes, lens)."""
    ref = rng.choice(_ACGT, 3000).tobytes()
    rows = []
    for k in range(B):
        n = int(rng.integers(0, L + 1)) if k % 4 == 0 else L
        s = int(rng.integers(0, 3000 - n))
        r = bytearray(ref[s:s + n])
        if k % 5 == 1 and n:
            r[int(rng.integers(0, n))] = ord("N")
        if k % 3 == 2:
            r = bytearray(bytes(r).translate(_RC)[::-1])
        if k % 7 == 3:
            r = bytearray(rng.choice(_ACGT, n).tobytes())
        rows.append(bytes(r))
    arr, lens = encode.pad_batch(rows, pad_to=L, pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(torch.from_numpy(arr))
    return ref, codes, lens


def _iupac_ref(rng) -> bytes:
    ref = bytearray(random_dna(rng, 3000))
    for p in rng.integers(0, len(ref), 60):
        ref[p] = int(rng.choice(np.frombuffer(b"RYKMSWBDHVryk", np.uint8)))
    return bytes(ref)


_INDEX_CASES = {
    "random": lambda rng: random_dna(rng, 3000),
    "lowercase": lambda rng: (random_dna(rng, 1000)
                              + random_dna(rng, 1000).lower()),
    "n_runs": lambda rng: (random_dna(rng, 400) + b"N" * 30
                           + random_dna(rng, 500) + b"n" * 14
                           + random_dna(rng, 300) + b"N"),
    "iupac": _iupac_ref,
    "repeat_60mer_x3": lambda rng: (random_dna(rng, 100)
                                    + random_dna(rng, 60) * 3
                                    + random_dna(rng, 100)),
    "exactly_k": lambda rng: random_dna(rng, vp.SEED_K),
    "k_minus_1": lambda rng: random_dna(rng, vp.SEED_K - 1),
    "shorter_than_k": lambda rng: random_dna(rng, 10),
    "all_n": lambda rng: b"N" * 200,
    "two_contigs": lambda rng: vp.concat_contigs(
        {"c1": random_dna(rng, 1500), "c2": random_dna(rng, 700).lower()})[0],
}


@pytest.mark.parametrize("case", list(_INDEX_CASES))
def test_reference_index_matches_jax(case):
    """The seed index built with torch ops (on the CPU here) equals the JAX
    package's NumPy build: keys, positions and codes, values and dtypes.
    Below k - 1 bases the JAX build raises; the port's index is empty."""
    ref = _INDEX_CASES[case](np.random.default_rng(7))
    idx = vp.ReferenceIndex(ref, CPU)
    want_codes = np.asarray(jencode.ascii_to_code(
        jnp.asarray(np.frombuffer(ref.upper(), np.uint8))))
    assert idx.ref_codes.dtype == want_codes.dtype
    np.testing.assert_array_equal(idx.ref_codes, want_codes)
    if len(ref) < vp.SEED_K - 1:
        with pytest.raises(TypeError):
            jvp.ReferenceIndex(ref)
        for t in (idx.sorted_keys, idx.sorted_pos):
            assert t.shape == (0,) and t.dtype == torch.int32
            assert t.device == CPU
        assert len(idx) == 0
        return
    jidx = jvp.ReferenceIndex(ref)
    for got, want in ((idx.sorted_keys, jidx.sorted_keys),
                      (idx.sorted_pos, jidx.sorted_pos)):
        want = np.asarray(want)
        assert got.device == CPU and got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(idx.ref_codes, jidx.ref_codes)
    assert len(idx) == len(jidx)


def test_map_reads_both_matches_jax(rng):
    ref, codes, lens = _read_batch(rng)
    idx = vp.ReferenceIndex(ref, CPU)
    jidx = jvp.ReferenceIndex(ref)
    np.testing.assert_array_equal(idx.sorted_keys.numpy(),
                                  np.asarray(jidx.sorted_keys))
    np.testing.assert_array_equal(idx.sorted_pos.numpy(),
                                  np.asarray(jidx.sorted_pos))
    np.testing.assert_array_equal(idx.ref_codes, jidx.ref_codes)
    got = vp._map_reads_both(codes, torch.from_numpy(lens), idx.sorted_keys,
                             idx.sorted_pos)
    want = jvp._map_reads_both(jnp.asarray(codes.numpy()), jnp.asarray(lens),
                               jidx.sorted_keys, jidx.sorted_pos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 10 < int(got[1].sum()) < 40 and 5 < int(got[3].sum()) < 30


def test_repeated_seed_anchors_at_first_occurrence():
    """A reference with a repeated 60-mer: the stable sort and the left
    search anchor every copy's reads at the FIRST occurrence."""
    rng = np.random.default_rng(5)
    unit = rng.choice(_ACGT, 60).tobytes()
    ref = rng.choice(_ACGT, 200).tobytes() + unit + \
        rng.choice(_ACGT, 300).tobytes() + unit + rng.choice(_ACGT, 50).tobytes()
    arr, lens = encode.pad_batch([unit[:40], unit[10:50]], pad_to=48,
                                 pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(torch.from_numpy(arr))
    idx = vp.ReferenceIndex(ref, CPU)
    sf, mf, _, _ = vp._map_reads_both(codes, torch.from_numpy(lens),
                                      idx.sorted_keys, idx.sorted_pos)
    assert sf.tolist() == [200, 210] and mf.tolist() == [True, True]


def _positions(rng, B, L, G):
    """Traceback-like positions: runs with gaps, unaligned stretches, -1."""
    pos = np.full((B, L), -1, np.int32)
    for b in range(B):
        if b % 6 == 0:
            continue
        p = int(rng.integers(-5, G - L))
        for i in range(L):
            step = rng.random()
            if step < 0.05:
                p += int(rng.integers(2, 4))  # deletion
            if step > 0.95 or p < 0:
                pos[b, i] = -1  # insertion / clip
                continue
            pos[b, i] = p
            p += 1
    return pos


def test_pileups_match_jax(rng):
    B, L, G = 50, 40, 400
    codes = torch.from_numpy(rng.integers(0, 6, (B, L)).astype(np.uint8))
    lens = torch.from_numpy(rng.integers(0, L + 1, B).astype(np.int32))
    starts = torch.from_numpy(rng.integers(-10, G, B).astype(np.int32))
    mapped = torch.from_numpy(rng.random(B) < 0.8)
    qual = torch.from_numpy(rng.random((B, L)) < 0.9)
    pos = torch.from_numpy(_positions(rng, B, L, G))
    jc, jl, js, jm, jq, jp = (jnp.asarray(t.numpy()) for t in
                              (codes, lens, starts, mapped, qual, pos))
    for q, jqq in ((None, None), (qual, jq)):
        got = vp._pileup_batch(codes, lens, starts, mapped, G, q)
        want = jvp._pileup_batch(jc, jl, js, jm, G, jqq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = vp._pileup_positions(codes, pos, G, q)
        want = np.asarray(jvp._pileup_positions(jc, jp, G, jqq))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[:, 5].sum() > 0 and want[:, 6].sum() > 0
    # in place: two batches into one accumulator == the sum
    acc = vp._new_pileup(G, CPU)
    vp._pileup_batch(codes, lens, starts, mapped, G, acc=acc)
    vp._pileup_positions(codes, pos, G, acc=acc)
    np.testing.assert_array_equal(
        vp.pileup_view(acc).numpy(),
        np.asarray(jvp._pileup_batch(jc, jl, js, jm, G))
        + np.asarray(jvp._pileup_positions(jc, jp, G)))


def test_ungapped_positions_pile_up_bases_and_no_gap_event(rng):
    """The positions the ungapped path hands the pileup: each mapped
    read's bases at start + column, negative starts and starts near G
    included; the counts equal a loop over the bases, and no deletion or
    insertion is ever found in them."""
    B, L, G = 60, 40, 300
    codes = rng.integers(0, 6, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    starts = rng.integers(-30, G + 5, B).astype(np.int32)
    mapped = rng.random(B) < 0.8
    qual = rng.random((B, L)) < 0.9
    pos = vp._ungapped_positions(torch.from_numpy(lens),
                                 torch.from_numpy(starts),
                                 torch.from_numpy(mapped), L)
    assert pos.dtype == torch.int64
    for q in (None, qual):
        want = np.zeros((G, 7), np.int32)
        for b in np.flatnonzero(mapped):
            for i in range(lens[b]):
                p = int(starts[b]) + i
                if 0 <= p < G and codes[b, i] <= 3 and (q is None or q[b, i]):
                    want[p, codes[b, i]] += 1
        tq = None if q is None else torch.from_numpy(q)
        got = vp._pileup_positions(torch.from_numpy(codes), pos, G, tq)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[:, :4].sum() > 0
        np.testing.assert_array_equal(
            vp._pileup_batch(torch.from_numpy(codes), torch.from_numpy(lens),
                             torch.from_numpy(starts),
                             torch.from_numpy(mapped), G, tq).numpy(), want)


def test_pileup_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper checks before it builds anything: CPU tensors,
    a wrong dtype or shape, a non-contiguous operand and a wrong
    accumulator raise, and nothing launches."""
    from mini_parallel_tpu_torch.ops import pileup_cuda

    G = 10
    codes = torch.zeros((4, 8), dtype=torch.uint8)
    pos = torch.zeros((4, 8), dtype=torch.int64)
    acc = vp._new_pileup(G, CPU)
    run = pileup_cuda.pileup_positions_cuda
    launches = run.launches
    for args, match in [
            ((codes, pos, G, None, acc), "CUDA"),
            ((codes.int(), pos, G, None, acc), "uint8"),
            ((codes, pos.float(), G, None, acc), "int32 or int64"),
            ((codes, pos[:, :7], G, None, acc), "shape"),
            ((codes, pos, G, torch.ones((4, 8), dtype=torch.uint8), acc),
             "qual_ok"),
            ((codes, pos, G, None, acc.long()), "acc must be"),
            ((codes, pos, 0, None, acc), "positive"),
            ((codes.t(), pos.t(), G, None, acc), "contiguous"),
            ((codes, pos, G, torch.ones((8, 4), dtype=torch.bool).t(), acc),
             "contiguous")]:
        with pytest.raises(ValueError, match=match):
            run(*args)
    assert run.launches == launches and int(acc.sum()) == 0


def test_revcomp_reverse_prefix_codes_to_ascii_match_jax(rng):
    B, L = 30, 37
    codes = torch.from_numpy(rng.integers(0, 7, (B, L)).astype(np.uint8))
    lens = torch.from_numpy(rng.integers(0, L + 1, B).astype(np.int32))
    keep = torch.from_numpy(rng.random(B) < 0.7)
    mask = torch.from_numpy(rng.random((B, L)) < 0.5)
    jc, jl, jk, jmask = (jnp.asarray(t.numpy()) for t in
                         (codes, lens, keep, mask))
    np.testing.assert_array_equal(vp._revcomp_codes(codes, lens).numpy(),
                                  np.asarray(jvp._revcomp_codes(jc, jl)))
    np.testing.assert_array_equal(vp._reverse_prefix(mask, lens).numpy(),
                                  np.asarray(jvp._reverse_prefix(jmask, jl)))
    np.testing.assert_array_equal(
        vp._codes_to_ascii(codes, lens, keep).numpy(),
        np.asarray(jvp._codes_to_ascii(jc, jl, jk)))
    np.testing.assert_array_equal(vp._codes_to_ascii(codes, lens).numpy(),
                                  np.asarray(jvp._codes_to_ascii(jc, jl)))


@pytest.mark.parametrize("L", [1, 8, 37, 152])
def test_pack_bits_matches_jax(rng, L):
    mask = rng.random((9, L)) < 0.5
    pk = packed.pack_bits(mask)
    np.testing.assert_array_equal(pk, jpacked.pack_bits(mask))
    got = packed.unpack_bits_device(torch.from_numpy(pk), L)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpacked.unpack_bits_device(jnp.asarray(pk), L)))
    np.testing.assert_array_equal(got.numpy(), mask)


def test_rescue_unmapped_matches_jax(rng):
    """_rescue_unmapped on a batch with forward and reverse seed-misses:
    the float32 threshold, the strand choice and the anchor."""
    ref = rng.choice(_ACGT, 1500).tobytes()
    rows = []
    for k in range(12):
        s = int(rng.integers(0, 1400))
        r = bytearray(ref[s:s + 60])
        for m in (3, 20, 37, 50):
            r[m] = ord("A") if r[m] != ord("A") else ord("C")
        if k % 2:
            r = bytearray(bytes(r).translate(_RC)[::-1])
        if k % 5 == 4:
            r = bytearray(rng.choice(_ACGT, 60).tobytes())
        rows.append(bytes(r[: 60 - k]))
    arr, lens = encode.pad_batch(rows, pad_to=64, pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(torch.from_numpy(arr))
    lens_t = torch.from_numpy(lens)
    rc = vp._revcomp_codes(codes, lens_t)
    starts = torch.full((12,), -1, dtype=torch.int32)
    mapped = torch.from_numpy(np.arange(12) % 4 == 0)
    ref_t = torch.from_numpy(np.frombuffer(ref, np.uint8).copy())
    for frac in (0.6, 0.85):
        got = vp._rescue_unmapped(codes, rc, lens_t, ref_t, starts, mapped,
                                  frac)
        want = jvp._rescue_unmapped(
            jnp.asarray(codes.numpy()), jnp.asarray(rc.numpy()),
            jnp.asarray(lens), jnp.asarray(np.frombuffer(ref, np.uint8)),
            jnp.asarray(starts.numpy()), jnp.asarray(mapped.numpy()), frac)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 3


# ----------------------------------------------------------------------
# The CLI against the JAX package's CLI
# ----------------------------------------------------------------------

_VARIABLE = ("Device:",)


def _both(argv, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out, jout = [], []
    rc = cli.main(argv + ["--allow-cpu"], echo=out.append)
    jrc = jcli.main(argv + ["--allow-cpu"], echo=jout.append)
    keep = lambda lines: [ln for ln in lines  # noqa: E731
                          if not ln.startswith(_VARIABLE)]
    return rc, jrc, keep(out), keep(jout)


@pytest.mark.parametrize("extra", [
    [], ["--gapped", "--gap-model", "affine", "--sam-out", "{d}/x.sam"],
    ["--min-base-quality", "10", "--prep-checkpoint", "{d}/c.npz",
     "--prep-checkpoint-every", "2"],
])
def test_cli_variant_prep_matches_jax(sample, monkeypatch, tmp_path, extra):
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", str(CHUNK))
    argv = ["--variant-prep", ",".join(sample["lanes"]), "--reference",
            sample["ref"], "--vcf-out", "{d}/o.vcf"] + extra
    outs = []
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        args = [a.format(d=d) for a in argv]
        main = cli.main if side == "port" else jcli.main
        lines = []
        monkeypatch.chdir(d)
        assert main(args + ["--allow-cpu"], echo=lines.append) == 0
        # a snapshot's zip entries carry their write time: compare contents
        files = {p.name: (p.read_bytes() if p.suffix != ".npz" else
                          {k: v.tolist() for k, v in np.load(p).items()})
                 for p in d.iterdir()}
        outs.append(([ln.replace(str(d), "D") for ln in lines
                      if not ln.startswith(_VARIABLE)], files))
    assert outs[0] == outs[1]
    assert any(ln.startswith("Candidate variant sites:") for ln in outs[0][0])


def test_cli_variant_prep_errors_match_jax(sample, monkeypatch, tmp_path):
    lane = sample["lanes"][0]
    for argv in (["--variant-prep", lane],
                 ["--variant-prep", lane, "--reference", sample["ref"],
                  "--sam-out", "x.sam"],
                 ["--variant-prep", lane, "--reference",
                  str(tmp_path / "missing.fa")]):
        rc, jrc, out, jout = _both(argv, monkeypatch, tmp_path)
        assert rc == jrc and rc in (1, 2)
        assert out == jout and out[-1].startswith("ERROR:")


def test_cli_genotype_not_yet_ported(sample, monkeypatch, tmp_path):
    """Nothing --genotype combines with is left unported: under a mesh of
    8 CPU shards (MPT_MESH_SHAPE=8) the run prints the lines the port
    prints without a mesh, the genotyping line's lane counts included (the
    JAX CLI's mesh runs are compared in tests/test_torch_parallel.py)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--variant-prep", sample["lanes"][0], "--reference",
            sample["ref"], "--gapped", "--genotype", "--allow-cpu"]
    runs = []
    for shape in ("", "8"):
        monkeypatch.setenv("MPT_MESH_SHAPE", shape)
        out = []
        assert cli.main(argv, echo=out.append) == 0
        runs.append([ln for ln in out if not ln.startswith(_VARIABLE)])
    assert runs[0] == runs[1]
    assert sum(" GT=" in ln for ln in runs[0]) >= 3
    assert not any("not yet ported" in ln for ln in runs[1])


def test_variant_paths_leave_kernel_counters_untouched(sample, monkeypatch):
    """On the CPU the engines run the plain versions: no kernel counter
    moves (a CUDA tensor would launch the kernel or raise)."""
    from mini_parallel_tpu_torch.ops import sw_cuda, sw_traceback_cuda

    counters = (sw_cuda.sw_vs_ref_batch_cuda,
                sw_traceback_cuda.sw_moves_batch_cuda,
                sw_traceback_cuda.sw_affine_moves_batch_cuda)
    for fn in counters:
        monkeypatch.setattr(fn, "launches", 0)
    cfg, _ = _cfgs()
    for kw in (dict(gapped=True, rescue=True),
               dict(gapped=True, gap_model="affine")):
        vp.VariantPrepEngine(sample["contigs"], cfg, device=CPU,
                             **kw).process_file(sample["lanes"][1])
    assert [fn.launches for fn in counters] == [0, 0, 0]
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_vs_ref_batch_cuda(torch.zeros((2, 4), dtype=torch.uint8),
                                     torch.zeros(9, dtype=torch.uint8))
