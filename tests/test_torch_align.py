"""The port's batched CIGAR aligners and its batch and stream helpers on the
CPU against the JAX package on the same seeded inputs, exactly:
``sw_align_batch`` / ``sw_affine_align_batch`` (the plain route: the plain
moves scans, then the host walk), ``ComplementarityEngine.
score_pairs_batch``, ``VariantPrepEngine.process_reads_batch``, the FASTQ
helpers (``count_reads``, ``process_fastq_file_in_chunks``, the two
``_multi`` streams, ``count_lines_stdin``), ``PackedBatch.wire_bytes`` and
the device probes. The card route of the aligners is in test_torch_cuda.py.
"""

import dataclasses
import gzip
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu import device as jdevice
from mini_parallel_tpu.io import fastq as jfastq
from mini_parallel_tpu.models import complementarity as jcomp
from mini_parallel_tpu.models import variant_prep as jvp
from mini_parallel_tpu.ops import packed as jpacked
from mini_parallel_tpu.ops import sw_traceback as jtb
from mini_parallel_tpu.utils.config import Config as JConfig
from mini_parallel_tpu_torch import device
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.models import complementarity as comp
from mini_parallel_tpu_torch.models import variant_prep as vp
from mini_parallel_tpu_torch.ops import encode, packed
from mini_parallel_tpu_torch.ops import sw_traceback as tb
from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna
from tests.test_torch_segments import _kernel_moves_words

CPU = torch.device("cpu")
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_RC = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def _random_pairs(rng):
    """Random pairs of 0-60 bases, empty reads among them."""
    ra = [random_dna(rng, int(rng.integers(0, 60))) for _ in range(20)]
    rb = [random_dna(rng, int(rng.integers(5, 60))) for _ in range(20)]
    ra[3] = b""
    return ra, rb


def _indel_pairs(rng):
    """The JAX traceback tests' pairs: a 4-base insertion in the query,
    4-base deletions, 5-base insertions, a mismatch with a 2-base deletion
    (test_affine_traceback._indel_pairs), an empty query, unrelated
    reads."""
    t = random_dna(rng, 80)
    ra, rb = [t[:40] + b"GGGG" + t[40:]], [t]
    for i in range(14):
        b = random_dna(rng, 56)
        a = bytearray(b[4:52])
        if i % 4 == 0:
            del a[20:24]
        if i % 4 == 1:
            a[12:12] = b"TTCGA"
        if i % 4 == 2:
            a[8] = ord("T") if a[8] != ord("T") else ord("G")
            del a[30:32]
        ra.append(bytes(a))
        rb.append(b)
    ra += [b"", random_dna(rng, 30)]
    rb += [random_dna(rng, 30), random_dna(rng, 30)]
    return ra, rb


def _no_alignment(rng):
    """Nothing aligns: no shared base, and empty reads on either side."""
    return [b"AAAA", b"", b"CCCC", b""], [b"TTTT", b"GGGG", b"", b""]


def _iupac_pairs(rng):
    """N, IUPAC codes and lowercase: bytes compare as they are."""
    ra, rb = [], []
    for _ in range(12):
        b = bytearray(random_dna(rng, 50))
        a = bytearray(b[5:45])
        for j in rng.integers(0, len(a), 3):
            a[j] = ord("NRYKMSWacgt"[int(rng.integers(0, 11))])
        b[int(rng.integers(0, 50))] = ord("N")
        ra.append(bytes(a))
        rb.append(bytes(b))
    return ra, rb


PAIR_SETS = {"random": _random_pairs, "indels": _indel_pairs,
             "no-alignment": _no_alignment, "iupac-lowercase": _iupac_pairs}
GAPS = [None, (-4, -1), (-3, 0), (-6, -2)]


def _padded(ra, rb, pad=96):
    a, _ = encode.pad_batch(ra, pad_to=pad, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(rb, pad_to=pad, pad_value=int(encode.PAD_B))
    return a, b


def _fields(alns):
    return [dataclasses.astuple(x) for x in alns]


@pytest.mark.parametrize("gaps", [False, *GAPS],
                         ids=["linear", "affine-default", "affine-4-1",
                              "affine-3-0", "affine-6-2"])
@pytest.mark.parametrize("pairs", list(PAIR_SETS))
def test_align_batch_matches_jax_and_golden(pairs, gaps):
    """Every Alignment (score, the four coordinates, the CIGAR) equals the
    JAX package's and the port's golden, pair for pair."""
    ra, rb = PAIR_SETS[pairs](np.random.default_rng(7))
    a, b = _padded(ra, rb)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    if gaps is False:
        got = tb.sw_align_batch(ta, tb_)
        want = jtb.sw_align_batch(jnp.asarray(a), jnp.asarray(b))
        golden = [tb.sw_align_numpy(x, y) for x, y in zip(ra, rb)]
    else:
        kw = {} if gaps is None else dict(gap_open=gaps[0],
                                          gap_extend=gaps[1])
        got = tb.sw_affine_align_batch(ta, tb_, **kw)
        want = jtb.sw_affine_align_batch(jnp.asarray(a), jnp.asarray(b),
                                         **kw)
        golden = [tb.sw_affine_align_numpy(x, y, **kw)
                  for x, y in zip(ra, rb)]
    assert all(isinstance(x, tb.Alignment) for x in got)
    assert _fields(got) == _fields(want) == _fields(golden)
    if pairs == "no-alignment":
        assert _fields(got) == [(0, 0, 0, 0, 0, "")] * 4
    if pairs == "indels":
        assert "I" in got[0].cigar


@pytest.mark.parametrize("affine", [False, True])
def test_align_batch_empty_shapes(affine):
    """No pairs, no query columns, no reference columns."""
    fn = tb.sw_affine_align_batch if affine else tb.sw_align_batch
    for B, M, N in ((0, 8, 8), (3, 0, 8), (2, 8, 0)):
        got = fn(torch.zeros((B, M), dtype=torch.uint8),
                 torch.zeros((B, N), dtype=torch.uint8))
        assert _fields(got) == [(0, 0, 0, 0, 0, "")] * B


def _long_query_pairs(rng):
    """Queries of 200-300 bases (two stripes of the kernel's rows) that
    hold their 90-base reference with an insertion or a deletion."""
    ra, rb = [], []
    for k in range(6):
        t = random_dna(rng, 90)
        mid = t[:40] + b"GGTA" + t[40:] if k % 2 else t[:30] + t[34:]
        ra.append(random_dna(rng, int(rng.integers(110, 200))) + mid)
        rb.append(t)
    return ra, rb


@pytest.mark.parametrize("M,N", [(64, 64), (300, 90)])
@pytest.mark.parametrize("affine", [False, True])
def test_kernel_words_reach_the_host_walk(affine, M, N):
    """The card route's host walk: the kernel's moves words (stored as its
    lanes store them; two stripes of rows at M = 300) walk straight to the
    plain route's Alignments, and moves_to_cells of the words is the plain
    cells."""
    rng = np.random.default_rng(11 + M)
    ra, rb = (_indel_pairs(rng) if M == 64 else _long_query_pairs(rng))
    a, _ = encode.pad_batch(ra[1:8], pad_to=M, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(rb[1:8], pad_to=N, pad_value=int(encode.PAD_B))
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    best, bd, bi, moves = (tb.sw_affine_moves_batch(ta, tb_, -3, -1)
                           if affine else tb.sw_moves_batch(ta, tb_))
    cells = tb.plain_moves_to_cells(moves, N)
    words = _kernel_moves_words(cells.numpy(), affine, rng)
    assert tbc.moves_words_per_pair(M, N, affine) == words.shape[1]
    assert torch.equal(tbc.moves_to_cells(torch.from_numpy(words), M, N,
                                          affine), cells)
    got = tb.traceback_words_host(best.numpy(), bd.numpy(), bi.numpy(),
                                  words, M, N, affine)
    want = (tb.sw_affine_align_batch(ta, tb_, -3, -1) if affine
            else tb.sw_align_batch(ta, tb_))
    assert _fields(got) == _fields(want)
    assert all(x.score > 0 for x in got)


# ---------------------------------------------------------------------------
# Batch helpers
# ---------------------------------------------------------------------------


def _mates(rng, n=40):
    """Mate pairs: perfect reverse complements, broken ones, IUPAC and
    lowercase bytes, uneven lengths and an empty mate."""
    r1, r2 = [], []
    for k in range(n):
        s = random_dna(rng, int(rng.integers(20, 150)))
        m = s.translate(_RC)[::-1]
        if k % 3 == 1:
            m = m[:10] + b"N" + m[11:]
        if k % 7 == 2:
            s = s.lower()
        if k % 5 == 3:
            m = m[: len(m) // 2]
        r1.append(s)
        r2.append(m)
    r1[4], r2[9] = b"", b"RYKM" + r2[9]
    return r1, r2


@pytest.mark.parametrize("mode", ["sw", "kadane"])
def test_score_pairs_batch_matches_jax(mode):
    r1, r2 = _mates(np.random.default_rng(3))
    cfg = Config(chunk_size_reads=64)
    got = comp.ComplementarityEngine(cfg, mode=mode, device=CPU
                                     ).score_pairs_batch(r1, r2)
    want = jcomp.ComplementarityEngine(
        JConfig(**dataclasses.asdict(cfg)), mode=mode).score_pairs_batch(
            r1, r2)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (len(r1),)
        assert np.array_equal(g, np.asarray(w))
    assert got[2].dtype == np.bool_ and 5 < int(got[2].sum()) < len(r1)


@pytest.fixture(scope="module")
def reference():
    rng = np.random.default_rng(2027)
    return {"chr1": rng.choice(_ACGT, 3000).tobytes(),
            "chr2": rng.choice(_ACGT, 1500).tobytes()}


def _sample_reads(reference, n=90):
    """Reads cut from the reference (half reverse-complemented, a 3-base
    deletion in some), junk, an empty read; Phred+33 quals with Q2 bases
    and one short quality string."""
    rng = np.random.default_rng(5)
    seqs, quals = [], []
    contigs = list(reference.values())
    for k in range(n):
        ref = contigs[k % 2]
        length = int(rng.integers(60, 150))
        s = int(rng.integers(0, len(ref) - length - 3))
        r = ref[s:s + length + 3]
        r = r[:30] + r[33:] if k % 4 == 0 else r[:length]
        if k % 2:
            r = r.translate(_RC)[::-1]
        q = np.full(len(r), ord("I"), np.uint8)
        q[rng.random(len(r)) < 0.1] = ord("#")
        seqs.append(r)
        quals.append(q.tobytes())
    seqs += [rng.choice(_ACGT, 100).tobytes(), b""]
    quals += [b"I" * 50, b""]
    return seqs, quals


@pytest.mark.parametrize("with_quals", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(gapped=True),
                                dict(gapped=True, gap_model="affine")],
                         ids=["ungapped", "gapped", "gapped-affine"])
def test_process_reads_batch_matches_jax(reference, kw, with_quals):
    """The pileup and the mapped count of one list batch, twice into one
    accumulator; with quals under min_base_quality 10."""
    seqs, quals = _sample_reads(reference)
    q = quals if with_quals else None
    cfg = Config(chunk_size_reads=128, gap_open=-3, gap_extend=-1)
    eng = vp.VariantPrepEngine(reference, cfg, device=CPU,
                               min_base_quality=10 if with_quals else 0,
                               **kw)
    jeng = jvp.VariantPrepEngine(reference, JConfig(
        **dataclasses.asdict(cfg)), min_base_quality=10 if with_quals else 0,
        **kw)
    acc = eng.new_pileup()
    jacc = jnp.zeros((len(jeng.index.ref_codes), 7), jnp.int32)
    for half in (slice(0, 50), slice(50, None)):
        acc, n = eng.process_reads_batch(seqs[half], acc,
                                         q[half] if q else None)
        jacc, jn = jeng.process_reads_batch(seqs[half], jacc,
                                            q[half] if q else None)
        assert int(n) == int(jn) and int(n) > 0
    assert np.array_equal(vp.pileup_view(acc).numpy(), np.asarray(jacc))
    if with_quals:
        with pytest.raises(ValueError, match="quality strings"):
            eng.process_reads_batch(seqs[:3], acc, quals[:2])


# ---------------------------------------------------------------------------
# FASTQ stream helpers, wire bytes, device probes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """Two lanes: ragged reads with N and lowercase, an empty read, and the
    second lane's last record cut after its sequence line."""
    rng = np.random.default_rng(9)
    d = tmp_path_factory.mktemp("fastq")
    paths = []
    for k, n in ((1, 23), (2, 17)):
        recs = b""
        for i in range(n):
            r = bytearray(random_dna(rng, int(rng.integers(0, 90))))
            if i % 5 == 1 and r:
                r[0] = ord("N")
            r = bytes(r).lower() if i % 6 == 2 else bytes(r)
            recs += b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
        if k == 2:
            recs += b"@cut\nACGTACGT\n"
        path = str(d / f"L{k}.fastq.gz")
        with open(path, "wb") as f:
            f.write(gzip.compress(recs))
        paths.append(path)
    return paths


@pytest.mark.parametrize("engine", ["native", "python"])
def test_count_reads_and_callback_chunks_match_jax(lanes, engine):
    for path in lanes:
        assert fastq.count_reads(path, 5, engine=engine) == \
            jfastq.count_reads(path, 5)
        got, want = [], []
        assert fastq.process_fastq_file_in_chunks(
            path, 4, got.append, engine=engine) == \
            jfastq.process_fastq_file_in_chunks(path, 4, want.append)
        assert got == want and len(got) > 1


@pytest.mark.parametrize("engine", ["native", "python"])
def test_multi_streams_match_jax(lanes, engine):
    """Files concatenate in order, each chunked on its own; the quals
    stream gives the cut record an empty quality string."""
    got = list(fastq.iter_read_chunks_multi(lanes, 6, engine=engine))
    assert got == list(jfastq.iter_read_chunks_multi(lanes, 6))
    assert sum(map(len, got)) == 41
    got_q = list(fastq.iter_read_chunks_with_quals_multi(lanes, 6,
                                                         engine=engine))
    assert got_q == [tuple(c) for c in
                     jfastq.iter_read_chunks_with_quals_multi(lanes, 6)]
    assert got_q[-1][1][-1] == b""


def test_count_lines_stdin_matches_jax(lanes):
    with gzip.open(lanes[1], "rb") as f:
        raw = f.read()
    for data in (raw, raw + b"no newline", b"", b"\n\n\r\n"):
        assert fastq.count_lines_stdin(io.BytesIO(data)) == \
            jfastq.count_lines_stdin(io.BytesIO(data))


def test_wire_bytes_match_jax():
    rng = np.random.default_rng(4)
    reads = [random_dna(rng, int(rng.integers(0, 150))) for _ in range(30)]
    reads[2] = b"ACGTNNRYacgt"
    arr, lens = encode.pad_batch(reads, pad_to=152,
                                 pad_value=int(encode.PAD_A))
    got = packed.pack_batch(arr, lens)
    want = jpacked.pack_batch(arr, lens)
    assert got.wire_bytes() == want.wire_bytes()
    assert got.wire_bytes() == (got.packed.nbytes + got.exc_col.nbytes
                                + got.exc_val.nbytes + got.lengths.nbytes)
    assert got.wire_bytes() < arr.nbytes


def test_device_probes_without_cuda():
    """No CUDA here: no accelerator, as the JAX package says on its CPU
    devices, and no device to list."""
    assert device.is_accelerator_available() is False
    assert jdevice.is_accelerator_available() is False
    assert device.get_devices() == []
    info = device.DeviceInfo(name="x", platform="gpu", index=0)
    assert dataclasses.asdict(info) == dataclasses.asdict(
        jdevice.DeviceInfo(name="x", platform="gpu", index=0))
