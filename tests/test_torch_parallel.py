"""The port's device meshes (mini_parallel_tpu_torch/parallel/) on the CPU
against the JAX package's sharded functions.

The JAX side runs on the conftest's 8-device virtual CPU mesh (``mesh8``),
with Pallas in interpret mode; the port side on a mesh of eight CPU shards,
``make_mesh((8,), devices=[cpu] * 8)``. Every comparison is exact (integer
scores, counts, pileups, histograms, VCF bytes) except the Pair-HMM's,
which keeps tests/test_torch_pairhmm.py's F32_TOL = 1e-4 against the JAX
package; the port's sharded Pair-HMM equals its own single-device one
exactly (the lanes are independent). Covered: the mesh helpers and
collectives, the sharded WGS step (unpacked and packed) and the
sequence-parallel Kadane, the sharded engines (alignment, complementarity,
k-mer, variant prep, genotyping), the long-pair row bands, and the CLI
under MPT_MESH_SHAPE.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from mini_parallel_tpu import cli as jcli
from mini_parallel_tpu.models.alignment import AlignmentEngine as JAlignment
from mini_parallel_tpu.models.complementarity import (
    ComplementarityEngine as JComplementarity,
)
from mini_parallel_tpu.models.kmer_model import KmerEngine as JKmer
from mini_parallel_tpu.models.variant_prep import (
    VariantPrepEngine as JVariantPrep,
)
from mini_parallel_tpu.ops import pairhmm_pallas as jph
from mini_parallel_tpu.ops import sw_long as jsw_long
from mini_parallel_tpu.parallel import mesh as jmesh
from mini_parallel_tpu.parallel import pipeline as jpipeline
from mini_parallel_tpu.utils.config import Config as JConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.device import NoAcceleratorError
from mini_parallel_tpu_torch.io import fasta, fastq
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.models.complementarity import (
    ComplementarityEngine,
)
from mini_parallel_tpu_torch.models.kmer_model import KmerEngine
from mini_parallel_tpu_torch.models.variant_prep import VariantPrepEngine
from mini_parallel_tpu_torch.ops import encode, kadane, kmer
from mini_parallel_tpu_torch.ops import packed as packedmod
from mini_parallel_tpu_torch.ops import pairhmm, sw_long
from mini_parallel_tpu_torch.parallel import collectives, pipeline
from mini_parallel_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_to_shards,
    put_sharded,
    shard_batch,
)
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
F32_TOL = 1e-4  # tests/test_torch_pairhmm.py: port vs the JAX Pair-HMM
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh((8,), devices=[CPU] * 8)


def _jcfg(cfg: Config, **jax_only) -> JConfig:
    """The JAX package's Config of ``cfg``, with ``jax_only`` fields the
    port does not have (its ``packed_transfer`` route switch)."""
    return JConfig(**dataclasses.asdict(cfg), **jax_only)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------------------
# mesh construction, sharding, collectives (tests/test_parallel.py)
# ----------------------------------------------------------------------


def test_mesh_shapes_and_axes():
    m = make_mesh(devices=[CPU] * 8)
    assert m.devices.size == 8 and m.axis_names == ("data",)
    assert m.shape == {"data": 8}
    m2 = make_mesh((4, 2), devices=[CPU] * 8)
    assert m2.axis_names == ("data", "seq") and m2.shape == {"data": 4,
                                                             "seq": 2}
    assert len(m2.axis_devices()) == 4 and len(m2.axis_devices("seq")) == 2
    for bad in ((3,), (2, 2, 2)):
        with pytest.raises(ValueError):
            make_mesh(bad, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="duplicate"):
        make_mesh((2, 4), ("data", "data"), devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(NoAcceleratorError):
            make_mesh()
    assert pad_to_shards(13, 8) == jmesh.pad_to_shards(13, 8) == 16
    assert pad_to_shards(13, 4, 8) == jmesh.pad_to_shards(13, 4, 8) == 32


def test_shard_batch_and_put_sharded_split_rows_in_order(tmesh8, rng):
    x = rng.integers(0, 9, (16, 3))
    shards = shard_batch(tmesh8, (x,))
    assert len(shards) == 8
    assert torch.equal(torch.cat([s[0] for s in shards]), _t(x))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(tmesh8, (x[:13],))
    reads = [random_dna(rng, int(n)) for n in rng.integers(0, 40, 13)]
    arr, lens = encode.pad_batch(reads, pad_to=40, pad_value=int(encode.PAD_A))
    pb = packedmod.pack_batch(arr, lens)
    parts = put_sharded(pb, tmesh8)
    assert [p[0].shape[0] for p in parts] == [2] * 8  # 13 rows -> 16
    got = torch.cat([packedmod.unpack_device(*p, int(encode.PAD_A))
                     for p in parts])
    assert torch.equal(got[:13], _t(arr))
    assert (got[13:] == int(encode.PAD_A)).all()


def test_collectives_fold_in_shard_order(rng):
    parts = [torch.tensor(v, dtype=torch.int32) for v in (3, -1, 7, 2)]
    assert int(collectives.merge_scores(parts)) == 11
    assert int(collectives.merge_max(parts)) == 7
    hist = [_t(rng.integers(0, 5, 6).astype(np.int32)) for _ in range(3)]
    assert torch.equal(collectives.merge_histogram(hist), sum(hist))
    scores = _t(rng.integers(-3, 4, (5, 64)).astype(np.int32))
    valid = torch.ones_like(scores, dtype=torch.bool)
    split = [s for s in torch.split(scores, 16, dim=1)]
    got = collectives.sequence_parallel_kadane(
        split, [torch.ones_like(s, dtype=torch.bool) for s in split])
    assert torch.equal(got, kadane.kadane_summary(scores, valid).best)


@pytest.fixture(scope="module")
def wgs_batch():
    rng = np.random.default_rng(42)
    ra = [random_dna(rng, int(rng.integers(25, 60))) for _ in range(56)]
    rb = [random_dna(rng, int(rng.integers(20, 60))) for _ in range(56)]
    # 8 perfectly complementary mates, an N that kills k = 21 windows
    ra += [random_dna(rng, 40) for _ in range(8)]
    rb += [r.translate(_COMP)[::-1] for r in ra[-8:]]
    ra[2] = ra[2][:10] + b"N" + ra[2][11:]
    arr_a, len_a = encode.pad_batch(ra, pad_to=64, pad_value=int(encode.PAD_A))
    arr_b, len_b = encode.pad_batch(rb, pad_to=64, pad_value=int(encode.PAD_B))
    return arr_a, arr_b, len_a, len_b


def test_wgs_step_matches_jax_step(wgs_batch, tmesh8, mesh8):
    """make_wgs_step and make_wgs_step_packed on 8 CPU shards == the JAX
    package's sharded step on its 8-device mesh, key by key, and == the
    port's one-shard mesh."""
    want = jax.device_get(jpipeline.make_wgs_step(mesh8)(
        *jpipeline.shard_batch(mesh8, tuple(jnp.asarray(x)
                                            for x in wgs_batch))))
    arr_a, arr_b, len_a, len_b = wgs_batch
    packed = (packedmod.pack_batch(arr_a, len_a),
              packedmod.pack_batch(arr_b, len_b))
    one = make_mesh((1,), devices=[CPU])
    runs = [pipeline.make_wgs_step(tmesh8)(*wgs_batch),
            pipeline.make_wgs_step_packed(tmesh8)(*packed),
            pipeline.make_wgs_step(one)(*wgs_batch)]
    for got in runs:
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
    assert int(runs[0]["complementary_pairs"]) >= 8
    assert runs[0]["kmer_hist"].shape == (pipeline.KMER_HIST_BUCKETS,)
    golden = kmer.count_kmers_python(
        [bytes(r[:n]) for r, n in zip(arr_a, len_a)], k=21)
    assert int(runs[0]["kmer_hist"].sum()) == sum(golden.values())


@pytest.mark.parametrize("B,L", [(4, 512), (2, 256)])
def test_seq_parallel_kadane_matches_jax(B, L):
    rng = np.random.default_rng(B + L)
    scores = rng.integers(-3, 4, size=(B, L)).astype(np.int32)
    valid = rng.random((B, L)) < 0.9
    want = np.asarray(jpipeline.make_seq_parallel_kadane(
        jmesh.make_mesh((1, 8)))(jnp.asarray(scores), jnp.asarray(valid)))
    got = pipeline.make_seq_parallel_kadane(
        make_mesh((1, 8), devices=[CPU] * 8))(scores, valid)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# the sharded engines (tests/test_sharded_engine.py, test_workloads.py)
# ----------------------------------------------------------------------


@pytest.fixture
def lane(tmp_path, rng):
    reads = [random_dna(rng, 200) for _ in range(26)]  # odd count: pad rows
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    return path


@pytest.mark.parametrize("mode", ["kadane", "contiguous", "sw", "sw-affine"])
@pytest.mark.parametrize("jax_packed", [True, False])
def test_sharded_self_align_matches_local_and_jax(lane, mode, jax_packed,
                                                  tmesh8, mesh8):
    """The port's one (packed) route against the JAX package's packed
    and raw routes; with the raw one, a read_pad of 198 that the port
    rounds up to 200."""
    cfg = Config(chunk_size_reads=6, read_pad=200 if jax_packed else 198)
    local = AlignmentEngine(cfg, mode=mode, device=CPU).self_align_file(lane)
    shard = AlignmentEngine(cfg, mode=mode, mesh=tmesh8).self_align_file(lane)
    got = (shard.score, shard.total_reads, shard.total_bases, shard.chunks)
    assert got == (local.score, local.total_reads, local.total_bases,
                   local.chunks)
    if mode != "sw-affine":  # the JAX package's own mesh test's modes
        j = JAlignment(_jcfg(cfg, packed_transfer=jax_packed), mode=mode,
                       mesh=mesh8).self_align_file(lane)
        assert got == (j.score, j.total_reads, j.total_bases, j.chunks)


def test_sharded_small_batch_padding(tmp_path, rng, tmesh8):
    """Fewer chunks than shards: the pad rows contribute nothing."""
    path = str(tmp_path / "one.fastq.gz")
    fastq.write_fastq(path, [random_dna(rng, 1200)])
    cfg = Config(chunk_size_reads=1, read_pad=2048)
    assert AlignmentEngine(cfg, mode="kadane", mesh=tmesh8).self_align_file(
        path).score == 2


@pytest.mark.parametrize("mode", ["sw", "kadane", "sw-affine", "contiguous"])
def test_sharded_pair_scores_match_local_and_jax(mode, tmesh8, mesh8, rng):
    """score_read_batch over a mesh, 21 pairs (not a multiple of 8)."""
    reads_a = [random_dna(rng, int(rng.integers(20, 40))) for _ in range(21)]
    reads_b = [random_dna(rng, int(rng.integers(20, 40))) for _ in range(21)]
    cfg = Config(chunk_size_reads=8, read_pad=48)
    local = AlignmentEngine(cfg, mode=mode, device=CPU).score_read_batch(
        reads_a, reads_b)
    shard = AlignmentEngine(cfg, mode=mode, mesh=tmesh8).score_read_batch(
        reads_a, reads_b)
    want = JAlignment(_jcfg(cfg), mode=mode, mesh=mesh8).score_read_batch(
        reads_a, reads_b)
    np.testing.assert_array_equal(shard, local)
    np.testing.assert_array_equal(shard, np.asarray(want))


def test_complementarity_sharded_matches_local_and_jax(tmp_path, rng, tmesh8,
                                                       mesh8):
    r1 = [random_dna(rng, 60) for _ in range(21)]
    r2 = [r.translate(_COMP)[::-1] for r in r1[:9]] + \
        [random_dna(rng, 60) for _ in range(12)]
    f1, f2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    fastq.write_fastq(f1, r1)
    fastq.write_fastq(f2, r2)
    cfg = Config(chunk_size_reads=5)
    runs = [ComplementarityEngine(cfg, device=CPU).analyze_lane_pair(f1, f2),
            ComplementarityEngine(cfg, mesh=tmesh8).analyze_lane_pair(f1, f2),
            JComplementarity(_jcfg(cfg), mesh=mesh8).analyze_lane_pair(f1, f2)]
    stats = {(r.pairs, r.direct_score_sum, r.comp_score_sum, r.perfect_pairs)
             for r in runs}
    assert len(stats) == 1
    assert runs[1].perfect_pairs == 9


@pytest.fixture
def kmer_lanes(tmp_path, rng):
    reads = [random_dna(rng, int(rng.integers(15, 140)), b"ACGTN")
             for _ in range(53)]
    paths = [str(tmp_path / f"k{i}.fastq.gz") for i in (1, 2)]
    fastq.write_fastq(paths[0], reads[:30])
    fastq.write_fastq(paths[1], reads[30:])
    return paths


@pytest.mark.parametrize("k,canonical", [(21, False), (13, True)])
def test_kmer_engine_sharded_matches_local_and_jax(kmer_lanes, tmesh8, mesh8,
                                                   k, canonical):
    """Mesh-sharded exact counting == single device == the JAX package's
    mesh run, over batches that do not divide by 8."""
    cfg = Config(chunk_size_reads=10)
    local = KmerEngine(cfg, k=k, canonical=canonical,
                       device=CPU).count_file(kmer_lanes)
    shard = KmerEngine(cfg, k=k, canonical=canonical,
                       mesh=tmesh8).count_file(kmer_lanes)
    jres = JKmer(_jcfg(cfg), k=k, canonical=canonical,
                 mesh=mesh8).count_file(kmer_lanes)
    assert shard.total_kmers == local.total_kmers == jres.total_kmers
    assert shard.distinct_kmers == local.distinct_kmers == jres.distinct_kmers
    assert shard.counts == local.counts
    assert shard.top(10) == local.top(10) == jres.top(10)


def test_kmer_mesh_summary_equals_single_device_summary(kmer_lanes, tmesh8):
    """A mesh run in summary mode keeps the summary of the merged host
    store: the single-device summary's distinct count, histogram and top-N,
    and no table (it never drains in full behind the caller's back)."""
    cfg = Config(chunk_size_reads=10)
    one = KmerEngine(cfg, device=CPU).count_file(kmer_lanes,
                                                 result_mode="summary")
    shard = KmerEngine(cfg, mesh=tmesh8).count_file(kmer_lanes,
                                                    result_mode="summary")
    assert one.arrays == shard.arrays == ()
    assert shard.distinct_kmers == one.distinct_kmers
    assert shard.total_kmers == one.total_kmers
    np.testing.assert_array_equal(shard.histogram(64), one.histogram(64))
    assert shard.top(10) == one.top(10)
    with pytest.raises(ValueError, match="summary-mode"):
        shard.counts
    host = KmerEngine(cfg, device=CPU, device_accumulate=False).count_file(
        kmer_lanes, result_mode="summary")
    assert host.arrays == () and host.top(10) == one.top(10)


@pytest.fixture
def variant_sample(tmp_path, rng):
    """A 2 kbp reference with SNPs and a 2 bp deletion; 90 reads of 60-90
    bp, a third reverse-complemented, with qualities."""
    ref = random_dna(rng, 2000)
    hap = bytearray(ref)
    for p in (400, 900, 1600):
        hap[p] = ord("A") if ref[p] != ord("A") else ord("C")
    del hap[1300:1302]
    reads, quals = [], []
    for i in range(90):
        n = int(rng.integers(60, 91))
        s = int(rng.integers(0, len(hap) - n))
        r = bytes(hap[s:s + n])
        reads.append(r.translate(_COMP)[::-1] if i % 3 == 0 else r)
        quals.append(bytes(rng.integers(33 + 5, 33 + 40, n).astype(np.uint8)))
    path = str(tmp_path / "vp.fastq.gz")
    fastq.write_fastq(path, reads, quals)
    return ref, path


@pytest.mark.parametrize("kw,vs_jax", [
    (dict(), True), (dict(gapped=True), True),
    (dict(min_base_quality=10), True),
    (dict(gapped=True, gap_model="affine", rescue=True), False),
])
def test_variant_prep_sharded_matches_local_and_jax(variant_sample, tmesh8,
                                                    mesh8, kw, vs_jax):
    """The JAX package's three mesh cases against its mesh run; the
    affine rescue case against the port's single device (which
    tests/test_torch_variant.py holds to the JAX package)."""
    ref, path = variant_sample
    cfg = Config(chunk_size_reads=37)
    local = VariantPrepEngine(ref, cfg, device=CPU, **kw).process_file(path)
    shard = VariantPrepEngine(ref, cfg, mesh=tmesh8, **kw).process_file(path)
    others = [local]
    if vs_jax:
        others.append(JVariantPrep(ref, _jcfg(cfg), mesh=mesh8,
                                   **kw).process_file(path))
    for other in others:
        assert shard.total_reads == other.total_reads
        assert shard.mapped_reads == other.mapped_reads
        np.testing.assert_array_equal(shard.pileup, np.asarray(other.pileup))
        assert [(c.contig, c.pos, c.alt_base) for c in shard.candidates] == \
            [(c.contig, c.pos, c.alt_base) for c in other.candidates]
    assert shard.candidates


def test_genotype_candidates_sharded_matches_local_and_jax(variant_sample,
                                                           tmesh8, mesh8):
    ref, path = variant_sample
    cfg = Config(chunk_size_reads=37)
    kw = dict(gapped=True, min_depth=3, alt_fraction=0.2)
    runs = []
    for eng in (VariantPrepEngine(ref, cfg, device=CPU, **kw),
                VariantPrepEngine(ref, cfg, mesh=tmesh8, **kw),
                JVariantPrep(ref, _jcfg(cfg), mesh=mesh8, **kw)):
        runs.append(eng.genotype_candidates(path, eng.process_file(path)))
    local, shard, jres = runs
    calls = [[(c.pos, c.alt_base, c.gt, c.gq) for c in r.candidates]
             for r in runs]
    assert calls[0] == calls[1] == calls[2]
    assert any(c.gt == "1/1" for c in shard.candidates)
    for s, l, j in zip(shard.candidates, local.candidates, jres.candidates):
        assert s.gl == l.gl  # the lanes are independent: exact
        if j.gl is not None:
            np.testing.assert_allclose(s.gl, j.gl, rtol=0, atol=F32_TOL)


def _hmm_lanes(rng, B):
    reads, quals, haps = [], [], []
    for i in range(B):
        hap = random_dna(rng, 60)
        read = bytearray(hap[10:42])
        read[i % 32] = ord("A") if read[i % 32] != ord("A") else ord("G")
        reads.append(bytes(read))
        quals.append(bytes(rng.integers(33 + 10, 33 + 41, 32).astype(np.uint8)))
        haps.append(hap)
    # a lane that underflows float32 (recomputed in float64) and an empty one
    hap = random_dna(rng, 140)
    reads += [hap[:120].translate(_COMP), b""]
    quals += [np.full(120, 40.0), b""]
    haps += [hap, hap]
    return reads, quals, haps


def test_pairhmm_sharded_matches_local_and_jax(rng, tmesh8, mesh8):
    """make_pairhmm_sharded (16 lanes, 2 a shard) == the single-device
    forward exactly, and == the JAX package's make_pairhmm_sharded."""
    reads, _, haps = _hmm_lanes(rng, 16)
    reads, haps = reads[:16], haps[:16]
    arr_r, la = encode.pad_batch(reads, pad_to=32, pad_value=int(encode.PAD_A))
    arr_h, lb = encode.pad_batch(haps, pad_to=64, pad_value=int(encode.PAD_B))
    err = np.full((16, 32), 1e-2, np.float32)
    args = (arr_r, err, arr_h, la, lb)
    got = pairhmm.make_pairhmm_sharded(tmesh8)(*(_t(x) for x in args))
    local = pairhmm.pairhmm_batch_best(*(_t(x) for x in args))
    assert torch.equal(got, local)
    want = np.asarray(jph.make_pairhmm_sharded(mesh8)(
        *(jnp.asarray(x) for x in args)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


def test_pairhmm_log10_batch_mesh_matches_local_and_jax(rng, tmesh8, mesh8):
    """11 + 2 lanes (not a multiple of 8), one recomputed in float64."""
    reads, quals, haps = _hmm_lanes(rng, 11)
    local = pairhmm.pairhmm_log10_batch(reads, quals, haps, device=CPU)
    got = pairhmm.pairhmm_log10_batch(reads, quals, haps, mesh=tmesh8)
    np.testing.assert_array_equal(got, local)
    assert got[-2] < pairhmm.FP32_FLOOR_LOG10 and np.isinf(got[-1])
    want = jph.pairhmm_log10_batch(reads, quals, haps, mesh=mesh8)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=F32_TOL)


# ----------------------------------------------------------------------
# long-pair row bands (tests/test_sw_long.py's sharded cases)
# ----------------------------------------------------------------------


def _band_pair(rng, affine: bool):
    """A 3000 x 2200 pair whose best path crosses the 2- and 4-band
    boundaries and a strip edge; affine: with a 30-base insertion."""
    a = np.frombuffer(random_dna(rng, 3000), np.uint8).copy()
    b = np.frombuffer(random_dna(rng, 2200), np.uint8).copy()
    seg = np.frombuffer(random_dna(rng, 600), np.uint8)
    a[1300:1900] = seg
    if affine:
        ins = np.frombuffer(random_dna(rng, 30), np.uint8)
        seg = np.concatenate([seg[:230], ins, seg[230:]])
    b[800:800 + seg.size] = seg
    return a, b


@pytest.mark.parametrize("affine", [False, True])
def test_long_pair_bands_match_jax_and_golden(rng, affine):
    """2 and 4 bands (the JAX package's TestSharded/TestAffineSharded
    shapes) == the one-device sweep == the golden; 2 bands also == the JAX
    package's sharded function in interpret mode."""
    a, b = _band_pair(rng, affine)
    golden = (sw_long.sw_affine_numpy_blocked if affine
              else sw_long.sw_score_numpy_blocked)(a, b)
    fn = (sw_long.sw_affine_score_long_sharded if affine
          else sw_long.sw_score_long_sharded)
    for C in (2, 4):
        mesh = make_mesh((1, C), devices=[CPU] * C)
        assert fn(a, b, mesh, strip_width=512, strips_per_group=2) == golden
    single = (sw_long.sw_affine_score_long if affine
              else sw_long.sw_score_long)(a, b, CPU)
    jfn = (jsw_long.sw_affine_score_long_sharded if affine
           else jsw_long.sw_score_long_sharded)
    jmesh2 = JaxMesh(np.array(jax.devices()[:2]), ("seq",))
    want = jfn(bytes(a), bytes(b), jmesh2, sb=8, blk=512, interpret=True)
    assert single == want == golden


@pytest.mark.parametrize("M,N,C,width", [(97, 150, 3, 16), (64, 40, 4, 32),
                                         (5, 100, 5, 16), (300, 200, 7, 48)])
def test_long_pair_band_geometry_jax_refuses(M, N, C, width):
    """Bands far narrower than a strip (JAX: band < W, a ValueError of the
    TPU layout) give the exact score, ragged bands and strips included;
    a band of no rows is the one refusal."""
    rng = np.random.default_rng(M * N)
    a = np.frombuffer(random_dna(rng, M), np.uint8).copy()
    b = np.frombuffer(random_dna(rng, N), np.uint8).copy()
    n = min(M, N) // 2
    b[N // 5:N // 5 + n] = a[M // 4:M // 4 + n]
    mesh = make_mesh((C,), ("seq",), devices=[CPU] * C)
    for affine in (False, True):
        golden = (sw_long.sw_affine_numpy_blocked(a, b, -3, -1) if affine
                  else sw_long.sw_score_numpy_blocked(a, b))
        got = (sw_long.sw_affine_score_long_sharded(
            a, b, mesh, gap_open=-3, gap_extend=-1, strip_width=width,
            strips_per_group=2) if affine else sw_long.sw_score_long_sharded(
                a, b, mesh, strip_width=width, strips_per_group=2))
        assert got == golden, (affine, got, golden)
    jmesh4 = JaxMesh(np.array(jax.devices()[:4]), ("seq",))
    with pytest.raises(ValueError, match="band"):  # 512-row bands < 1024
        jsw_long.sw_score_long_sharded(bytes(a), bytes(b), jmesh4, sb=8,
                                       blk=512, interpret=True)
    with pytest.raises(ValueError, match="empty"):
        sw_long.sw_score_long_sharded(a[:C - 1], b, mesh)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("C", [1, 3])
def test_long_pair_top_rows_only_between_bands(rng, monkeypatch, affine, C):
    """One host loop serves one band and many: one band passes no top row
    (the unbanded kernel, no bottom rows written); with C bands every
    group of band 0 takes the true top edge and every other band the
    bottom row of the band above."""
    a, b = _band_pair(rng, affine)
    real = sw_long.strip_best(affine, CPU)
    tops = []

    def spy(*args, **kw):
        tops.append(kw.get("top_h"))
        return real(*args, **kw)

    monkeypatch.setattr(sw_long, "strip_best", lambda *_: spy)
    fn = (sw_long.sw_affine_score_long_sharded if affine
          else sw_long.sw_score_long_sharded)
    got = fn(a, b, make_mesh((1, C), devices=[CPU] * C), strip_width=512,
             strips_per_group=2)
    assert got == (sw_long.sw_affine_numpy_blocked if affine
                   else sw_long.sw_score_numpy_blocked)(a, b)
    wm = sw_long.WIDTH_MULTIPLE
    n_strips = -(-(-(-b.size // wm) * wm) // 512)
    groups = -(-n_strips // 2)
    assert len(tops) == C * groups
    if C == 1:
        assert tops == [None] * groups
    else:
        edges = [t for t in tops if t is not None and not t.any()]
        assert None not in tops and len(edges) >= groups


def test_plain_band_rows_chain_like_one_block(rng):
    """The band contract in plain PyTorch: rows [0, 45) and then [45, 90),
    the first half's bottom row(s) as the second's top row(s), give the
    whole block's best, last column(s) and bottom row(s)."""
    a = _t(np.frombuffer(random_dna(rng, 90), np.uint8).copy())
    b = _t(np.frombuffer(random_dna(rng, 64), np.uint8).copy())
    b[10:40] = a[30:60]
    for affine in (False, True):
        fn = (sw_long.sw_affine_strip_group if affine
              else sw_long.sw_strip_group)
        gaps = (-3, -1) if affine else ()
        n = 2 if affine else 1

        def run(rows, width, top):
            cols = [torch.zeros(rows.shape[0], dtype=torch.int32)]
            if affine:
                cols.append(torch.full((rows.shape[0],), sw_long.NEG,
                                       dtype=torch.int32))
            return fn(rows, b, *cols, *gaps, strip_width=width,
                      **dict(zip(("top_h", "top_e"), top)))

        edge = sw_long.default_top(64, affine, CPU)
        whole = run(a, 16, edge)
        first = run(a[:45], 32, edge)
        second = run(a[45:], 16, first[1 + n:])
        assert int(torch.maximum(first[0], second[0])) == int(whole[0])
        for k in range(1, 1 + n):
            assert torch.equal(torch.cat([first[k], second[k]]), whole[k])
        for k in range(1 + n, 1 + 2 * n):
            assert torch.equal(second[k], whole[k])


# ----------------------------------------------------------------------
# the CLI under MPT_MESH_SHAPE (--allow-cpu: that many CPU shards)
# ----------------------------------------------------------------------

# the banner, the monitors, rates and the long-pair engines' progress
_VARIABLE = ("Device:", "Monitor summary", "Throughput:", "Host blocked",
             "  sw-")
# the result lines both packages print (their banners and progress differ)
_RESULT = re.compile(r"Score=|score|Pairs|omplementary|-mers|Loaded|"
                     r"Processed \d+ files|^  [ACGT]+  \d+$")


def _cli_lines(main, argv, monkeypatch, d, shape):
    """The run's lines with the device banner, the monitors and the rates
    left out and every time masked."""
    d.mkdir()
    monkeypatch.chdir(d)
    monkeypatch.setenv("MPT_MESH_SHAPE", shape)
    monkeypatch.setenv("MPT_RESULTS_DIR", str(d / "results"))
    out = []
    assert main(argv + ["--allow-cpu"], echo=out.append) == 0
    return [re.sub(r"\d+\.\d+ (s|ms|GCUPS)", r"# \1", ln) for ln in out
            if not ln.startswith(_VARIABLE)]


@pytest.fixture
def cli_inputs(tmp_path, rng, monkeypatch):
    r1 = [random_dna(rng, int(rng.integers(80, 150)), b"ACGTN")
          for _ in range(23)]
    r2 = [r.translate(_COMP)[::-1] for r in r1[:15]] + \
        [random_dna(rng, 120) for _ in range(8)]
    wgs = tmp_path / "wgs"
    wgs.mkdir()
    paths = [str(wgs / f"S_L00{k}_R1_001.fastq.gz") for k in (1, 2)]
    fastq.write_fastq(paths[0], r1)
    fastq.write_fastq(paths[1], r2)
    # in the environment too: a .env never overrides what an earlier
    # test's CLI run left there
    values = {"WGS_DATA_DIR": str(wgs), "WGS_SAMPLE_ID": "S",
              "WGS_LANES": "2", "WGS_READS_PER_LANE": "1",
              "GPU_CHUNK_SIZE_READS": "6"}
    for k, v in values.items():
        monkeypatch.setenv(k, v)
    env = tmp_path / "my.env"
    env.write_text("".join(f"{k}={v}\n" for k, v in values.items()))
    fa = [str(tmp_path / n) for n in ("a.fa", "b.fa")]
    a = random_dna(rng, 700)
    fasta.write_fasta(fa[0], {"a": a})
    fasta.write_fasta(fa[1], {"b": random_dna(rng, 200) + a[100:400]})
    return paths, str(env), fa


@pytest.mark.parametrize("case", ["full-wgs", "files", "complementarity",
                                  "kmer", "long-align"])
def test_cli_under_a_mesh_prints_the_single_device_lines(
        cli_inputs, monkeypatch, tmp_path, case):
    """The port under MPT_MESH_SHAPE=8 (1x8 for --long-align, a seq axis)
    prints what it prints without a mesh (timings and the device banner
    aside), and the result lines the JAX CLI prints on its 8-device
    mesh."""
    paths, env, fa = cli_inputs
    argv = {"full-wgs": ["--full-wgs", "--mode", "sw"],
            "files": ["--files", "-1", paths[0], "-2", paths[1], "--mode",
                      "sw"],
            "complementarity": ["--complementarity", "-1", paths[0], "-2",
                                paths[1]],
            "kmer": ["--kmer", ",".join(paths), "-k", "15", "--canonical"],
            "long-align": ["--long-align", "-1", fa[0], "-2", fa[1],
                           "--mode", "sw-affine"]}[case] + ["--env", env]
    shape = "1x8" if case == "long-align" else "8"
    plain = _cli_lines(cli.main, argv, monkeypatch, tmp_path / "one", "")
    mesh = _cli_lines(cli.main, argv, monkeypatch, tmp_path / "mesh", shape)
    assert mesh == plain
    if case != "long-align":  # JAX's bands refuse 700 rows on 8 devices
        jout = _cli_lines(jcli.main, argv, monkeypatch, tmp_path / "jax",
                          shape)
        results = [[ln for ln in lines if _RESULT.search(ln)]
                   for lines in (mesh, jout)]
        assert results[0] == results[1] and results[0]
    assert not any("not yet ported" in ln for ln in mesh)


def test_cli_mesh_errors(cli_inputs, monkeypatch, tmp_path):
    """A mesh shape the devices cannot fill, and a seq axis with more bands
    than rows, print ERROR: and exit 1."""
    paths, env, fa = cli_inputs
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MPT_MESH_SHAPE", "1x800")
    out = []
    assert cli.main(["--long-align", "-1", fa[0], "-2", fa[1], "--env", env,
                     "--allow-cpu"], echo=out.append) == 1
    assert out[-1].startswith("ERROR:") and "empty" in out[-1]
    if not torch.cuda.is_available():
        monkeypatch.setenv("MPT_MESH_SHAPE", "8")
        out = []
        assert cli.main(["--full-wgs", "--env", env], echo=out.append) == 1
        assert out[-1].startswith("ERROR:")
