"""k-mer counting in the port (ops/kmer.py, models/kmer_model.py, --kmer)
against the JAX package on the same seeded inputs, exactly: window keys,
batch counts, the device accumulator (folds, spills, summaries), the host
merge, the engine in both result modes and on both aggregation paths,
``write_counts`` bytes, checkpoints in both directions, and the CLI; the
drain codec as functions of its own (the planes == the JAX package's
``_plane_pack`` bytes at k <= 30, the native decoder == the NumPy decoder,
drained stores round-trip through it).

Keys: the port's int64 key is the JAX (hi, lo) pair joined
(``kmer.join_keys``); at k <= 30 both orders agree. At k = 31 the JAX
package compares its hi word signed and departs from its own golden,
``count_kmers_python``; the port follows the golden (the last tests).
"""

import dataclasses
import gzip
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu import cli as jcli
from mini_parallel_tpu.io import fastq as jfastq
from mini_parallel_tpu.models import kmer_model as jkm
from mini_parallel_tpu.ops import encode as jencode
from mini_parallel_tpu.ops import kmer as jkmer
from mini_parallel_tpu.utils.config import Config as JConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.models import kmer_model as km
from mini_parallel_tpu_torch.native import kmer_store as kstore
from mini_parallel_tpu_torch.ops import encode, kmer
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")


def _reads(rng, n, lo=10, hi=80, n_rate=0.02):
    """Seeded reads with N bases, lowercase and a repeated tail."""
    reads = []
    for _ in range(n):
        r = bytearray(random_dna(rng, int(rng.integers(lo, hi))))
        for j in np.flatnonzero(rng.random(len(r)) < n_rate):
            r[j] = ord("N")
        reads.append(bytes(r))
    reads[-1] = reads[0].lower()
    return reads + reads[: n // 8]


def _codes(reads, pad):
    arr, lens = encode.pad_batch(reads, pad_to=pad,
                                 pad_value=int(encode.PAD_A))
    return arr, lens


def _jax_counts(reads, k, canonical, pad) -> dict:
    """The JAX package's unique_counts_batch as {int64 key: count}."""
    arr, lens = _codes(reads, pad)
    hi, lo, ct, nu = jkmer.unique_counts_batch(
        jencode.ascii_to_code(jnp.asarray(arr)), jnp.asarray(lens), k=k,
        canonical=canonical)
    nu = int(nu)
    keys = kmer.join_keys(np.asarray(hi)[:nu], np.asarray(lo)[:nu], k)
    assert kmer.sorted_unique(keys)  # k <= 30: JAX order == int64 order
    return dict(zip(keys.tolist(), np.asarray(ct)[:nu].tolist()))


def _golden(reads, k, canonical) -> dict:
    return {_key(s): c for s, c in
            kmer.count_kmers_python(reads, k, canonical).items()}


def _key(s: str) -> int:
    v = 0
    for ch in s:
        v = v * 4 + "ACGT".index(ch)
    return v


KS = [8, 13, 21]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_pack_kmers_matches_jax(rng, k, canonical):
    reads = _reads(rng, 24)
    arr, lens = _codes(reads, 96)
    keys, ok = kmer.pack_kmers(encode.ascii_to_code(torch.from_numpy(arr)),
                               torch.from_numpy(lens), k, canonical)
    hi, lo, jok = jkmer.pack_kmers(jencode.ascii_to_code(jnp.asarray(arr)),
                                   jnp.asarray(lens), k, canonical)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    want = kmer.join_keys(np.asarray(hi), np.asarray(lo), k)
    assert np.array_equal(keys.numpy()[ok.numpy()], want[np.asarray(jok)])


@pytest.mark.parametrize("k", [0, 32, 97])
def test_pack_kmers_refuses_what_jax_refuses(k):
    codes = torch.zeros((1, 96), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kmer.pack_kmers(codes, torch.tensor([96]), k)
    with pytest.raises(ValueError):
        jkmer.pack_kmers(jnp.zeros((1, 96), jnp.uint8), jnp.asarray([96]), k)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_unique_counts_match_jax_and_golden(rng, k, canonical):
    reads = _reads(rng, 40)
    arr, lens = _codes(reads, 96)
    keys, counts, n = kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=k, canonical=canonical)
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert n == len(got) == keys.numel()
    assert kmer.sorted_unique(keys.numpy())
    assert got == _jax_counts(reads, k, canonical, 96)
    assert got == _golden(reads, k, canonical)
    from mini_parallel_tpu_torch.ops import packed

    pb = packed.pack_batch(arr, lens)
    pk, pc, pn = kmer.unique_counts_packed(*packed.device_args(pb, CPU), k=k,
                                           canonical=canonical)
    assert pn == n and torch.equal(pk, keys) and torch.equal(pc, counts)


def test_short_and_all_n_reads_have_no_windows():
    arr, lens = _codes([b"ACG", b"A", b"NNNNNNNNNNN", b""], 16)
    keys, counts, n = kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=5)
    assert n == 0 and keys.numel() == 0 and counts.numel() == 0


def _batches(rng, k=9):
    """(port keys/counts, JAX hi/lo/ct) of batches with shared reads."""
    out = []
    shared = random_dna(rng, 20)
    for B, pad in [(6, 32), (6, 32), (6, 32), (4, 40), (8, 24)]:
        reads = [random_dna(rng, int(rng.integers(9, pad - 2)))
                 for _ in range(B)]
        reads[0] = shared  # the same keys in every batch
        arr, lens = _codes(reads, pad)
        pk = kmer.unique_counts_batch(
            encode.ascii_to_code(torch.from_numpy(arr)),
            torch.from_numpy(lens), k=k)
        jk = jkmer.unique_counts_batch(
            jencode.ascii_to_code(jnp.asarray(arr)), jnp.asarray(lens), k=k)
        out.append((pk, jk))
    return out


def _jax_triple(hi, lo, ct, k):
    return kmer.join_keys(np.asarray(hi), np.asarray(lo), k), np.asarray(ct)


@pytest.mark.parametrize("capacity,staging", [(1 << 12, 2), (1 << 12, 40),
                                              (64, 1), (40, 2)])
def test_accumulator_matches_jax(rng, capacity, staging):
    """Folds across a staging flush and duplicate keys, and spills when
    the distinct count passes the capacity: the drain equals the JAX
    accumulator's, and a spill says so."""
    acc = kmer.DeviceKmerAccumulator(capacity=capacity,
                                     staging_batches=staging)
    jacc = jkmer.DeviceKmerAccumulator(capacity=capacity,
                                       staging_batches=staging)
    want = Counter()
    for (keys, counts, _), (hi, lo, ct, _) in _batches(rng):
        acc.add(keys, counts)
        jacc.add(hi, lo, ct)
        for key, c in zip(keys.tolist(), counts.tolist()):
            want[key] += c
    got = acc.drain()
    ref = _jax_triple(*jacc.drain(), 9)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert dict(zip(got[0].tolist(), got[1].tolist())) == dict(want)
    assert acc.spilled == (len(want) > capacity)


def test_spill_failure_poisons_the_accumulator(rng, monkeypatch):
    """A failed background spill makes every later drain raise: a retry
    returning partial counts would be a silent undercount."""
    def broken(self, *a):
        raise RuntimeError("fetch died")

    monkeypatch.setattr(kmer.DeviceKmerAccumulator, "_fetch", broken)
    acc = kmer.DeviceKmerAccumulator(capacity=64, staging_batches=2)
    reads = [random_dna(rng, 40) for _ in range(50)]
    arr, lens = _codes(reads, 48)
    keys, counts, _ = kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=9)
    acc.add(keys, counts)
    acc.flush()  # past capacity 64: a spill on the worker thread
    assert acc.spilled and acc.summary() is None
    for _ in range(2):
        with pytest.raises(RuntimeError, match="incomplete"):
            acc.drain()


@pytest.mark.parametrize("top_n", [1, 5, 10, 50])
def test_summary_matches_jax_with_ties(top_n):
    """Counts with many ties: the top-N comes by count descending, ties by
    ascending key, as the JAX summary and KmerResult.top() order them."""
    reads = [b"ACGTACGTAC" * 3, b"TTTTTTTTTTTT", b"GATTACAGATTACA",
             b"CCCCGGGGAAAATTTT", b"ACGTACGTAC" * 3, b"GGGGGGGG"]
    arr, lens = _codes(reads, 32)
    acc = kmer.DeviceKmerAccumulator()
    acc.add(*kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=4)[:2])
    jacc = jkmer.DeviceKmerAccumulator()
    jacc.add(*jkmer.unique_counts_batch(
        jencode.ascii_to_code(jnp.asarray(arr)), jnp.asarray(lens), k=4)[:3])
    s, js = acc.summary(top_n=top_n, hist_bins=8), jacc.summary(
        top_n=top_n, hist_bins=8)
    assert s["n_unique"] == js["n_unique"]
    assert np.array_equal(s["hist"], js["hist"]) and s["hist"].dtype == np.int64
    assert s["top"] == [(int(kmer.join_keys(h, lo, 4)), c)
                        for h, lo, c in js["top"]]
    if top_n == 50:  # the whole table: ties are present
        counts = [c for _, c in s["top"]]
        assert len(set(counts)) < len(counts)
    empty = kmer.DeviceKmerAccumulator().summary(hist_bins=8)
    assert empty["n_unique"] == 0 and empty["top"] == []


def _sorted_pair(rng, n, k):
    keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.int64))
    return keys, rng.integers(1, 9, keys.size).astype(np.int64)


@pytest.mark.parametrize("k", KS)
def test_merge_sorted_arrays_matches_jax(rng, k):
    a, b = _sorted_pair(rng, 300, k), _sorted_pair(rng, 200, k)
    o = np.arange(0, a[0].size, 2)  # half of b's keys are a's
    kb = np.concatenate([a[0][o], b[0]])
    cb = np.concatenate([a[1][o] * 10, b[1]])
    srt = np.argsort(kb)
    b = (kb[srt], cb[srt])
    empty = kmer.EMPTY_ARRAYS
    unsorted = (a[0][::-1].copy(), a[1][::-1].copy())
    for x, y in ((a, b), (b, a), (a, empty), (empty, b), (unsorted, b),
                 (b, unsorted), (empty, empty)):
        got = kmer.merge_sorted_arrays(x, y)
        jx, jy = ((*kmer.split_keys(t[0], k), t[1]) for t in (x, y))
        ref = _jax_triple(*jkm.merge_sorted_arrays(jx, jy), k)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
        assert got[0].dtype == got[1].dtype == np.int64


def test_keys_and_strings_round_trip(rng):
    for k in (1, 8, 21, 31):
        keys = rng.integers(0, 1 << (2 * k), 50, dtype=np.int64)
        hi, lo = kmer.split_keys(keys, k)
        assert np.array_equal(kmer.join_keys(hi, lo, k), keys)
        for key, h, lo_ in zip(keys[:10].tolist(), hi, lo):
            s = kmer.key_to_string(key, k)
            assert s == jkmer.key_to_string(int(h), int(lo_), k)
            assert _key(s) == key


def test_merge_device_counts_matches_jax():
    keys = np.array([5, 9, 5, 7], np.int64)
    counts = np.array([1, 2, 3, 0], np.int64)
    agg = kmer.merge_device_counts({}, keys, counts)
    hi, lo = kmer.split_keys(keys, 21)
    jagg = jkmer.merge_device_counts({}, hi, lo, counts)
    assert agg == {int(kmer.join_keys(h, lo_, 21)): c
                   for (h, lo_), c in jagg.items()} == {5: 4, 9: 2}


@pytest.mark.parametrize("counts", [[1], [9, 10, 11], [99, 100, 12345678901],
                                    list(range(1, 300))])
def test_count_lines_are_the_jax_bytes(rng, counts):
    counts = np.array(counts, np.int64)
    keys = np.sort(rng.choice(1 << 20, counts.size, replace=False)).astype(
        np.int64)
    hi, lo = kmer.split_keys(keys, 10)
    want = "".join(f"{jkmer.key_to_string(int(h), int(lo_), 10)}\t{c}\n"
                   for h, lo_, c in zip(hi, lo, counts.tolist()))
    assert km.count_lines(keys, counts, 10) == want.encode()


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------


def _jax_result_counts(res, k) -> dict:
    return {int(kmer.join_keys(h, lo, k)): c for (h, lo), c in
            res.counts.items()}


@pytest.fixture
def lanes(tmp_path):
    rng = np.random.default_rng(11)
    reads = _reads(rng, 160, lo=15, hi=140)
    paths = [str(tmp_path / f"L{i}.fastq.gz") for i in (1, 2)]
    fastq.write_fastq(paths[0], reads[:100])
    fastq.write_fastq(paths[1], reads[100:])
    return paths, reads


CASES = [dict(k=21), dict(k=13, canonical=True), dict(k=8),
         dict(k=21, device_accumulate=False),
         dict(k=13, canonical=True, device_accumulate=False),
         dict(k=21, device_capacity=256)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
@pytest.mark.parametrize("multi", [False, True], ids=["one lane", "two lanes"])
def test_engine_matches_jax(lanes, case, multi):
    paths, reads = lanes
    path = paths if multi else paths[0]
    cfg = Config(chunk_size_reads=32)
    res = km.KmerEngine(cfg, device=CPU, **case).count_file(path)
    jres = jkm.KmerEngine(JConfig(chunk_size_reads=32), **case).count_file(
        path)
    assert (res.total_kmers, res.distinct_kmers, res.total_reads) == (
        jres.total_kmers, jres.distinct_kmers, jres.total_reads)
    assert res.counts == _jax_result_counts(jres, case["k"])
    assert res.top(10) == jres.top(10)
    assert np.array_equal(res.histogram(16), jres.histogram(16))
    assert res.file_path == jres.file_path
    golden = _golden(reads if multi else reads[:100], case["k"],
                     case.get("canonical", False))
    assert res.counts == golden
    if "device_capacity" in case:
        assert res.distinct_kmers > 256  # the run spilled


@pytest.mark.parametrize("case", CASES[:3] + CASES[-1:], ids=str)
def test_summary_equals_full(lanes, case):
    paths, _ = lanes
    eng = km.KmerEngine(Config(chunk_size_reads=32), device=CPU, **case)
    full = eng.count_file(paths)
    summ = eng.count_file(paths, result_mode="summary", summary_top_n=10)
    assert summ.distinct_kmers == full.distinct_kmers
    assert summ.total_kmers == full.total_kmers
    assert np.array_equal(summ.histogram(64), full.histogram(64))
    assert np.array_equal(summ.histogram(8), full.histogram(8))
    assert summ.top(10) == full.top(10)
    spilled = "device_capacity" in case
    assert (summ.arrays == ()) != spilled  # a spill takes the full drain
    jsumm = jkm.KmerEngine(JConfig(chunk_size_reads=32), **case).count_file(
        paths, result_mode="summary")
    assert summ.top(10) == jsumm.top(10)
    assert summ.distinct_kmers == jsumm.distinct_kmers
    if not spilled:
        with pytest.raises(ValueError, match="summary-mode"):
            summ.counts
        with pytest.raises(ValueError, match="summary-mode"):
            summ.write_counts("never.tsv")
        with pytest.raises(ValueError, match="summary mode kept only"):
            summ.top(11)
        with pytest.raises(ValueError, match="cannot expand"):
            summ.histogram(65)


def test_host_path_dict_equals_store(lanes, monkeypatch):
    paths, _ = lanes
    eng = km.KmerEngine(Config(chunk_size_reads=32), k=13,
                        device_accumulate=False, device=CPU)
    store = eng.count_file(paths)
    monkeypatch.setattr(eng, "make_store", dict)
    assert eng.count_file(paths).counts == store.counts
    agg: dict = {}
    assert eng.count_reads_batch([b"ACGTACGTACGTACG", b"NNACGTACGTACGTA"],
                                 agg) == (4, 2)
    jagg: dict = {}
    jkm.KmerEngine(JConfig(chunk_size_reads=32), k=13).count_reads_batch(
        [b"ACGTACGTACGTACG", b"NNACGTACGTACGTA"], jagg)
    assert agg == {int(kmer.join_keys(h, lo, 13)): c
                   for (h, lo), c in jagg.items()}


@pytest.mark.parametrize("name", ["c.tsv", "c.tsv.gz"])
@pytest.mark.parametrize("empty", [False, True], ids=["lines", "empty"])
def test_write_counts_bytes_match_jax(lanes, tmp_path, name, empty):
    paths, _ = lanes
    res = km.KmerEngine(Config(chunk_size_reads=32), device=CPU).count_file(
        paths)
    jres = jkm.KmerEngine(JConfig(chunk_size_reads=32)).count_file(paths)
    if empty:
        res = dataclasses.replace(res, arrays=(), distinct_kmers=0)
        jres = dataclasses.replace(jres, arrays=(), distinct_kmers=0)
    out, jout = tmp_path / ("port" + name), tmp_path / ("jax" + name)
    assert res.write_counts(str(out)) == jres.write_counts(str(jout))
    read = gzip.open if name.endswith(".gz") else open
    with read(out, "rb") as f, read(jout, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and (got == b"") == empty
    if not empty:
        assert len(got.splitlines()) == res.distinct_kmers
    assert not (tmp_path / ("port" + name + ".tmp")).exists()


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------


def _crash_at(module, monkeypatch, chunk: int):
    real = module.iter_flat_chunks

    def dying(*a, **kw):
        for i, c in enumerate(real(*a, **kw)):
            if i == chunk:
                raise RuntimeError("injected crash")
            yield c

    monkeypatch.setattr(module, "iter_flat_chunks", dying)


@pytest.fixture
def lane(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "lane.fastq.gz")
    reads = [random_dna(rng, 50) for _ in range(40)]  # 8 chunks of 5
    fastq.write_fastq(path, reads)
    return path


@pytest.mark.parametrize("device_acc", [True, False])
@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_resume_exact_across_packages(lane, tmp_path, monkeypatch,
                                                 device_acc, writer, reader):
    """A run that dies after 5 chunks leaves the snapshot of chunk 4;
    resuming it (in either package) gives the clean run's counts."""
    eng = {"port": lambda: km.KmerEngine(Config(chunk_size_reads=5,
                                                read_pad=64), k=21,
                                         device_accumulate=device_acc,
                                         device=CPU),
           "jax": lambda: jkm.KmerEngine(JConfig(chunk_size_reads=5,
                                                 read_pad=64), k=21,
                                         device_accumulate=device_acc)}
    clean = eng["port"]().count_file(lane)
    ckpt = str(tmp_path / "c.npz")
    with monkeypatch.context() as m:
        _crash_at(fastq if writer == "port" else jfastq, m, 5)
        with pytest.raises(RuntimeError, match="injected crash"):
            eng[writer]().count_file(lane, checkpoint_path=ckpt,
                                     checkpoint_every=2)
    (keys, counts), meta = km.load_kmer_checkpoint(ckpt)
    assert meta["chunks_done"] == 4 and meta["total_reads"] == 20
    assert kmer.sorted_unique(keys) and counts.dtype == np.int64
    res = eng[reader]().count_file(lane, checkpoint_path=ckpt,
                                   checkpoint_every=2)
    counts = (res.counts if reader == "port"
              else _jax_result_counts(res, 21))
    assert counts == clean.counts
    assert (res.total_kmers, res.total_reads) == (clean.total_kmers,
                                                  clean.total_reads)


def test_checkpoint_file_is_the_jax_layout(lane, tmp_path):
    cfg = Config(chunk_size_reads=5, read_pad=64)
    for side, eng in (("port", km.KmerEngine(cfg, k=13, canonical=True,
                                             device=CPU)),
                      ("jax", jkm.KmerEngine(JConfig(chunk_size_reads=5,
                                                     read_pad=64), k=13,
                                             canonical=True))):
        eng.count_file(lane, checkpoint_path=str(tmp_path / f"{side}.npz"),
                       checkpoint_every=3)
    with np.load(tmp_path / "port.npz") as z, np.load(tmp_path / "jax.npz") as j:
        assert sorted(z.files) == sorted(j.files) == ["ct", "hi", "lo", "meta"]
        for f in z.files:
            assert z[f].dtype == j[f].dtype, f
            assert np.array_equal(z[f], j[f]), f


def test_checkpoint_refusals_match_jax(lane, tmp_path, rng):
    other = str(tmp_path / "other.fastq.gz")
    fastq.write_fastq(other, [random_dna(rng, 40) for _ in range(10)])
    cfg = Config(chunk_size_reads=5, read_pad=64)
    ckpt = str(tmp_path / "c.npz")
    km.KmerEngine(cfg, k=21, device=CPU).count_file(
        lane, checkpoint_path=ckpt, checkpoint_every=1)
    for kw, path, what in ((dict(k=15), lane, "k=21"),
                           (dict(k=21, canonical=True), lane, "canonical"),
                           (dict(k=21), other, "file_path")):
        with pytest.raises(ValueError, match=what) as e:
            km.KmerEngine(cfg, device=CPU, **kw).count_file(
                path, checkpoint_path=ckpt, checkpoint_every=1)
        with pytest.raises(ValueError) as je:
            jkm.KmerEngine(JConfig(chunk_size_reads=5, read_pad=64),
                           **kw).count_file(path, checkpoint_path=ckpt,
                                            checkpoint_every=1)
        assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="chunk_size_reads"):
        km.KmerEngine(dataclasses.replace(cfg, chunk_size_reads=7), k=21,
                      device=CPU).count_file(lane, checkpoint_path=ckpt,
                                             checkpoint_every=1)


def test_engine_refuses_meshes_and_needs_a_device():
    """Meshes are ported: the engine takes MPT_MESH_SHAPE's config (the
    CLI builds the mesh, as the JAX CLI does) and a mesh, whose first
    device it runs on; it refuses a device that is not that one."""
    from mini_parallel_tpu_torch.parallel.mesh import make_mesh

    assert km.KmerEngine(Config(chunk_size_reads=5, mesh_shape=(2,)),
                         device=CPU).mesh is None
    mesh = make_mesh((2,), devices=[CPU] * 2)
    assert km.KmerEngine(mesh=mesh).device == CPU
    assert km.KmerEngine(mesh=mesh, device=CPU).mesh is mesh
    with pytest.raises(ValueError, match="first device"):
        km.KmerEngine(mesh=mesh, device="meta")
    if not torch.cuda.is_available():
        from mini_parallel_tpu_torch.device import NoAcceleratorError

        with pytest.raises(NoAcceleratorError):
            km.KmerEngine()


# ----------------------------------------------------------------------
# the CLI against the JAX package's CLI
# ----------------------------------------------------------------------


def _normalise(lines, d):
    return [re.sub(r"time: [0-9.]+ s", "time: T s", ln.replace(str(d), "D"))
            for ln in lines if not ln.startswith("Device:")]


@pytest.mark.parametrize("extra", [
    [], ["-k", "13", "--canonical"], ["--kmer-out", "{d}/counts.tsv"],
    ["-k", "8", "--kmer-out", "{d}/counts.tsv.gz", "--kmer-checkpoint",
     "{d}/c.npz", "--kmer-checkpoint-every", "2"],
    ["-k", "32"], ["--chunk-size", "7", "-k", "17"],
])
@pytest.mark.parametrize("multi", [False, True], ids=["one lane", "two lanes"])
def test_cli_matches_jax(lanes, tmp_path, monkeypatch, extra, multi):
    paths, _ = lanes
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "32")
    outs = []
    for side, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        argv = ["--kmer", ",".join(paths) if multi else paths[0],
                *(a.format(d=d) for a in extra), "--allow-cpu"]
        lines: list[str] = []
        rc = main(argv, echo=lines.append)
        files = {}
        for p in sorted(d.iterdir()):
            if p.suffix == ".npz":
                with np.load(p) as z:
                    files[p.name] = {f: z[f].tolist() for f in z.files}
            else:
                files[p.name] = (gzip.open(p).read() if p.suffix == ".gz"
                                 else p.read_bytes())
        outs.append((rc, _normalise(lines, d), files))
    assert outs[0] == outs[1]
    rc, lines, _ = outs[0]
    if "32" in extra:
        assert rc == 1 and lines[-1].startswith("ERROR: k=32 out of range")
    else:
        assert rc == 0 and lines[0].startswith("Total ")


def test_cli_errors_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bad = tmp_path / "bad.fastq"
    bad.write_bytes(b"@r0\nACGT\n+\nIIII\n" + b"\xffjunk\n" * 11)
    for argv in (["--kmer", str(bad)], ["--kmer", str(bad), "--kmer-out",
                                         "x.tsv"]):
        out, jout = [], []
        rc = cli.main(argv + ["--allow-cpu"], echo=out.append)
        jrc = jcli.main(argv + ["--allow-cpu"], echo=jout.append)
        assert rc == jrc == 1
        assert _normalise(out, tmp_path) == _normalise(jout, tmp_path)
        assert out[-1].startswith("ERROR: Error reading")


def test_cli_variant_prep_wins_over_kmer(lanes, tmp_path, monkeypatch):
    """With both flags, --variant-prep runs, as in the JAX CLI."""
    paths, reads = lanes
    ref = tmp_path / "ref.fa"
    ref.write_bytes(b">chr\n" + reads[0].upper().replace(b"N", b"A") * 4
                    + b"\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "32")
    out: list[str] = []
    assert cli.main(["--variant-prep", paths[0], "--reference", str(ref),
                     "--kmer", paths[1], "--allow-cpu"],
                    echo=out.append) == 0
    assert any(ln.startswith("Candidate variant sites:") for ln in out)
    assert not any(ln.startswith("Total ") for ln in out)


# ----------------------------------------------------------------------
# k = 31: the port follows count_kmers_python; the JAX device path does not
# ----------------------------------------------------------------------

K31_READS = [b"T" * 31, b"GATTACA" * 5, b"G" * 40, b"ACGT" * 10]


@pytest.mark.parametrize("canonical", [False, True])
def test_k31_port_equals_the_golden(rng, canonical):
    reads = K31_READS + [random_dna(rng, int(rng.integers(31, 90)))
                         for _ in range(30)]
    arr, lens = _codes(reads, 96)
    keys, counts, _ = kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=31, canonical=canonical)
    assert dict(zip(keys.tolist(), counts.tolist())) == _golden(
        reads, 31, canonical)


def test_k31_engine_dump_is_in_kmer_order(tmp_path):
    path = str(tmp_path / "k31.fastq.gz")
    fastq.write_fastq(path, K31_READS)
    res = km.KmerEngine(Config(chunk_size_reads=3), k=31, canonical=True,
                        device=CPU).count_file(path)
    out = tmp_path / "c.tsv"
    res.write_counts(str(out))
    lines = out.read_text().splitlines()
    golden = kmer.count_kmers_python(K31_READS, 31, canonical=True)
    assert lines == [f"{s}\t{c}" for s, c in sorted(golden.items())]


def test_k31_jax_device_path_departs_from_its_golden():
    """The fault of the reference the port does not carry over: at k = 31
    the JAX hi word of a k-mer starting with G or T is a negative int32,
    so its canonical fold keeps the wrong strand and its dump is out of
    key order."""
    reads = [b"T" * 31, b"GATTACA" * 5]
    arr, lens = _codes(reads, 64)
    hi, lo, ct, nu = jkmer.unique_counts_batch(
        jencode.ascii_to_code(jnp.asarray(arr)), jnp.asarray(lens), k=31,
        canonical=True)
    nu = int(nu)
    jax_strings = {jkmer.key_to_string(int(h), int(lo_), 31)
                   for h, lo_ in zip(np.asarray(hi)[:nu], np.asarray(lo)[:nu])}
    golden = set(kmer.count_kmers_python(reads, 31, canonical=True))
    assert "T" * 31 in jax_strings and "A" * 31 in golden
    assert jax_strings != golden
    keys, _, _ = kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=31, canonical=True)
    assert {kmer.key_to_string(key, 31) for key in keys.tolist()} == golden
    assert jkmer.pack_kmers(jencode.ascii_to_code(jnp.asarray(arr[:1])),
                            jnp.asarray(lens[:1]), 31)[0][0, 0] < 0


# ---------------------------------------------------------------------------
# The drain codec (plane_pack, the native and NumPy decoders)
# ---------------------------------------------------------------------------


def _store(k, n_reads=400, canonical=False):
    """A folded store of seeded reads with repeats: ascending distinct
    keys and their counts."""
    rng = np.random.default_rng(k)
    reads = _reads(rng, n_reads, lo=k + 2, hi=120)
    arr, lens = _codes(reads, 128)
    keys, counts, _ = kmer.unique_counts_batch(
        encode.ascii_to_code(torch.from_numpy(arr)), torch.from_numpy(lens),
        k=k, canonical=canonical)
    return keys, counts


def _jax_planes(keys, counts, k, kp, cp):
    """The JAX package's maxima and _plane_pack on the same store."""
    hi, lo = kmer.split_keys(keys.numpy(), k)
    s = kmer.lo_bits(k)
    args = (jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(counts.numpy().astype(np.int32)))
    mx_lo, mx_hi, mx_ct = (int(x) for x in np.asarray(
        jkmer._plane_maxima(*args, s=s))[:3])
    jkp = (4 + jkmer._planes_needed(mx_hi)) if mx_hi \
        else jkmer._planes_needed(mx_lo)
    jcp = 0 if mx_ct == 1 else jkmer._planes_needed(mx_ct)
    return np.asarray(jkmer._plane_pack(*args, kp, cp, s=s)), jkp, jcp


@pytest.mark.parametrize("k", [11, 21, 30])
def test_planes_are_the_jax_plane_pack_bytes(k):
    """At k <= 30 the port's delta planes equal the JAX package's
    _plane_pack byte for byte, with the same kp and cp, and both decoders
    give the store back."""
    keys, counts = _store(k)
    planes, kp, cp, key0 = kmer.plane_pack(keys, counts)
    jplanes, jkp, jcp = _jax_planes(keys, counts, k, kp, cp)
    assert (kp, cp) == (jkp, jcp) and cp > 0
    assert planes.dtype == torch.uint8 and planes.shape == (kp + cp,
                                                            keys.numel())
    assert np.array_equal(planes.numpy().reshape(-1), jplanes)
    m = keys.numel()
    for dk, dc in (kmer.decode_planes_numpy(planes.numpy(), m, kp, cp, key0),
                   kstore.decode_planes_native(planes.numpy(), m, kp, cp,
                                               key0)):
        assert np.array_equal(dk, keys.numpy())
        assert np.array_equal(dc, counts.numpy())


@pytest.mark.parametrize("canonical", [False, True])
def test_k31_planes_decode_to_the_keys(canonical):
    """At k = 31 the JAX order is signed, so only the decoded keys can be
    held: they are the raw keys."""
    keys, counts = _store(31, canonical=canonical)
    planes, kp, cp, key0 = kmer.plane_pack(keys, counts)
    dk, dc = kstore.decode_planes_native(planes.numpy(), keys.numel(), kp,
                                         cp, key0)
    assert np.array_equal(dk, keys.numpy())
    assert np.array_equal(dc, counts.numpy())


def _codec_cases():
    rng = np.random.default_rng(17)
    ascending = np.unique(rng.integers(0, 1 << 42, 3000))
    return {
        "ascending, counts to 2^33": (
            ascending, rng.integers(1, 1 << 33, ascending.size)),
        "all-ones counts (cp = 0)": (ascending, np.ones(ascending.size,
                                                        np.int64)),
        "any order (deltas wrap)": (
            rng.integers(0, 1 << 62, 2000), rng.integers(1, 300, 2000)),
        "one key": (np.array([(1 << 61) + 5]), np.array([7])),
    }


@pytest.mark.parametrize("case", list(_codec_cases()))
def test_native_decoder_equals_numpy_decoder(case):
    keys, counts = _codec_cases()[case]
    planes, kp, cp, key0 = kmer.plane_pack(torch.from_numpy(keys),
                                           torch.from_numpy(counts))
    m = keys.size
    native = kstore.decode_planes_native(planes.numpy(), m, kp, cp, key0)
    numpy_ = kmer.decode_planes_numpy(planes.numpy(), m, kp, cp, key0)
    for got in (native, numpy_):
        assert got[0].dtype == got[1].dtype == np.int64
        assert np.array_equal(got[0], keys)
        assert np.array_equal(got[1], counts)
    assert (kp == 8) == (case == "any order (deltas wrap)")
    assert (cp == 0) == (case in ("all-ones counts (cp = 0)",))


def test_native_decoder_refuses_a_short_buffer():
    with pytest.raises(ValueError, match="plane bytes"):
        kstore.decode_planes_native(np.zeros(10, np.uint8), 4, 2, 1, 0)
    with pytest.raises(ValueError, match="plane bytes"):
        kstore.decode_planes_native(np.zeros(36, np.uint8), 4, 9, 0, 0)


def _accumulate(batches, capacity, staging):
    acc = kmer.DeviceKmerAccumulator(capacity=capacity,
                                     staging_batches=staging)
    for (keys, counts, _), _ in batches:
        acc.add(keys, counts)
    return acc, acc.drain()


def _round_trip(keys, counts):
    """plane_pack of host arrays, then both decoders: each must give the
    arrays back."""
    planes, kp, cp, key0 = kmer.plane_pack(torch.from_numpy(keys),
                                           torch.from_numpy(counts))
    for got in (kmer.decode_planes_numpy(planes.numpy(), keys.size, kp, cp,
                                         key0),
                kstore.decode_planes_native(planes.numpy(), keys.size, kp,
                                            cp, key0)):
        assert np.array_equal(got[0], keys) and np.array_equal(got[1],
                                                               counts)


@pytest.mark.parametrize("capacity,staging", [(1 << 12, 2), (1 << 12, 40),
                                              (64, 1), (40, 2)])
def test_codec_round_trips_a_drained_store(rng, monkeypatch, capacity,
                                           staging):
    """The JAX accumulator's drain through its codec
    (test_compressed_drain_exact in the JAX tests, its COMPRESS_MIN_KEYS
    at 0) == the port's raw drain, spilled or not, and that drain
    round-trips through the port's codec."""
    batches = _batches(rng)
    acc, got = _accumulate(batches, capacity, staging)
    monkeypatch.setattr(jkmer, "COMPRESS_MIN_KEYS", 0)
    jacc = jkmer.DeviceKmerAccumulator(capacity=capacity,
                                       staging_batches=staging)
    for _, (hi, lo, ct, _) in batches:
        jacc.add(hi, lo, ct)
    want = _jax_triple(*jacc.drain(), 9)
    assert acc.spilled == (capacity < 100)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    _round_trip(*got)


@pytest.mark.parametrize("k", [8, 13, 21, 31])
def test_codec_round_trips_the_engine_store(tmp_path, k):
    """The engine's counts at several k, k = 31 too (the JAX tests'
    test_compressed_drain_tight_embedding): count_kmers_python's, and the
    codec gives them back."""
    rng = np.random.default_rng(k)
    reads = _reads(rng, 60, lo=k, hi=90)
    path = str(tmp_path / "r.fastq.gz")
    fastq.write_fastq(path, reads)
    res = km.KmerEngine(Config(chunk_size_reads=16), k=k, device=CPU
                        ).count_file(path)
    got = dict(zip(res.arrays[0].tolist(), res.arrays[1].tolist()))
    assert got == _golden(reads, k, False)
    _round_trip(*res.arrays)


def test_native_decoder_without_its_library_raises(monkeypatch):
    """A decoder that cannot be built fails: nothing falls back to the
    NumPy decoder in silence."""
    from mini_parallel_tpu_torch.native import BuildError

    def no_build():
        raise BuildError("g++ failed")

    monkeypatch.setattr(kstore, "load", no_build)
    with pytest.raises(BuildError):
        kstore.decode_planes_native(np.zeros(4, np.uint8), 4, 1, 0, 0)


@pytest.mark.parametrize("capacity,staging", [(1 << 12, 3), (1 << 12, 1),
                                              (50, 2)])
def test_sort_fold_is_order_free(rng, capacity, staging):
    """The fold takes its batches in any order and their keys unsorted:
    the batches reversed and each one shuffled drain to the same counts,
    spilled or not."""
    batches = _batches(rng)
    acc, want = _accumulate(batches, capacity, staging)
    mixed = []
    for (keys, counts, nu), jk in reversed(batches):
        perm = torch.from_numpy(rng.permutation(keys.numel()))
        mixed.append(((keys[perm], counts[perm], nu), jk))
    macc, got = _accumulate(mixed, capacity, staging)
    assert macc.spilled == acc.spilled
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
