"""The port's native host data plane (mini_parallel_tpu_torch/native: the
g++ build helper, the FASTQ decoder, the 2-bit packer and the k-mer store)
against the JAX package's native plane, on the fixtures of
tests/test_native.py and seeded NumPy inputs. Exact equality throughout.

Both planes are built with g++ at first use; where no toolchain builds
them, these tests skip with the build's error as the reason.
"""

import ctypes
import gzip
import os
import struct
import threading
import time
import zlib
from collections import Counter

import numpy as np
import pytest

from mini_parallel_tpu.ops import packed as jpacked
from mini_parallel_tpu_torch import native
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.native import fastq_native, kmer_store
from mini_parallel_tpu_torch.ops import kmer
from mini_parallel_tpu_torch.ops import packed
from mini_parallel_tpu_torch.utils import spans
from tests.conftest import random_dna


@pytest.fixture
def port_native():
    """Skips unless the port's three libraries build and load here."""
    try:
        for name in native.LIBRARIES:
            native.load(name)
    except native.BuildError as e:
        pytest.skip(f"the port's native libraries do not build here: {e}")


@pytest.fixture
def jax_native(port_native):
    """The JAX package's native plane, built by its own make."""
    from mini_parallel_tpu import native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's native plane does not build here")
    from mini_parallel_tpu.native import fastq_native as jfq
    from mini_parallel_tpu.native import kmer_store as jks

    return jfq, jks


@pytest.fixture
def fqgz(tmp_path, rng):
    reads = [random_dna(rng, int(rng.integers(10, 200))) for _ in range(123)]
    path = str(tmp_path / "native.fastq.gz")
    fastq.write_fastq(path, reads)
    return path, reads


def _flat(chunks):
    return [tuple(a.tolist() for a in c) for c in chunks]


# ----------------------------------------------------------------------
# the decoder
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 17, 40, 50, 123, 500])
def test_chunks_and_flat_offsets_match_jax(fqgz, jax_native, n):
    jfq, _ = jax_native
    path, reads = fqgz
    got = list(fastq_native.iter_reads_native(path, n))
    assert got == list(jfq.iter_reads_native(path, n))
    assert [len(c) for c in got] == [len(reads[i:i + n])
                                     for i in range(0, len(reads), n)]
    flat = list(fastq_native.iter_read_chunks_native(path, n))
    assert _flat(flat) == _flat(jfq.iter_read_chunks_native(path, n))
    for data, offs in flat:
        assert offs[0] == 0 and offs[-1] == data.size
    assert [r for c in got for r in c] == reads


def test_plain_file_and_count_lines(tmp_path, rng, fqgz, jax_native):
    jfq, _ = jax_native
    reads = [random_dna(rng, 30) for _ in range(5)]
    path = str(tmp_path / "plain.fastq")
    fastq.write_fastq(path, reads)  # gzopen reads plain files too
    assert [r for c in fastq_native.iter_reads_native(path, 2)
            for r in c] == reads
    for p, n in ((path, 5), (fqgz[0], len(fqgz[1]))):
        assert fastq_native.count_lines_native(p) == 4 * n
        assert fastq_native.count_lines_native(p) == jfq.count_lines_native(p)


def test_buffer_growth(tmp_path, rng, jax_native):
    """A tiny size hint forces the grow-and-retry path (-2)."""
    jfq, _ = jax_native
    reads = [random_dna(rng, 5000) for _ in range(10)]
    path = str(tmp_path / "big.fastq.gz")
    fastq.write_fastq(path, reads)
    got = list(fastq_native.iter_read_chunks_native(path, 4,
                                                    avg_read_len_hint=8))
    want = list(jfq.iter_read_chunks_native(path, 4, avg_read_len_hint=8))
    assert _flat(got) == _flat(want)
    quals = list(fastq_native.iter_flat_with_quals_native(
        path, 4, avg_read_len_hint=8))
    assert [q[:2] for q in _flat(quals)] == _flat(got)
    assert b"".join(q[2].tobytes() for q in quals) == b"I" * 50_000


def _quals_file(path: str) -> None:
    with gzip.open(path, "wt") as f:
        for i in range(23):
            n = 20 + (i * 7) % 50
            seq = "".join("ACGT"[(i + j) % 4] for j in range(n))
            qual = "".join(chr(33 + (i + j) % 40) for j in range(n))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")


@pytest.mark.parametrize("n", [1, 5, 23, 64])
def test_quality_streams_match_jax(tmp_path, jax_native, n):
    jfq, _ = jax_native
    path = str(tmp_path / "q.fastq.gz")
    _quals_file(path)
    assert (list(fastq_native.iter_reads_with_quals_native(path, n))
            == list(jfq.iter_reads_with_quals_native(path, n)))
    assert (_flat(fastq_native.iter_flat_with_quals_native(path, n))
            == _flat(jfq.iter_flat_with_quals_native(path, n)))


def test_truncated_final_record_gets_an_empty_quality(tmp_path, jax_native):
    jfq, _ = jax_native
    path = str(tmp_path / "trunc.fastq.gz")
    with gzip.open(path, "wt") as f:
        f.write("@a\nACGTACGT\n+\nIIIIIIII\n@b\nTTTTGGGG\n")  # no qual for b
    (seqs, quals), = fastq_native.iter_reads_with_quals_native(path, 10)
    assert seqs == [b"ACGTACGT", b"TTTTGGGG"]
    assert quals == [b"IIIIIIII", b""]
    assert list(jfq.iter_reads_with_quals_native(path, 10)) == [(seqs, quals)]


def _counters(path, chunk: int):
    """Drain a low-level reader; -> (error count, line count)."""
    lib = fastq_native.load()
    h = lib.fq_open_q(str(path).encode(), chunk, 0)
    try:
        buf = np.empty(1 << 16, np.uint8)
        offs = np.empty(64, np.int64)
        nb, nr = ctypes.c_int64(), ctypes.c_int64()
        while lib.fq_next_chunk(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                buf.size, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                offs.size, ctypes.byref(nb), ctypes.byref(nr)) > 0:
            pass
        return lib.fq_error_count(h), lib.fq_line_count(h)
    finally:
        lib.fq_close(h)


def test_malformed_lines_are_skipped_uncounted(tmp_path, jax_native):
    """tests/test_native.py::test_native_skips_malformed_lines."""
    jfq, _ = jax_native
    reads = [b"ACGTACGT", b"GGGGCCCC", b"TTTTAAAA"]
    path = tmp_path / "bad.fastq"
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            if i == 1:
                f.write(b"\xff\xfe garbage \x80\n")  # not UTF-8: skipped
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    got = [r for c in fastq_native.iter_reads_native(str(path), 10)
           for r in c]
    assert got == reads == [r for c in jfq.iter_reads_native(str(path), 10)
                            for r in c]
    assert _counters(path, 10) == (1, 12)  # 3 records; the bad line uncounted


@pytest.mark.parametrize("quals", [False, True])
def test_eleven_errors_abort(tmp_path, jax_native, quals):
    jfq, _ = jax_native
    path = tmp_path / "verybad.fastq"
    path.write_bytes(b"@r0\nACGT\n+\nIIII\n" + b"\xffjunk\n" * 11
                     + b"@r1\nGGGG\n+\nIIII\n")
    port = (fastq_native.iter_reads_with_quals_native if quals
            else fastq_native.iter_reads_native)
    jax = (jfq.iter_reads_with_quals_native if quals
           else jfq.iter_reads_native)
    with pytest.raises(IOError, match="Too many read errors") as e:
        list(port(str(path), 10))
    with pytest.raises(IOError, match="Too many read errors") as je:
        list(jax(str(path), 10))
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("quals", [False, True])
def test_corrupt_gzip_raises_and_yields_no_partial_chunk(tmp_path,
                                                         jax_native, quals):
    """A truncated gzip stream raises IOError("Error reading ..."); the
    chunk it cut short is never yielded."""
    jfq, _ = jax_native
    path = tmp_path / "trunc.fastq.gz"
    blob = gzip.compress(b"".join(b"@r%d\n%s\n+\n%s\n"
                                  % (i, b"ACGT" * 30, b"I" * 120)
                                  for i in range(200)))
    path.write_bytes(blob[:len(blob) // 2])
    port = (fastq_native.iter_flat_with_quals_native if quals
            else fastq_native.iter_read_chunks_native)
    got = []
    with pytest.raises(IOError, match="Error reading") as e:
        for c in port(str(path), 1000):
            got.append(c)
    assert got == []  # 200 records fit one chunk: nothing before the error
    jax = (jfq.iter_flat_with_quals_native if quals
           else jfq.iter_read_chunks_native)
    with pytest.raises(IOError) as je:
        list(jax(str(path), 1000))
    assert str(e.value) == str(je.value)


# ----------------------------------------------------------------------
# multi-member gzip: members inflated ahead on the decoder's worker pool
# ----------------------------------------------------------------------


def _fastq_text(rng, n: int) -> bytes:
    """``n`` records of 20-179 bases with random quality lines."""
    ends = np.cumsum(rng.integers(20, 180, n)).tolist()
    bases = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, ends[-1])].tobytes()
    quals = rng.integers(33, 74, ends[-1], dtype=np.uint8).tobytes()
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, bases[a:b], quals[a:b])
                    for i, (a, b) in enumerate(zip([0, *ends], ends)))


def _gz(data: bytes, level: int = 1) -> bytes:
    return gzip.compress(data, compresslevel=level, mtime=0)


def _cut(text: bytes, cuts) -> list[bytes]:
    edges = [0, *sorted(cuts), len(text)]
    return [text[a:b] for a, b in zip(edges, edges[1:])]


def _record_cuts(text: bytes, records: int) -> list[int]:
    """Byte offsets that split ``text`` every ``records`` records."""
    starts = [i + 1 for i in range(len(text) - 1)
              if text[i] == 10 and text[i + 1] == ord("@")]
    return starts[records - 1::records]


def _bgzf(text: bytes, block: int = 60_000) -> bytes:
    """BGZF as bgzip writes it: members with a BC extra subfield giving
    each member's size, then the empty end-of-file member."""
    out = []
    for lo in range(0, len(text) + 1, block):
        data = text[lo:lo + block]
        if not data and lo:
            break
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        body = c.compress(data) + c.flush()
        size = 18 + 6 + len(body)
        out.append(b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0"
                   + struct.pack("<H", size - 1) + body
                   + struct.pack("<II", zlib.crc32(data), len(data)))
    eof = bytes.fromhex("1f8b08040000000000ff0600424302001b00"
                        "03000000000000000000")
    return b"".join(out) + eof


def _stored(data: bytes) -> bytes:
    c = zlib.compressobj(0, zlib.DEFLATED, 31)
    return c.compress(data) + c.flush()


def _member_file(rng, case: str) -> bytes:
    """A multi-member gzip file written by hand, for each case."""
    text = _fastq_text(rng, 6000)  # ~0.9 MB, 1.2 MB with text2
    text2 = text + _fastq_text(rng, 2000)
    cuts = sorted(int(c) for c in rng.integers(1, len(text), 30))
    if case == "one_member":
        return _gz(text2)
    if case == "members_beyond_workers":
        return b"".join(_gz(p) for p in _cut(text2, _record_cuts(text2, 180)))
    if case == "cut_inside_lines":
        return b"".join(_gz(p) for p in _cut(text, cuts))
    if case == "empty_members":
        return b"".join(_gz(p) for p in [
            b"", *_cut(text, cuts[:3]), b"", b"", *_cut(text, cuts[3:6]), b""])
    if case == "bgzf":
        return _bgzf(text2)
    assert case == "false_header_stored"
    # a stored member, beyond the decoder's first 1 MiB window a line
    # holding a false gzip header (not UTF-8, so both decoders skip it),
    # then level-1 members
    at = text2.index(b"\n@", 1_100_000) + 1
    false_line = b"\x1f\x8b\x08\x00 not a member \xff\n"
    return _stored(text2[:at] + false_line + text2[at:]) + b"".join(
        _gz(p) for p in _cut(text, _record_cuts(text, 1500)))


def _stream(mod, path, quals: bool, n: int):
    """Every chunk as bytes, then the error text (None at a clean end)."""
    it = (mod.iter_flat_with_quals_native(str(path), n) if quals
          else mod.iter_read_chunks_native(str(path), n))
    got = []
    try:
        for c in it:
            got.append(tuple(a.tobytes() for a in c))
    except IOError as e:
        return got, str(e)
    return got, None


@pytest.mark.parametrize("n", [7, 500, 100_000])
@pytest.mark.parametrize("quals", [False, True], ids=["seqs", "quals"])
@pytest.mark.parametrize("case", ["one_member", "members_beyond_workers",
                                  "cut_inside_lines", "empty_members", "bgzf",
                                  "false_header_stored"])
def test_members_match_jax(tmp_path, rng, jax_native, case, quals, n):
    """Multi-member gzip files decode to the chunks the JAX package's
    decoder (one gzread) gives, exactly."""
    jfq, _ = jax_native
    blob = _member_file(rng, case)
    path = tmp_path / f"{case}.fastq.gz"
    path.write_bytes(blob)
    got = _stream(fastq_native, path, quals, n)
    assert got[1] is None and got[0]
    assert got == _stream(jfq, path, quals, n)


def _broken_files(rng) -> dict[str, bytes]:
    text = _fastq_text(rng, 2500)  # ~370 kB a member
    members = [_gz(text) for _ in range(6)]
    crc = bytearray(members[3])
    crc[-8] ^= 1  # the member's CRC32
    data = bytearray(members[3])
    data[len(data) // 2] ^= 0x10
    return {
        "truncated_last": b"".join(members)[:-len(members[5]) // 2],
        "bad_crc_middle": b"".join(members[:3] + [bytes(crc)] + members[4:]),
        "bad_data_middle": b"".join(members[:3] + [bytes(data)]
                                    + members[4:]),
        "trailing_garbage": b"".join(members) + b"\0\0 not gzip \x1f\x8b",
        "trailing_magic_byte": b"".join(members) + b"\x1f",
        "trailing_bad_header": b"".join(members) + b"\x1f\x8b\x09\0",
        "truncated_header": b"".join(members) + b"\x1f\x8b\x08",
    }


@pytest.mark.parametrize("quals", [False, True], ids=["seqs", "quals"])
@pytest.mark.parametrize("case", ["truncated_last", "bad_crc_middle",
                                  "bad_data_middle", "trailing_garbage",
                                  "trailing_magic_byte",
                                  "trailing_bad_header", "truncated_header"])
def test_member_errors_match_jax(tmp_path, rng, jax_native, case, quals):
    """A broken multi-member file gives the chunks before the error and the
    error text of the JAX package's decoder; bytes after the last member
    that are not a gzip header are ignored, as gzread ignores them."""
    jfq, _ = jax_native
    path = tmp_path / f"{case}.fastq.gz"
    path.write_bytes(_broken_files(rng)[case])
    got = _stream(fastq_native, path, quals, 1000)
    assert got == _stream(jfq, path, quals, 1000)
    clean = case in ("trailing_garbage", "trailing_magic_byte")
    assert (got[1] is None) == clean
    assert got[0]  # the chunks before the broken member


def _counted(path, n: int = 50) -> dict[str, int]:
    """Drain a file with the recorder on, the consumer pausing after its
    first chunk so that the workers claim what lies ahead."""
    spans.start()
    try:
        it = fastq_native.iter_read_chunks_native(str(path), n)
        next(it)
        time.sleep(0.2)
        for _ in it:
            pass
    finally:
        counters = spans.stop().counters
    return {k: v for k, v in counters.items() if k.startswith("fastq.")}


def _members(blob: bytes) -> int:
    n = pos = 0
    while pos < len(blob):
        d = zlib.decompressobj(31)
        d.decompress(blob[pos:])
        pos = len(blob) - len(d.unused_data)
        n += 1
    return n


def test_member_counters_reach_the_recorder(tmp_path, rng, port_native):
    """``fastq.members``, ``fastq.members_ahead`` and
    ``fastq.split_rejected`` from a closed reader; none for a plain file."""
    pool = int(len(os.sched_getaffinity(0)) >= 2)  # else no worker pool
    for case in ("members_beyond_workers", "one_member",
                 "false_header_stored"):
        blob = _member_file(rng, case)
        path = tmp_path / f"{case}.fastq.gz"
        path.write_bytes(blob)
        c = _counted(path)
        assert c["fastq.members"] == _members(blob), case
        if case == "one_member":
            assert c["fastq.members_ahead"] == 0
            assert c["fastq.split_rejected"] == 0
        else:
            assert c["fastq.members_ahead"] >= pool
    assert c["fastq.split_rejected"] >= pool  # the false header's
    plain = tmp_path / "plain.fastq"
    plain.write_bytes(_fastq_text(rng, 100))
    assert _counted(plain) == {}


def test_concurrent_member_readers_agree(tmp_path, rng, jax_native):
    """More readers at once than cores share the process's worker slots:
    each gives the JAX decoder's chunks, and every slot comes back."""
    jfq, _ = jax_native
    path = tmp_path / "members.fastq.gz"
    path.write_bytes(_member_file(rng, "members_beyond_workers"))
    want = _stream(jfq, path, True, 333)
    got = [None] * (2 * (os.cpu_count() or 1) + 2)

    def read(i):
        got[i] = _stream(fastq_native, path, i % 2 == 0, 333)

    threads = [threading.Thread(target=read, args=(i,))
               for i in range(len(got))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive(), "a reader hung"
    seqs = [tuple(c[:2]) for c in want[0]]
    for i, g in enumerate(got):
        assert g == (want if i % 2 == 0 else (seqs, None))
    if len(os.sched_getaffinity(0)) >= 2:  # the slots were all given back
        assert _counted(path)["fastq.members_ahead"] >= 1


def test_missing_file(jax_native):
    for fn in (fastq_native.iter_reads_native,
               fastq_native.iter_reads_with_quals_native):
        with pytest.raises(IOError, match="cannot open"):
            list(fn("/nonexistent.fastq.gz", 10))
    with pytest.raises(IOError):
        fastq_native.count_lines_native("/nonexistent.fastq.gz")


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


@pytest.fixture
def big_lane(tmp_path, rng):
    """More chunks than the reader reads ahead: its worker blocks."""
    path = str(tmp_path / "big.fastq.gz")
    fastq.write_fastq(path, [random_dna(rng, 150) for _ in range(5_000)])
    return path


@pytest.fixture
def member_lane(tmp_path, rng):
    """300 gzip members of 50 reads, 2.2 MB: beyond the decoder's first
    1 MiB window lie more members than it claims ahead, so its workers
    block too."""
    text = _fastq_text(rng, 15_000)
    path = str(tmp_path / "members.fastq.gz")
    with open(path, "wb") as f:
        f.writelines(_gz(p) for p in _cut(text, _record_cuts(text, 50)))
    return path


@pytest.mark.parametrize("how", ["break", "prefetch", "break_members",
                                 "prefetch_members"])
def test_an_early_stop_closes_the_reader(big_lane, member_lane, port_native,
                                         how):
    """A consumer that stops after one chunk, by ``break`` or by leaving
    ``prefetch``, reaches ``fq_close``: the worker, blocked on a full queue,
    is stopped and joined, with every thread inflating members ahead, and
    nothing deadlocks."""
    if not os.path.isdir("/proc/self/task"):
        pytest.skip("counts threads through /proc")
    path = member_lane if how.endswith("_members") else big_lane
    before = _threads()

    def consume():
        if how.startswith("break"):
            it = fastq.iter_flat_chunks(path, 10, engine="native")
            for _ in it:
                break
            time.sleep(0.1)  # the workers claim what they can
            it.close()
        else:
            with fastq.prefetch(fastq.iter_flat_chunks(
                    path, 10, engine="native")) as chunks:
                next(chunks)
                time.sleep(0.1)

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "closing the reader deadlocked"
    deadline = time.monotonic() + 5  # an OS thread outlives its join briefly
    while _threads() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _threads() <= before  # the reader's worker is gone


def test_engines_resolve_before_the_first_chunk(fqgz, port_native,
                                                monkeypatch):
    path, reads = fqgz
    assert fastq.resolved_engine("auto") == "native"
    assert fastq.resolved_engine("python") == "python"
    with pytest.raises(ValueError, match="unknown FASTQ engine"):
        fastq.resolved_engine("zcat")
    # a native engine that cannot build raises; auto takes python
    monkeypatch.setattr(fastq.fastq_native, "load", _no_build)
    with pytest.raises(native.BuildError):
        list(fastq.iter_read_chunks(path, 10, engine="native"))
    monkeypatch.setattr(fastq, "_auto_engine",
                        fastq._auto_engine.__wrapped__)
    assert fastq.resolved_engine("auto") == "python"
    assert [r for c in fastq.iter_read_chunks(path, 10) for r in c] == reads


def _no_build():
    raise native.BuildError("no g++")


# ----------------------------------------------------------------------
# the build helper
# ----------------------------------------------------------------------


def test_build_key_follows_source_and_flags(tmp_path, port_native,
                                            monkeypatch):
    for name, (src, _) in native.LIBRARIES.items():
        (tmp_path / src).write_bytes((native.SRC_DIR / src).read_bytes())
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    before = {n: native.library_path(n) for n in native.LIBRARIES}
    assert before == {n: native.library_path(n) for n in native.LIBRARIES}
    (tmp_path / "pack2bit.cpp").write_text("// changed\n")
    after = {n: native.library_path(n) for n in native.LIBRARIES}
    assert after["pack2bit"] != before["pack2bit"]
    assert after["fastq"] == before["fastq"]
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-g"))
    assert native.library_path("fastq") != before["fastq"]
    assert all(p.name.startswith(f"{n}-") and p.suffix == ".so"
               for n, p in before.items())


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        port_native,
                                                        monkeypatch):
    (tmp_path / "pack2bit.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native._build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(native.BuildError, match="(?s)g\\+\\+ failed.*error"):
        native.build("pack2bit")
    assert list((tmp_path / "out").iterdir()) == []  # no partial library


# ----------------------------------------------------------------------
# the packer
# ----------------------------------------------------------------------


@pytest.mark.parametrize("L", [4, 32, 152])
@pytest.mark.parametrize("exceptions", [0.0, 0.01, 0.3])
def test_packer_matches_jax(rng, port_native, L, exceptions):
    B = 257
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L))
    bad = rng.random((B, L)) < exceptions
    arr[bad] = rng.choice(np.frombuffer(b"NnacgtRY", np.uint8), bad.sum())
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = (0, L, L // 2)
    arr[np.arange(L)[None, :] >= lengths[:, None]] = 0xFE  # pad
    want = jpacked.pack_batch(arr, lengths)
    for pb in (packed.pack_batch_native(arr, lengths),
               packed.pack_batch_numpy(arr, lengths),
               packed.pack_batch(arr, lengths)):
        for f in ("packed", "exc_col", "exc_val", "lengths"):
            got, ref = getattr(pb, f), getattr(want, f)
            assert got.dtype == ref.dtype and np.array_equal(got, ref), f
        assert pb.length == want.length


def test_packer_checks_its_input(port_native):
    arr = np.zeros((2, 8), np.uint8)
    with pytest.raises(ValueError, match="multiple of 4"):
        packed.pack_batch_native(np.zeros((2, 6), np.uint8), [1, 1])
    with pytest.raises(ValueError, match="lengths"):
        packed.pack_batch_native(arr, [3, 9])


# ----------------------------------------------------------------------
# the k-mer store
# ----------------------------------------------------------------------


def test_store_merge_and_dump_match_jax(jax_native):
    """tests/test_native.py::test_kmer_store_merge_and_dump on int64
    keys: the JAX store's (hi, lo) = (1, 10) is key (1 << 20) | 10 at
    k = 21."""
    _, jks = jax_native
    hi = np.array([1, 2, 1, 3], np.int32)
    lo = np.array([10, 20, 10, 30], np.int32)
    ct = np.array([2, 5, 3, 0], np.int32)  # count 0 = padding, skipped
    js = jks.KmerStore(16)
    js.merge(hi, lo, ct)
    ks = kmer_store.KmerStore(16)
    ks.merge(kmer.join_keys(hi, lo, 21), ct)
    assert len(ks) == len(js) == 2 and ks.total() == js.total() == 10
    assert ks.items() == {int(kmer.join_keys(h, lo_, 21)): c
                          for (h, lo_), c in js.items().items()}
    assert ks.get(int(kmer.join_keys(1, 10, 21))) == js.get(1, 10) == 5
    assert ks.get(int(kmer.join_keys(3, 30, 21))) == 0


@pytest.mark.parametrize("k", [8, 21, 31])
def test_store_growth_matches_jax_and_counter(rng, jax_native, k):
    _, jks = jax_native
    n = 10_000
    keys = rng.integers(0, 1 << (2 * k), n, dtype=np.int64)
    keys[: n // 2] = keys[n // 2:]  # repeats
    ct = rng.integers(1, 5, n).astype(np.int64)
    ks = kmer_store.KmerStore(16)
    ks.merge(keys[:7000], ct[:7000])
    ks.merge(keys[7000:], ct[7000:])
    want = Counter()
    for key, c in zip(keys.tolist(), ct.tolist()):
        want[key] += c
    assert ks.items() == dict(want) and len(ks) == len(want)
    assert ks.total() == int(ct.sum())
    got_k, got_c = ks.items_arrays()
    assert dict(zip(got_k.tolist(), got_c.tolist())) == dict(want)
    js = jks.KmerStore(16)
    hi, lo = kmer.split_keys(keys, k)
    js.merge(hi, lo, ct.astype(np.int32))
    jk, jc = js.items_arrays()[:2], js.items_arrays()[2]
    assert dict(zip(kmer.join_keys(*jk, k).tolist(),
                    jc.astype(np.int64).tolist())) == dict(want)


def test_store_rejects_mismatched_arrays(port_native):
    with pytest.raises(ValueError, match="one length"):
        kmer_store.KmerStore().merge(np.zeros(3, np.int64),
                                     np.zeros(2, np.int64))
