"""The port's FASTQ streams frame records as the JAX package's default
engine, its native C++ decoder, frames them: a line that is not valid UTF-8
is skipped without being counted and more than ten of them abort the file;
one "\\n" and one "\\r" before it end a line; a stream error aborts the file
with an IOError in every stream. Each stream of the port, on both of its
engines (its own native decoder and its Python framing), is held to the
JAX native decoder's output on the same file, and to the values written
below (the values ``tests/test_native.py`` pins where it has them), which
also hold when the native decoder is not built.
"""

import gzip

import numpy as np
import pytest

from mini_parallel_tpu.io import fastq as jfastq
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.native import BuildError


def _native_available() -> bool:
    from mini_parallel_tpu import native

    return native.available()


@pytest.fixture(params=["python", "native"])
def engine(request) -> str:
    """Each of the port's engines; native skips where it does not build."""
    try:
        return fastq.resolved_engine(request.param)
    except BuildError as e:
        pytest.skip(f"the native decoder does not build here: {e}")


def _records(*recs) -> bytes:
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, q)
                    for i, (s, q) in enumerate(recs))


# name -> (file bytes, the sequence lines and quality lines a reader frames)
FILES = {
    # tests/test_native.py::test_native_skips_malformed_lines
    "a non-UTF-8 line between records": (
        _records((b"ACGTACGT", b"IIIIIIII"))
        + b"\xff\xfe garbage \x80\n"
        + _records((b"GGGGCCCC", b"IIIIIIII"), (b"TTTTAAAA", b"IIIIIIII")),
        [b"ACGTACGT", b"GGGGCCCC", b"TTTTAAAA"], [b"IIIIIIII"] * 3),
    # the skipped quality line shifts the framing by one line; the last
    # record then has no quality line and gets an empty one
    "a Latin-1 byte in a quality line": (
        b"@r0\nACGT\n+\nII\xe9I\n@r1\nGGGG\n+\nIIII\n@r2\nTTTT\n+\nIIII\n",
        [b"ACGT", b"+", b"+"], [b"@r1", b"@r2", b""]),
    # ten malformed lines (overlong, surrogate, past U+10FFFF, stray
    # continuation bytes...) are tolerated; valid multi-byte text is kept
    "ten malformed lines": (
        b"@r0\nACGT\n+\nIIII\n"
        + b"".join(b + b"\n" for b in (
            b"\xc0\xaf", b"\xe0\x80\xaf", b"\xed\xa0\x80", b"\xf4\x90\x80\x80",
            b"\xf8\x88\x80\x80\x80", b"\x80", b"\xc3", b"\xe2\x82", b"\xff",
            b"a\xfeb"))
        + b"@r1\nGG\xc3\xa9G\n+\nI\xe2\x82\xacI\n",
        [b"ACGT", b"GG\xc3\xa9G"], [b"IIII", b"I\xe2\x82\xacI"]),
    # one "\r" before the "\n" goes; another stays, as does a "\r" on a last
    # line that has no "\n"
    "CR LF and CR CR LF endings": (
        b"@r0\r\nACGT\r\r\n+\r\nIIII\r\n@r1\r\nGG\rTT\r\n+\r\nII\rII\r\n"
        b"@r2\nCC\n+\nII\r",
        [b"ACGT\r", b"GG\rTT", b"CC"], [b"IIII", b"II\rII", b"II\r"]),
}

# tests/test_native.py::test_native_aborts_after_ten_errors
ELEVEN_BAD = (b"@r0\nACGT\n+\nIIII\n" + b"\xffjunk\n" * 11
              + b"@r1\nGGGG\n+\nIIII\n")

STREAMS = ("reads", "flat", "quals", "flat quals", "bases", "flat multi",
           "flat quals multi")
CHUNKS = (1, 2, 10)


def _flat(pairs):
    return [(f.tobytes(), o.tolist()) for f, o in pairs]


def _flat_quals(chunks):
    return [(s.tobytes(), so.tolist(), q.tobytes(), qo.tolist())
            for s, so, q, qo in chunks]


def port_stream(kind: str, path: str, n: int, engine: str):
    eng = {"engine": engine}
    if kind == "reads":
        return list(fastq.iter_read_chunks(path, n, **eng))
    if kind == "flat":
        return _flat(fastq.iter_flat_chunks(path, n, **eng))
    if kind == "quals":
        return list(fastq.iter_read_chunks_with_quals(path, n, **eng))
    if kind == "flat quals":
        return _flat_quals(fastq.iter_flat_chunks_with_quals(path, n, **eng))
    if kind == "bases":
        return fastq.count_bases(path, n, **eng)
    if kind == "flat multi":
        return _flat(fastq.iter_flat_chunks_multi([path, path], n, **eng))
    return _flat_quals(fastq.iter_flat_chunks_with_quals_multi([path, path], n,
                                                               **eng))


def native_stream(kind: str, path: str, n: int):
    """The JAX package's native engine on the same stream."""
    eng = {"engine": "native"}
    if kind == "reads":
        return list(jfastq.iter_read_chunks(path, n, **eng))
    if kind == "flat":
        return _flat(jfastq.iter_flat_chunks(path, n, **eng))
    if kind == "quals":
        return list(jfastq.iter_read_chunks_with_quals(path, n, **eng))
    if kind == "flat quals":
        return _flat_quals(jfastq.iter_flat_chunks_with_quals(path, n, **eng))
    if kind == "bases":
        return sum(int(f.size) for f, _ in jfastq.iter_flat_chunks(path, n, **eng))
    if kind == "flat multi":
        return _flat(jfastq.iter_flat_chunks_multi([path, path], n, **eng))
    return _flat_quals(jfastq.iter_flat_chunks_with_quals_multi([path, path], n,
                                                                **eng))


def expected_stream(kind: str, seqs: list, quals: list, n: int):
    """What a stream gives for these framed lines in chunks of n."""
    def cut(rows):
        return [rows[i:i + n] for i in range(0, len(rows), n)]

    def flat(rows):
        offs = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=offs[1:])
        return b"".join(rows), offs.tolist()

    if kind == "reads":
        return cut(seqs)
    if kind == "flat":
        return [flat(c) for c in cut(seqs)]
    if kind == "quals":
        return list(zip(cut(seqs), cut(quals)))
    if kind == "flat quals":
        return [(*flat(s), *flat(q)) for s, q in zip(cut(seqs), cut(quals))]
    if kind == "bases":
        return sum(map(len, seqs))
    if kind == "flat multi":
        return 2 * [flat(c) for c in cut(seqs)]
    return 2 * [(*flat(s), *flat(q)) for s, q in zip(cut(seqs), cut(quals))]


def _write(tmp_path, data: bytes, gz: bool) -> str:
    path = tmp_path / ("in.fastq.gz" if gz else "in.fastq")
    path.write_bytes(gzip.compress(data) if gz else data)
    return str(path)


@pytest.mark.parametrize("kind", STREAMS)
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("name", list(FILES))
def test_streams_frame_as_the_native_decoder(tmp_path, name, gz, kind,
                                             engine):
    data, seqs, quals = FILES[name]
    path = _write(tmp_path, data, gz)
    native = _native_available()
    for n in CHUNKS:
        want = expected_stream(kind, seqs, quals, n)
        assert port_stream(kind, path, n, engine) == want, (name, kind, n)
        if native:
            assert native_stream(kind, path, n) == want, (name, kind, n)


@pytest.mark.parametrize("kind", STREAMS)
def test_eleven_malformed_lines_abort_every_stream(tmp_path, kind, engine):
    path = _write(tmp_path, ELEVEN_BAD, False)
    with pytest.raises(IOError, match=r"Too many read errors \(>10\)"):
        port_stream(kind, path, 10, engine)
    if _native_available():
        with pytest.raises(IOError, match="Too many read errors"):
            native_stream(kind, path, 10)


@pytest.fixture(scope="module")
def cut_gz(tmp_path_factory) -> str:
    """A 20,000-record FASTQ.gz cut in half: a truncated gzip stream."""
    rng = np.random.default_rng(6)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = rng.choice(acgt, (20_000, 150))
    text = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * 150)
                    for i, r in enumerate(reads))
    blob = gzip.compress(text, compresslevel=1)
    path = tmp_path_factory.mktemp("cut") / "cut.fastq.gz"
    path.write_bytes(blob[:len(blob) // 2])
    return str(path)


@pytest.mark.parametrize("kind", STREAMS)
def test_truncated_gzip_raises_oserror_in_every_stream(cut_gz, kind, engine):
    """gzip's EOFError reaches the caller as an IOError (an OSError), the
    kind of error the CLI reports, in the quality streams too."""
    with pytest.raises(OSError, match="Error reading"):
        port_stream(kind, cut_gz, 10_000, engine)
    if _native_available():
        with pytest.raises(IOError):
            native_stream(kind, cut_gz, 10_000)


@pytest.mark.parametrize("extra", [["--min-base-quality", "10"], [],
                                   ["--gapped", "--genotype"]])
def test_cli_reports_a_truncated_lane(cut_gz, tmp_path, monkeypatch, extra,
                                     engine):
    """--variant-prep on a truncated lane prints one ERROR line and exits
    1, with or without the quality stream, on either engine (the CLI's
    "auto" engine resolved to it): no exception escapes main."""
    monkeypatch.setattr(fastq, "_auto_engine", lambda: engine)
    rng = np.random.default_rng(7)
    ref = tmp_path / "ref.fa"
    ref.write_bytes(b">chr\n" + rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                           2_000).tobytes() + b"\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "10000")
    out: list[str] = []
    rc = cli.main(["--variant-prep", cut_gz, "--reference", str(ref),
                   *extra, "--allow-cpu"], echo=out.append)
    assert rc == 1
    assert out[-1].startswith("ERROR: Error reading") and cut_gz in out[-1]
