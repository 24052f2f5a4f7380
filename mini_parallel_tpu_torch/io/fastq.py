"""Streaming FASTQ(.gz) reading and read-chunking: the Python path of
mini_parallel_tpu/io/fastq.py, with the same chunk boundaries and the same
flat ``(bytes, offsets)`` chunk contract.

Reference ingestion semantics (`smith_waterman/src/aligner.rs:107-178`):
a FASTQ record is 4 lines and the sequence is every line where
``line_count % 4 == 2`` under 1-based counting (aligner.rs:138); reads are
grouped into chunks of ``chunk_size_reads`` and a non-empty final partial
chunk is still yielded (aligner.rs:167-170). gzip decodes in-process.

Multi-file streams (a sample's lanes, in order) and the quality-aware
stream of ``--variant-prep --min-base-quality`` follow the JAX package's
stream functions. Each stream takes an ``engine``, as the JAX package's do:

- ``"native"``: the C++ decoder (native/fastq_reader.cpp), which inflates
  gzip and frames records on its own thread outside the interpreter lock,
  the members of a multi-member gzip file inflated ahead on a pool of
  threads; it must build and load, or the stream raises BuildError;
- ``"python"``: gzip and ``_record_blocks`` in this module, which frame
  records exactly as the native decoder does;
- ``"auto"`` (the default): native when its library builds and loads,
  else python, decided once per process (:func:`resolved_engine`).

An engine is chosen before a stream's first chunk and never changes after
it: falling back once a chunk has reached the caller would read the file
again from its start. The native engine reports no progress lines, as in
the JAX package.
"""

from __future__ import annotations

import functools
import gzip
import itertools
import queue
import sys
import threading
from typing import Callable, Iterator

import numpy as np

from mini_parallel_tpu_torch.native import BuildError, fastq_native
from mini_parallel_tpu_torch.utils import spans

PROGRESS_EVERY_LINES = 1_000_000
MAX_LINE_ERRORS = 10  # more malformed lines than this abort a file, aligner.rs:161
_BLOCK = 1 << 20  # decoded bytes framed at a time
ENGINES = ("auto", "native", "python")


@functools.lru_cache(maxsize=None)
def _auto_engine() -> str:
    try:
        fastq_native.load()
    except BuildError:
        return "python"
    return "native"


def resolved_engine(engine: str = "auto") -> str:
    """The engine that a stream asked for ``engine`` runs: ``"native"`` or
    ``"python"``. ``"native"`` raises BuildError when the decoder cannot be
    built or loaded; ``"auto"`` is native when it can, else python."""
    if engine == "python":
        return engine
    if engine == "native":
        fastq_native.load()
        return engine
    if engine == "auto":
        return _auto_engine()
    raise ValueError(f"unknown FASTQ engine {engine!r}; one of {ENGINES}")


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def open_lines(path: str) -> Iterator[bytes]:
    """Yield the lines of a FASTQ(.gz) or FASTA(.gz) file, each without its
    line ending: one trailing ``\\n`` and one ``\\r`` before it, as Rust's
    ``lines()`` and the JAX package's native decoder strip them
    (fastq_reader.cpp:61, :83). Any other ``\\r`` stays in the line."""
    with _open(path) as stream:
        for line in stream:
            if line[-1:] == b"\n":
                line = line[:-2] if line[-2:-1] == b"\r" else line[:-1]
            yield line


def _is_utf8(line: bytes) -> bool:
    """Whether a line is valid UTF-8. The strict decoder rejects what the
    native decoder's ``utf8_valid`` rejects (fastq_reader.cpp:128-157):
    overlong forms, surrogates, code points above U+10FFFF."""
    try:
        line.decode("utf-8")
    except UnicodeDecodeError:
        return False
    return True


def _record_blocks(path: str) -> Iterator[list[bytes]]:
    """The lines of a FASTQ(.gz) file that count toward its 4-line records,
    in file order, a list for each block of about ``_BLOCK`` bytes; each
    line is stripped as :func:`open_lines` strips it.

    The reference reads lines as UTF-8 strings and its error arm skips a
    line that is not, without counting it, so the framing shifts by the
    skipped lines; more than ``MAX_LINE_ERRORS`` of them abort the file
    (aligner.rs:155-163; the JAX package's native decoder,
    fastq_reader.cpp:206-219). A stream error (gzip corruption or
    truncation, an I/O failure) leaves the stream dead and aborts the file
    at once. Both raise IOError, which the CLI reports as ``ERROR: ...``.
    A block is split, stripped and checked by bytes methods; only a block
    that holds a ``\\r`` or a non-ASCII byte is looked at line by line."""
    counted = errors = 0
    tail = b""
    with _open(path) as stream:
        while True:
            try:
                block = stream.read(_BLOCK)
            except (OSError, EOFError) as e:
                raise IOError(
                    f"Error reading {path} at line {counted}: {e}") from e
            if not block:
                break
            data = tail + block
            lines = data.split(b"\n")
            tail = lines.pop()  # the line the next block ends
            if b"\r" in data:
                lines = [ln[:-1] if ln[-1:] == b"\r" else ln for ln in lines]
            if not data.isascii():
                kept = []
                for ln in lines:
                    if ln.isascii() or _is_utf8(ln):
                        kept.append(ln)
                        continue
                    errors += 1
                    if errors > MAX_LINE_ERRORS:
                        yield kept
                        raise _too_many_errors(path, counted + len(kept))
                lines = kept
            counted += len(lines)
            yield lines
    if tail:  # the last line has no line ending: kept whole
        if tail.isascii() or _is_utf8(tail):
            yield [tail]
        elif errors + 1 > MAX_LINE_ERRORS:  # the last line is one more error
            raise _too_many_errors(path, counted)


def _too_many_errors(path: str, counted: int) -> IOError:
    return IOError(f"Error reading {path}: Too many read errors "
                   f"(>{MAX_LINE_ERRORS}), stopping at line {counted}")


def iter_read_chunks(
    path: str,
    chunk_size_reads: int,
    progress: Callable[[str], None] | None = None,
    engine: str = "auto",
) -> Iterator[list[bytes]]:
    """Yield lists of sequence lines, ``chunk_size_reads`` at a time
    (``process_fastq_file_in_chunks``, aligner.rs:107-178, as a generator)."""
    if resolved_engine(engine) == "native":
        yield from fastq_native.iter_reads_native(path, chunk_size_reads)
        return
    chunk: list[bytes] = []
    line_count = 0
    total_reads = 0
    for lines in _record_blocks(path):
        for line in lines:
            line_count += 1
            if line_count % 4 == 2:  # sequence line, aligner.rs:138
                chunk.append(line)
                total_reads += 1
                if len(chunk) >= chunk_size_reads:
                    yield chunk
                    chunk = []
            if progress and line_count % PROGRESS_EVERY_LINES == 0:
                progress(
                    f"Read {line_count} lines, found {total_reads} reads, "
                    f"current chunk size: {len(chunk)}"
                )
    if chunk:  # final partial chunk, aligner.rs:167-170
        yield chunk


def iter_flat_chunks(
    path: str,
    chunk_size_reads: int,
    progress: Callable[[str], None] | None = None,
    engine: str = "auto",
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield chunks as flat (bytes, offsets) NumPy pairs: read i of a chunk
    is ``flat[offs[i]:offs[i+1]]`` (offs[0] == 0, offs[-1] == flat.size,
    int64). Chunk boundaries are those of :func:`iter_read_chunks`, so
    chunk-index checkpoints interoperate."""
    if resolved_engine(engine) == "native":
        yield from fastq_native.iter_read_chunks_native(path,
                                                        chunk_size_reads)
        return
    for chunk in iter_read_chunks(path, chunk_size_reads, progress=progress,
                                  engine="python"):
        yield flatten_rows(chunk)


def as_paths(path) -> list[str]:
    """Normalize a str | list[str] input to a list of paths."""
    return [path] if isinstance(path, (str, bytes)) else list(path)


def _over_paths(chunks: Callable, paths, *args, **kwargs) -> Iterator:
    """``chunks`` over a FILE LIST: files concatenate in order, so chunk
    indices (and therefore checkpoint resume points) are global across a
    sample's lanes."""
    for p in as_paths(paths):
        yield from chunks(p, *args, **kwargs)


def iter_flat_chunks_multi(paths, chunk_size_reads: int,
                           progress: Callable[[str], None] | None = None,
                           engine: str = "auto"
                           ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Flat chunk stream over a file list, every file on one engine."""
    return _over_paths(iter_flat_chunks, paths, chunk_size_reads,
                       progress=progress, engine=resolved_engine(engine))


def iter_read_chunks_multi(paths, chunk_size_reads: int,
                           progress: Callable[[str], None] | None = None,
                           engine: str = "auto") -> Iterator[list[bytes]]:
    """Read-list chunk stream over a file list, every file on one
    engine."""
    return _over_paths(iter_read_chunks, paths, chunk_size_reads,
                       progress=progress, engine=resolved_engine(engine))


def process_fastq_file_in_chunks(path: str, chunk_size_reads: int,
                                 processor: Callable[[list[bytes]], None],
                                 **kw) -> tuple[int, int]:
    """Call ``processor`` on each chunk of :func:`iter_read_chunks` (the
    reference's callback form, aligner.rs:107-178); ``kw`` go to the
    stream. Returns (total reads, chunks)."""
    total_reads = chunks = 0
    for chunk in iter_read_chunks(path, chunk_size_reads, **kw):
        processor(chunk)
        total_reads += len(chunk)
        chunks += 1
    return total_reads, chunks


def iter_read_chunks_with_quals(path: str, chunk_size_reads: int,
                                engine: str = "auto"
                                ) -> Iterator[tuple[list[bytes], list[bytes]]]:
    """Yield (sequences, quality strings) chunks: FASTQ lines 2 and 4 of
    each record, framed as :func:`iter_read_chunks` frames them. A chunk
    closes on the quality line of its last record; a truncated final
    record gets an EMPTY quality string."""
    if resolved_engine(engine) == "native":
        yield from fastq_native.iter_reads_with_quals_native(path,
                                                             chunk_size_reads)
        return
    seqs: list[bytes] = []
    quals: list[bytes] = []
    line_count = 0
    for lines in _record_blocks(path):
        for line in lines:
            line_count += 1
            m = line_count % 4
            if m == 2:
                seqs.append(line)
            elif m == 0:
                quals.append(line)
                if len(seqs) >= chunk_size_reads:
                    yield seqs, quals
                    seqs, quals = [], []
    if seqs:
        while len(quals) < len(seqs):  # truncated final record
            quals.append(b"")
        yield seqs, quals


def iter_flat_chunks_with_quals(path: str, chunk_size_reads: int,
                                engine: str = "auto"
                                ) -> Iterator[tuple[np.ndarray, ...]]:
    """(seq_flat, seq_offs, qual_flat, qual_offs) chunks: the quals-aware
    flat stream (see iter_flat_chunks for the offsets contract; a record
    whose sequence and quality lengths differ keeps both as decoded)."""
    if resolved_engine(engine) == "native":
        yield from fastq_native.iter_flat_with_quals_native(path,
                                                            chunk_size_reads)
        return
    for seqs, quals in iter_read_chunks_with_quals(path, chunk_size_reads,
                                                   engine="python"):
        yield (*flatten_rows(seqs), *flatten_rows(quals))


def iter_flat_chunks_with_quals_multi(paths, chunk_size_reads: int,
                                      engine: str = "auto"
                                      ) -> Iterator[tuple[np.ndarray, ...]]:
    """Quals-aware flat chunk stream over a file list, every file on one
    engine."""
    return _over_paths(iter_flat_chunks_with_quals, paths, chunk_size_reads,
                       engine=resolved_engine(engine))


def iter_read_chunks_with_quals_multi(paths, chunk_size_reads: int,
                                      engine: str = "auto"
                                      ) -> Iterator[tuple[list[bytes],
                                                          list[bytes]]]:
    """(sequences, quals) chunk stream over a file list, every file on one
    engine."""
    return _over_paths(iter_read_chunks_with_quals, paths, chunk_size_reads,
                       engine=resolved_engine(engine))


def flatten_rows(rows: list) -> tuple[np.ndarray, np.ndarray]:
    """list[bytes] -> the flat (bytes, offsets) contract."""
    flat = np.frombuffer(b"".join(rows), np.uint8)
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    return flat, offs


class prefetch:
    """Run an iterator in a background thread with a bounded queue.

    Overlaps the producer (gzip decode, record parse) with the consumer's
    per-item work (pad, pack, device dispatch). Producer exceptions re-raise
    at the consumer's next pull. Use it as a context manager: leaving the
    ``with`` block (or :meth:`close`) stops the producer, closes the wrapped
    iterator on the producer's own thread and joins it — the producer's
    lifetime never depends on garbage collection.

    Each item is one chunk, numbered from 0 in the stream's order. Spans
    (utils/spans.py): ``fastq.decode`` is the producer's time in the
    wrapped iterator's ``next()`` for each chunk (the last one finds the
    stream's end), ``fastq.put_wait`` the producer blocked on a full queue,
    ``fastq.wait`` the consumer blocked on an empty one; the counter
    ``fastq.chunks`` counts the chunks decoded.
    """

    _END = object()

    def __init__(self, it: Iterator, depth: int = 4):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._pulled = 0  # chunks handed to the consumer
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mptt-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            pass
        with spans.span("fastq.put_wait"):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
        return False

    def _run(self) -> None:
        try:
            it = iter(self._it)
            for chunk in itertools.count():
                with spans.span("fastq.decode", chunk):
                    item = next(it, self._END)
                if item is self._END:
                    break
                spans.count("fastq.chunks")
                if not self._put((None, item)):
                    return
            self._put((self._END, None))
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._put((e, None))
        finally:
            close = getattr(self._it, "close", None)
            if close is not None:
                close()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            kind, item = self._q.get_nowait()
        except queue.Empty:
            with spans.span("fastq.wait", self._pulled):
                kind, item = self._q.get()
        if kind is self._END:
            self._q.put((self._END, None))  # later pulls end too
            raise StopIteration
        if kind is not None:
            raise kind
        self._pulled += 1
        return item

    def close(self) -> None:
        """Stop the producer and wait for it to finish its current item."""
        self._stop.set()
        self._thread.join()

    def __enter__(self) -> "prefetch":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def count_lines(path: str, engine: str = "auto") -> int:
    """Lines of a plain or gzip file, the ``linecount`` tool
    (tools/linecount.rs:6-30), by the engine resolved before the file is
    read. A stream error (a truncated or corrupt .gz) raises IOError."""
    if resolved_engine(engine) == "native":
        return fastq_native.count_lines_native(path)
    n = 0
    try:
        for _ in open_lines(path):
            n += 1
    except (OSError, EOFError) as e:
        raise IOError(f"Error reading {path} at line {n}: {e}") from e
    return n


def count_lines_stdin(stream=None) -> int:
    """Lines of a binary stream, standard input by default (the
    ``stdin_linecount`` tool, tools/stdin_linecount.rs:3-21)."""
    return sum(1 for _ in (sys.stdin.buffer if stream is None else stream))


def count_bases(path: str, chunk_size_reads: int = 10_000,
                engine: str = "auto") -> int:
    """Total sequence bases in a FASTQ file (aligner.rs:535-544)."""
    return sum(int(flat.size) for flat, _ in
               iter_flat_chunks(path, chunk_size_reads, engine=engine))


def count_reads(path: str, chunk_size_reads: int = 10_000,
                engine: str = "auto") -> int:
    """Reads (4-line records, a truncated last one included) in a FASTQ
    file."""
    return sum(len(offs) - 1 for _, offs in
               iter_flat_chunks(path, chunk_size_reads, engine=engine))


def write_fastq(path: str, reads: list[bytes | str], quality_char: str = "I") -> None:
    """Write a minimal valid FASTQ(.gz) — fixture helper for tests and demos."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for i, r in enumerate(reads):
            if isinstance(r, bytes):
                r = r.decode("ascii")
            f.write(f"@read_{i}\n{r}\n+\n{quality_char * len(r)}\n")
