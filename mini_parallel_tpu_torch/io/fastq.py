"""Streaming FASTQ(.gz) reading and read-chunking: the Python path of
mini_parallel_tpu/io/fastq.py, with the same chunk boundaries and the same
flat ``(bytes, offsets)`` chunk contract.

Reference ingestion semantics (`smith_waterman/src/aligner.rs:107-178`):
a FASTQ record is 4 lines and the sequence is every line where
``line_count % 4 == 2`` under 1-based counting (aligner.rs:138); reads are
grouped into chunks of ``chunk_size_reads`` and a non-empty final partial
chunk is still yielded (aligner.rs:167-170). gzip decodes in-process.

The native C++ decoder of the JAX package is not ported yet.
"""

from __future__ import annotations

import gzip
import queue
import threading
from typing import Callable, Iterator

import numpy as np

PROGRESS_EVERY_LINES = 1_000_000


def open_lines(path: str) -> Iterator[bytes]:
    """Yield raw lines (no trailing newline) from a FASTQ or FASTQ.gz file."""
    stream = gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")
    with stream:
        for line in stream:
            yield line.rstrip(b"\r\n")


def iter_read_chunks(
    path: str,
    chunk_size_reads: int,
    progress: Callable[[str], None] | None = None,
) -> Iterator[list[bytes]]:
    """Yield lists of sequence lines, ``chunk_size_reads`` at a time
    (``process_fastq_file_in_chunks``, aligner.rs:107-178, as a generator)."""
    chunk: list[bytes] = []
    line_count = 0
    total_reads = 0
    lines = open_lines(path)
    while True:
        try:
            line = next(lines)
        except StopIteration:
            break
        except (OSError, EOFError) as e:
            # a stream error (gzip corruption, I/O failure) leaves the
            # generator dead, so it aborts the file
            raise IOError(f"Error reading {path} at line {line_count}: {e}") from e
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
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield chunks as flat (bytes, offsets) NumPy pairs: read i of a chunk
    is ``flat[offs[i]:offs[i+1]]`` (offs[0] == 0, offs[-1] == flat.size,
    int64). Chunk boundaries are those of :func:`iter_read_chunks`, so
    chunk-index checkpoints interoperate."""
    for chunk in iter_read_chunks(path, chunk_size_reads, progress=progress):
        yield _flatten_rows(chunk)


def _flatten_rows(rows: list) -> tuple[np.ndarray, np.ndarray]:
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
    """

    _END = object()

    def __init__(self, it: Iterator, depth: int = 4):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mptt-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._it:
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
        kind, item = self._q.get()
        if kind is self._END:
            self._q.put((self._END, None))  # later pulls end too
            raise StopIteration
        if kind is not None:
            raise kind
        return item

    def close(self) -> None:
        """Stop the producer and wait for it to finish its current item."""
        self._stop.set()
        self._thread.join()

    def __enter__(self) -> "prefetch":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def count_bases(path: str, chunk_size_reads: int = 10_000) -> int:
    """Total sequence bases in a FASTQ file (aligner.rs:535-544)."""
    return sum(int(flat.size)
               for flat, _ in iter_flat_chunks(path, chunk_size_reads))


def write_fastq(path: str, reads: list[bytes | str], quality_char: str = "I") -> None:
    """Write a minimal valid FASTQ(.gz) — fixture helper for tests and demos."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for i, r in enumerate(reads):
            if isinstance(r, bytes):
                r = r.decode("ascii")
            f.write(f"@read_{i}\n{r}\n+\n{quality_char * len(r)}\n")
