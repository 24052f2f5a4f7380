"""ctypes bindings for the native FASTQ decoder (fastq_reader.cpp): the
counterpart of mini_parallel_tpu/native/fastq_native.py.

The decoder inflates gzip and frames 4-line records on a C++ worker thread
with two chunks of readahead; the members of a multi-member gzip file are
inflated ahead on a pool of threads, the bytes framed in file order.
``ctypes.CDLL`` releases the interpreter lock for every call, so the worker
decodes while the consumer pads, packs and dispatches. Every iterator
closes its reader in ``finally``: a consumer that stops early (``break``, a
closed generator) stops and joins the worker and the pool. A stream error
raises ``IOError("Error reading <path>: ...")`` and the chunk it cut short
is never yielded.

A closed gzip reader adds its member counters to the span recorder
(utils/spans.py): ``fastq.members`` (members inflated),
``fastq.members_ahead`` (of those, inflated by a worker ahead of the
framing thread) and ``fastq.split_rejected`` (candidate member starts that
proved false).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator

import numpy as np

from mini_parallel_tpu_torch import native
from mini_parallel_tpu_torch.utils import spans

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The decoder's library with its C signatures declared (BuildError
    when it cannot be built or loaded)."""
    lib = native.load("fastq")
    lib.fq_open_q.restype = ctypes.c_void_p
    lib.fq_open_q.argtypes = [ctypes.c_char_p, _I64, ctypes.c_int32]
    lib.fq_next_chunk.restype = _I64
    lib.fq_next_chunk.argtypes = [ctypes.c_void_p, _U8P, _I64, _I64P, _I64,
                                  _I64P, _I64P]
    lib.fq_next_chunk_q.restype = _I64
    lib.fq_next_chunk_q.argtypes = [ctypes.c_void_p, _U8P, _I64, _I64P, _I64,
                                    _U8P, _I64, _I64P, _I64, _I64P, _I64P,
                                    _I64P]
    lib.fq_error.restype = ctypes.c_char_p
    lib.fq_error.argtypes = [ctypes.c_void_p]
    for name in ("fq_total_reads", "fq_line_count", "fq_error_count"):
        getattr(lib, name).restype = _I64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.fq_member_stats.restype = None
    lib.fq_member_stats.argtypes = [ctypes.c_void_p, _I64P]
    lib.fq_close.restype = None
    lib.fq_close.argtypes = [ctypes.c_void_p]
    lib.fq_count_lines.restype = _I64
    lib.fq_count_lines.argtypes = [ctypes.c_char_p]
    return lib


def count_lines_native(path: str) -> int:
    """Lines of a plain or gzip file (the ``linecount`` tool)."""
    n = load().fq_count_lines(path.encode())
    if n < 0:
        raise IOError(f"native line count failed for {path}")
    return int(n)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


MEMBER_COUNTERS = ("fastq.members", "fastq.members_ahead",
                   "fastq.split_rejected")


def _close(lib, h) -> None:
    """Close a reader; a gzip file's member counters go to the recorder."""
    stats = np.zeros(len(MEMBER_COUNTERS), np.int64)
    lib.fq_member_stats(h, _ptr(stats, _I64P))
    lib.fq_close(h)
    if stats[0] > 0:
        for name, n in zip(MEMBER_COUNTERS, stats.tolist()):
            spans.count(name, n)


def _raise_stream_error(lib, h, path: str):
    raise IOError(
        f"Error reading {path}: {lib.fq_error(h).decode(errors='replace')}")


def iter_read_chunks_native(path: str, chunk_size_reads: int,
                            avg_read_len_hint: int = 256
                            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield flat (bytes, offsets) chunks: read i is
    ``bytes[offsets[i]:offsets[i+1]]``; offsets are int64 from 0."""
    lib = load()
    h = lib.fq_open_q(path.encode(), chunk_size_reads, 0)
    cap = max(chunk_size_reads * avg_read_len_hint, 1 << 20)
    try:
        buf = np.empty(cap, np.uint8)
        offs = np.empty(chunk_size_reads + 2, np.int64)
        need_b, need_r = _I64(), _I64()
        while True:
            n = lib.fq_next_chunk(h, _ptr(buf, _U8P), buf.size,
                                  _ptr(offs, _I64P), offs.size,
                                  ctypes.byref(need_b), ctypes.byref(need_r))
            if n == 0:
                return
            if n == -1:
                _raise_stream_error(lib, h, path)
            if n == -2:  # buffers too small for this chunk: grow, retry
                buf = np.empty(max(need_b.value, buf.size * 2), np.uint8)
                offs = np.empty(max(need_r.value + 2, offs.size * 2),
                                np.int64)
                continue
            yield buf[:offs[n]].copy(), offs[:n + 1].copy()
    finally:
        _close(lib, h)


def iter_reads_native(path: str, chunk_size_reads: int
                      ) -> Iterator[list[bytes]]:
    """Chunks as lists of sequence lines."""
    for flat, offs in iter_read_chunks_native(path, chunk_size_reads):
        yield _rows(flat, offs)


def iter_flat_with_quals_native(path: str, chunk_size_reads: int,
                                avg_read_len_hint: int = 256
                                ) -> Iterator[tuple[np.ndarray, ...]]:
    """(seq_flat, seq_offs, qual_flat, qual_offs) chunks. A chunk closes on
    the quality line of its last record; a truncated final record gets an
    empty quality string."""
    lib = load()
    h = lib.fq_open_q(path.encode(), chunk_size_reads, 1)
    cap = max(chunk_size_reads * avg_read_len_hint, 1 << 20)
    try:
        buf = np.empty(cap, np.uint8)
        qbuf = np.empty(cap, np.uint8)
        offs = np.empty(chunk_size_reads + 2, np.int64)
        qoffs = np.empty(chunk_size_reads + 2, np.int64)
        need_b, need_r, need_q = _I64(), _I64(), _I64()
        while True:
            n = lib.fq_next_chunk_q(
                h, _ptr(buf, _U8P), buf.size, _ptr(offs, _I64P), offs.size,
                _ptr(qbuf, _U8P), qbuf.size, _ptr(qoffs, _I64P), qoffs.size,
                ctypes.byref(need_b), ctypes.byref(need_r),
                ctypes.byref(need_q))
            if n == 0:
                return
            if n == -1:
                _raise_stream_error(lib, h, path)
            if n == -2:
                buf = np.empty(max(need_b.value, buf.size * 2), np.uint8)
                qbuf = np.empty(max(need_q.value, qbuf.size * 2), np.uint8)
                offs = np.empty(max(need_r.value + 2, offs.size * 2),
                                np.int64)
                qoffs = np.empty(offs.size, np.int64)
                continue
            yield (buf[:offs[n]].copy(), offs[:n + 1].copy(),
                   qbuf[:qoffs[n]].copy(), qoffs[:n + 1].copy())
    finally:
        _close(lib, h)


def iter_reads_with_quals_native(path: str, chunk_size_reads: int
                                 ) -> Iterator[tuple[list[bytes],
                                                     list[bytes]]]:
    """(sequences, quality strings) list chunks."""
    for flat, offs, qflat, qoffs in iter_flat_with_quals_native(
            path, chunk_size_reads):
        yield _rows(flat, offs), _rows(qflat, qoffs)


def _rows(flat: np.ndarray, offs: np.ndarray) -> list[bytes]:
    data = flat.tobytes()
    o = offs.tolist()
    return [data[o[i]:o[i + 1]] for i in range(len(o) - 1)]
