"""ctypes bindings for the native k-mer count store and the drain codec's
plane decoder (kmer_store.cpp): the counterpart of
mini_parallel_tpu/native/kmer_store.py on one int64 key (the k-mer's 2-bit
string) in place of the (hi, lo) int32 pair."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from mini_parallel_tpu_torch import native

_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The store's library with its C signatures declared (BuildError when
    it cannot be built or loaded)."""
    lib = native.load("kmerstore")
    lib.ks_new.restype = ctypes.c_void_p
    lib.ks_new.argtypes = [ctypes.c_uint64]
    lib.ks_free.restype = None
    lib.ks_free.argtypes = [ctypes.c_void_p]
    lib.ks_merge.restype = None
    lib.ks_merge.argtypes = [ctypes.c_void_p, _I64P, _I64P, ctypes.c_int64]
    lib.ks_size.restype = ctypes.c_uint64
    lib.ks_size.argtypes = [ctypes.c_void_p]
    lib.ks_total.restype = ctypes.c_uint64
    lib.ks_total.argtypes = [ctypes.c_void_p]
    lib.ks_get.restype = ctypes.c_uint64
    lib.ks_get.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ks_dump.restype = ctypes.c_uint64
    lib.ks_dump.argtypes = [ctypes.c_void_p, _I64P, _I64P, ctypes.c_uint64]
    lib.ks_decode_planes.restype = None
    lib.ks_decode_planes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_uint64, _I64P, _I64P]
    return lib


def decode_planes_native(planes: np.ndarray, m: int, kp: int, cp: int,
                         key0: int) -> tuple[np.ndarray, np.ndarray]:
    """One C++ pass over the drain codec's byte planes (ops/kmer.py:
    plane_pack) -> (keys, counts), both int64. ``planes`` holds kp + cp
    rows of m bytes; ``key0`` is the first key. BuildError when the
    library cannot be built or loaded."""
    planes = np.ascontiguousarray(planes, np.uint8).reshape(-1)
    if planes.size != (kp + cp) * m or not 1 <= kp <= 8 or not 0 <= cp <= 8:
        raise ValueError(f"{planes.size} plane bytes do not hold {m} keys "
                         f"of kp={kp}, cp={cp}")
    keys = np.empty(m, np.int64)
    counts = np.empty(m, np.int64)
    load().ks_decode_planes(
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m, kp, cp,
        key0 & ((1 << 64) - 1), keys.ctypes.data_as(_I64P),
        counts.ctypes.data_as(_I64P))
    return keys, counts


class KmerStore:
    """Flat linear-probing (key -> count) aggregator in native memory."""

    def __init__(self, initial_capacity: int = 1 << 16):
        self._lib = load()
        self._h = self._lib.ks_new(initial_capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ks_free(self._h)
            self._h = None

    def merge(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Add ``counts[i]`` to ``keys[i]``; entries with a count <= 0 are
        padding and skipped."""
        keys = np.ascontiguousarray(keys, np.int64)
        counts = np.ascontiguousarray(counts, np.int64)
        if keys.shape != counts.shape or keys.ndim != 1:
            raise ValueError(f"keys {keys.shape} and counts {counts.shape} "
                             "must be 1-D and of one length")
        self._lib.ks_merge(self._h, keys.ctypes.data_as(_I64P),
                           counts.ctypes.data_as(_I64P), keys.size)

    def __len__(self) -> int:
        return int(self._lib.ks_size(self._h))

    def total(self) -> int:
        return int(self._lib.ks_total(self._h))

    def get(self, key: int) -> int:
        return int(self._lib.ks_get(self._h, key))

    def items_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys, counts) int64 arrays of every entry, in table order: one
        C++ pass, no Python objects per entry."""
        n = len(self)
        keys = np.empty(n, np.int64)
        counts = np.empty(n, np.int64)
        w = int(self._lib.ks_dump(self._h, keys.ctypes.data_as(_I64P),
                                  counts.ctypes.data_as(_I64P), n))
        return keys[:w], counts[:w]

    def items(self) -> dict:
        keys, counts = self.items_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))
