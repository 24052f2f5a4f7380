"""ctypes bindings for the native k-mer count store (kmer_store.cpp): the
counterpart of mini_parallel_tpu/native/kmer_store.py on one int64 key (the
k-mer's 2-bit string) in place of the (hi, lo) int32 pair."""

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
    return lib


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
