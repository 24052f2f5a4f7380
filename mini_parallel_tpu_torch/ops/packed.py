"""2-bit packed host->device transfer for read batches: the counterpart of
mini_parallel_tpu/ops/packed.py.

DNA is a 4-letter alphabet, so the host packs 4 bases per byte and the
device unpacks with shifts and selects, cutting host->device bytes 4x.

Bit-exactness contract: unpack reproduces the original padded uint8 batch
EXACTLY. Non-ACGT bytes (N calls, lowercase, IUPAC codes) ride in a per-row
exception list (column, original byte) applied by one scatter after the
unpack; positions past each row's length are refilled from the pad sentinel.

Layout: exceptions are (B, K) with K bucketed to a power of two; column ==
L marks an empty slot. Packing runs on the host: in one pass of the native
C++ packer (native/pack2bit.cpp) when its library builds and loads, else
in NumPy; both give the same PackedBatch, bit for bit. Per-base boolean
masks travel 8 to a byte (pack_bits / unpack_bits_device).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from mini_parallel_tpu_torch import native

# 2-bit codes for the packable alphabet (uppercase ACGT only: anything else
# must round-trip byte-exactly through the exception list).
_PACK_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _PACK_CODE[_ch] = _i
_A, _C, _G, _T = b"ACGT"

MIN_EXC_BUCKET = 1


@dataclasses.dataclass
class PackedBatch:
    """Host-side packed representation of a (B, L) uint8 read batch."""

    packed: np.ndarray  # (B, L // 4) uint8, 4 bases per byte, LSB-first
    exc_col: np.ndarray  # (B, K) int32, column of each non-ACGT byte; L = empty
    exc_val: np.ndarray  # (B, K) uint8, the original byte
    lengths: np.ndarray  # (B,) int32 valid prefix per row
    length: int  # L (static row width; multiple of 4)

    @property
    def batch(self) -> int:
        return self.packed.shape[0]

    def wire_bytes(self) -> int:
        """Host->device bytes of the batch: its four arrays."""
        return (self.packed.nbytes + self.exc_col.nbytes
                + self.exc_val.nbytes + self.lengths.nbytes)


def _exc_bucket(n: int) -> int:
    b = MIN_EXC_BUCKET
    while b < n:
        b <<= 1
    return b


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _packer() -> ctypes.CDLL:
    """The native packer's library (BuildError when it cannot be built or
    loaded)."""
    lib = native.load("pack2bit")
    lib.p2_pack.restype = ctypes.c_int64
    lib.p2_pack.argtypes = [_U8P, _I32P, ctypes.c_int64, ctypes.c_int64,
                            _U8P, _I32P]
    lib.p2_fill_exceptions.restype = None
    lib.p2_fill_exceptions.argtypes = [_U8P, _I32P, _I32P, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       _I32P, _U8P]
    return lib


@functools.lru_cache(maxsize=None)
def _native_lib() -> ctypes.CDLL | None:
    """The native packer, or None when it cannot be built (then NumPy
    packs); decided once per process."""
    try:
        return _packer()
    except native.BuildError:
        return None


def pack_batch(arr: np.ndarray, lengths: np.ndarray) -> PackedBatch:
    """Pack a padded (B, L) uint8 batch (L % 4 == 0) into 2-bit + exceptions.

    ``arr`` rows must be valid bytes for the first ``lengths[i]`` columns;
    the rest is pad, rebuilt from the pad sentinel at unpack time, so pad
    bytes never cost exceptions. The native packer runs when its library
    loads, NumPy otherwise (:func:`pack_batch_native`,
    :func:`pack_batch_numpy`).
    """
    if _native_lib() is not None:
        return pack_batch_native(arr, lengths)
    return pack_batch_numpy(arr, lengths)


def _check_width(arr: np.ndarray) -> tuple[int, int]:
    B, L = arr.shape
    if L % 4 != 0:
        raise ValueError(f"row width {L} not a multiple of 4")
    return B, L


def pack_batch_native(arr: np.ndarray, lengths: np.ndarray) -> PackedBatch:
    """:func:`pack_batch` in the native packer: one pass packs and counts
    each row's exceptions, a second fills the rows that have any."""
    lib = _packer()
    B, L = _check_width(arr)
    arr = np.ascontiguousarray(arr, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    if lengths.shape != (B,) or (B and (lengths.min() < 0
                                        or lengths.max() > L)):
        raise ValueError(f"lengths must be {B} values in [0, {L}]")
    packed = np.empty((B, L // 4), np.uint8)
    exc_counts = np.empty(B, np.int32)
    max_exc = int(lib.p2_pack(arr.ctypes.data_as(_U8P),
                              lengths.ctypes.data_as(_I32P), B, L,
                              packed.ctypes.data_as(_U8P),
                              exc_counts.ctypes.data_as(_I32P)))
    K = _exc_bucket(max_exc)
    exc_col = np.full((B, K), L, np.int32)
    exc_val = np.zeros((B, K), np.uint8)
    if max_exc:
        lib.p2_fill_exceptions(arr.ctypes.data_as(_U8P),
                               lengths.ctypes.data_as(_I32P),
                               exc_counts.ctypes.data_as(_I32P), B, L, K,
                               exc_col.ctypes.data_as(_I32P),
                               exc_val.ctypes.data_as(_U8P))
    return PackedBatch(packed=packed, exc_col=exc_col, exc_val=exc_val,
                       lengths=lengths, length=L)


def pack_batch_numpy(arr: np.ndarray, lengths: np.ndarray) -> PackedBatch:
    """:func:`pack_batch` in NumPy."""
    B, L = _check_width(arr)
    lengths = np.asarray(lengths, np.int32)
    codes = _PACK_CODE[arr]
    valid = np.arange(L, dtype=np.int32)[None, :] < lengths[:, None]
    bad = (codes == 255) & valid
    codes = np.where(codes == 255, 0, codes)
    packed = (
        codes[:, 0::4]
        | (codes[:, 1::4] << 2)
        | (codes[:, 2::4] << 4)
        | (codes[:, 3::4] << 6)
    ).astype(np.uint8)

    rows, cols = np.nonzero(bad)
    if rows.size:
        per_row = np.bincount(rows, minlength=B)
        K = _exc_bucket(int(per_row.max()))
        # slot index within the row: position among this row's exceptions
        # (np.nonzero is row-major, so each row's hits are contiguous)
        slot = np.arange(rows.size) - np.searchsorted(rows, rows)
        exc_col = np.full((B, K), L, np.int32)
        exc_val = np.zeros((B, K), np.uint8)
        exc_col[rows, slot] = cols.astype(np.int32)
        exc_val[rows, slot] = arr[rows, cols]
    else:
        K = MIN_EXC_BUCKET
        exc_col = np.full((B, K), L, np.int32)
        exc_val = np.zeros((B, K), np.uint8)
    return PackedBatch(packed=packed, exc_col=exc_col, exc_val=exc_val,
                       lengths=lengths, length=L)


def pad_rows(pb: PackedBatch, rows: int) -> PackedBatch:
    """Pad the batch to ``rows`` with empty (length-0) entries."""
    B = pb.batch
    if rows == B:
        return pb
    if rows < B:
        raise ValueError(f"cannot shrink batch {B} -> {rows}")
    add = rows - B
    return PackedBatch(
        packed=np.concatenate([pb.packed, np.zeros((add, pb.packed.shape[1]), np.uint8)]),
        exc_col=np.concatenate([pb.exc_col, np.full((add, pb.exc_col.shape[1]), pb.length, np.int32)]),
        exc_val=np.concatenate([pb.exc_val, np.zeros((add, pb.exc_val.shape[1]), np.uint8)]),
        lengths=np.concatenate([pb.lengths, np.zeros(add, np.int32)]),
        length=pb.length,
    )


def device_args(pb: PackedBatch, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The argument tuple for :func:`unpack_device`, on ``device``."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for x in (pb.packed, pb.exc_col, pb.exc_val, pb.lengths)
    )


def unpack_device(packed: torch.Tensor, exc_col: torch.Tensor,
                  exc_val: torch.Tensor, lengths: torch.Tensor,
                  pad_value: int) -> torch.Tensor:
    """Device-side inverse of pack_batch: -> (B, L) uint8, pad-filled.

    Shifts and selects, one ``scatter_`` for the exceptions (into a spare
    column L that swallows the empty slots, then cut off), and the pad
    refill past each row's length.
    """
    B, L4 = packed.shape
    L = L4 * 4
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32, device=packed.device)
    c = ((packed[:, :, None].to(torch.int32) >> shifts) & 3).reshape(B, L)
    base = torch.where(
        c == 0, _A, torch.where(c == 1, _C, torch.where(c == 2, _G, _T))
    ).to(torch.uint8)
    ascii_ = torch.cat(
        [base, torch.zeros((B, 1), dtype=torch.uint8, device=packed.device)],
        dim=1)
    ascii_.scatter_(1, exc_col.to(torch.int64), exc_val)
    pos = torch.arange(L, dtype=torch.int32, device=packed.device)[None, :]
    return torch.where(pos < lengths[:, None], ascii_[:, :L],
                       torch.tensor(pad_value, dtype=torch.uint8,
                                    device=packed.device))


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """(B, L) bool -> (B, ceil(L/8)) uint8, LSB-first (8x fewer wire
    bytes), for per-base boolean side-channels such as base-quality pass
    masks that ride along with 2-bit packed reads."""
    return np.packbits(mask, axis=1, bitorder="little")


def unpack_bits_device(packed_bits: torch.Tensor, L: int) -> torch.Tensor:
    """Device-side inverse of pack_bits: -> (B, L) bool."""
    B, L8 = packed_bits.shape
    shifts = torch.arange(8, dtype=torch.int32, device=packed_bits.device)
    bits = (packed_bits[:, :, None].to(torch.int32) >> shifts) & 1
    return bits.reshape(B, L8 * 8)[:, :L].to(torch.bool)
