"""DNA sequence encoding for device tensors: the host (NumPy) part of
mini_parallel_tpu/ops/encode.py.

Reads stay raw uint8 ASCII, as the reference ships them
(`smith_waterman/src/aligner.rs:411-412`). The two sides of an alignment
are padded with two *different* sentinels, both different from every real
base, so padded positions always mismatch (see ops/sw.py for why that
cannot change a local-alignment maximum).
"""

from __future__ import annotations

import numpy as np

PAD_A = np.uint8(0xFE)
PAD_B = np.uint8(0xFF)


def seq_to_bytes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> 1-D uint8 NumPy array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8).copy()


def pad_batch(
    seqs: list[str | bytes], pad_to: int | None = None, pad_value: int = PAD_A
) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of sequences into a (B, L) uint8 array + (B,) int32 lengths.

    ``pad_to`` rounds L up to a static bucket shared across chunks.
    """
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    max_len = int(lengths.max()) if len(seqs) else 0
    L = max(max_len, 1) if pad_to is None else pad_to
    if max_len > L:
        raise ValueError(f"sequence length {max_len} exceeds pad_to={L}")
    out = np.full((len(seqs), L), pad_value, dtype=np.uint8)
    for i, s in enumerate(seqs):
        b = s if isinstance(s, np.ndarray) else seq_to_bytes(s)
        out[i, : len(b)] = b
    return out, lengths


def pad_batch_flat(
    flat: np.ndarray,
    offs: np.ndarray,
    pad_to: int | None = None,
    pad_value: int = PAD_A,
    rows_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """pad_batch over a flat (bytes, offsets) chunk — no per-read objects.

    ``flat``/``offs`` follow the io.fastq.iter_flat_chunks contract
    (offs[0] == 0, offs[-1] == flat.size). Uniform-length batches take a
    single reshape-copy; ragged batches one vectorized scatter. Output is
    bit-identical to pad_batch over the equivalent list[bytes].

    ``rows_to`` pads the ROW count up with all-pad zero-length rows, which
    score 0 by the sentinel contract.
    """
    offs = np.asarray(offs, np.int64)
    if offs.size and (offs[0] != 0 or offs[-1] != flat.size):
        raise ValueError(
            f"offs must span flat exactly (offs[0]={offs[0]}, "
            f"offs[-1]={offs[-1]}, flat.size={flat.size})"
        )
    lengths = np.diff(offs).astype(np.int32)
    B = lengths.size
    max_len = int(lengths.max()) if B else 0
    L = max(max_len, 1) if pad_to is None else pad_to
    if max_len > L:
        raise ValueError(f"sequence length {max_len} exceeds pad_to={L}")
    Bp = B if rows_to is None else max(rows_to, B)
    out = np.full((Bp, L), pad_value, dtype=np.uint8)
    if Bp != B:
        lengths = np.concatenate([lengths, np.zeros(Bp - B, np.int32)])
    if B == 0 or flat.size == 0:
        return out, lengths
    if max_len == int(lengths[:B].min()):
        out[:B, :max_len] = flat.reshape(B, max_len)
        return out, lengths
    rows = np.repeat(np.arange(B, dtype=np.int64), lengths[:B])
    cols = np.arange(flat.size, dtype=np.int64) - np.repeat(offs[:-1],
                                                            lengths[:B])
    out[rows, cols] = flat
    return out, lengths
