"""DNA sequence encoding: the counterpart of mini_parallel_tpu/ops/encode.py.

Reads stay raw uint8 ASCII, as the reference ships them
(`smith_waterman/src/aligner.rs:411-412`). The two sides of an alignment
are padded with two *different* sentinels, both different from every real
base, so padded positions always mismatch (see ops/sw.py for why that
cannot change a local-alignment maximum).

Host side (NumPy): padding. Tensor side (torch, on the tensor's device):
the code alphabet and the complement/reverse-complement ops.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_A = np.uint8(0xFE)
PAD_B = np.uint8(0xFF)

# Code alphabet (A=0 C=1 G=2 T=3, N/other=4) and its code-space pads.
CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4
CODE_PAD_A = np.uint8(5)
CODE_PAD_B = np.uint8(6)

_ASCII_TO_CODE = np.full(256, CODE_N, dtype=np.uint8)
for _ch, _code in (("A", CODE_A), ("C", CODE_C), ("G", CODE_G), ("T", CODE_T)):
    _ASCII_TO_CODE[ord(_ch)] = _code
    _ASCII_TO_CODE[ord(_ch.lower())] = _code
_ASCII_TO_CODE[PAD_A] = CODE_PAD_A
_ASCII_TO_CODE[PAD_B] = CODE_PAD_B

# DNA complement on ASCII bytes (A<->T, C<->G, case-preserving; everything
# else, N included, maps to itself).
_ASCII_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _x, _y in (("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")):
    _ASCII_COMPLEMENT[ord(_x)] = ord(_y)
    _ASCII_COMPLEMENT[ord(_y)] = ord(_x)

# Complement in code space: 3 - code for ACGT; N and pads map to themselves.
_CODE_COMPLEMENT = np.array([3, 2, 1, 0, CODE_N, CODE_PAD_A, CODE_PAD_B],
                            dtype=np.uint8)


def _lookup(table: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(table).to(x.device)[x.long()]


def ascii_to_code(ascii_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ASCII -> dense code (A=0 C=1 G=2 T=3, N=4, pads=5/6)."""
    return _lookup(_ASCII_TO_CODE, ascii_u8)


def complement_ascii(ascii_u8: torch.Tensor) -> torch.Tensor:
    """Base-complement ASCII bytes (A<->T, C<->G), elementwise."""
    return _lookup(_ASCII_COMPLEMENT, ascii_u8)


def complement_code(codes: torch.Tensor) -> torch.Tensor:
    """Base-complement in code space."""
    return _lookup(_CODE_COMPLEMENT, codes)


def reverse_complement_ascii(ascii_u8: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Reverse-complement along ``axis`` (pads travel to the front)."""
    return complement_ascii(ascii_u8).flip(axis)


def revcomp_padded(reads: torch.Tensor, lengths: torch.Tensor,
                   pad_value: int) -> torch.Tensor:
    """Reverse-complement each row's valid prefix of a padded (B, L) batch.

    Pads stay pads and stay at the END of each row: complement the valid
    bytes, flip the whole row, then roll each row left by its pad width.
    Equivalent to host-side ``r.translate(comp)[::-1]`` re-padded.
    """
    L = reads.shape[1]
    if L == 0:
        return reads.clone()
    rc = torch.where(reads == pad_value, reads, complement_ascii(reads))
    flipped = rc.flip(1)
    # per-row roll by (len - L) mod L: out[i] = flipped[(i - shift) mod L]
    shift = (lengths.to(torch.int64) - L) % L
    pos = torch.arange(L, dtype=torch.int64, device=reads.device)[None, :]
    return flipped.gather(1, (pos - shift[:, None]) % L)


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
