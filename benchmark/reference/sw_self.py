"""Plain Smith-Waterman self-scores: each read aligned against itself.

The scoring the configuration states for ``--mode sw`` (the reference's
smith_waterman.cl:5-7): match +2, mismatch -1, linear gap -2, bytes compared
as they are (N against N is a match). A local score is the largest cell of
the DP, at least 0.

The DP runs in plain torch over anti-diagonals, on blocks of reads, on any
device. ``bits`` computes it with saturating integers of that width (every
add clamped into the signed range), the lower-precision control.
"""

from __future__ import annotations

import numpy as np
import torch

MATCH, MISMATCH, GAP = 2, -1, -2
PAD_A, PAD_B = 0xFE, 0xFF  # pads of the two sides: never equal to anything


def self_scores(seqs: np.ndarray, lens: np.ndarray | None = None,
                device: torch.device | str = "cpu", bits: int = 32,
                block: int = 65536) -> np.ndarray:
    """(R,) int64 best local score of each row of ``seqs`` (R, L) ASCII
    against itself; ``lens`` cuts rows shorter than L."""
    R, L = seqs.shape
    lens = np.full(R, L, np.int64) if lens is None else np.asarray(lens)
    out = np.empty(R, np.int64)
    for lo in range(0, R, block):
        hi = min(R, lo + block)
        a = torch.from_numpy(np.ascontiguousarray(seqs[lo:hi])).to(device)
        n = torch.from_numpy(lens[lo:hi]).to(device)
        col = torch.arange(L, device=device)[None, :]
        a = a.to(torch.int32)
        b = torch.where(col < n[:, None], a, PAD_B)
        a = torch.where(col < n[:, None], a, PAD_A)
        out[lo:hi] = _sw_best(a, b, bits).cpu().numpy()
    return out


def _sw_best(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Best local score of each pair of rows (a (B, M), b (B, N)), over
    the anti-diagonals d = i + j of the DP (vectors over the row i)."""
    B, M = a.shape
    N = b.shape[1]
    dev = a.device
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

    def sat(x):
        return x if bits >= 32 else x.clamp(lo, hi)

    i = torch.arange(M, device=dev)[None, :]
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    h1 = torch.zeros((B, M), dtype=torch.int32, device=dev)  # diagonal d-1
    h2 = torch.zeros((B, M), dtype=torch.int32, device=dev)  # diagonal d-2
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for d in range(M + N - 1):
        j = d - i
        inside = (j >= 0) & (j < N)
        bj = b.gather(1, j.clamp(0, N - 1).expand(B, M))
        s = torch.where(a == bj, MATCH, MISMATCH)
        diag = sat(torch.cat([zero_col, h2[:, :-1]], 1) + s)
        up = sat(torch.cat([zero_col, h1[:, :-1]], 1) + GAP)
        left = sat(h1 + GAP)
        h = torch.maximum(torch.maximum(diag, up), left).clamp_min(0)
        h = torch.where(inside, h, 0)
        best = torch.maximum(best, h.amax(1))
        h1, h2 = h, h1
    return best
