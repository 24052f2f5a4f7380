"""True Smith-Waterman local alignment: the counterpart of
mini_parallel_tpu/ops/sw.py (linear gaps).

    H[i,j] = max(0, H[i-1,j-1] + s(a_i, b_j), H[i-1,j] + GAP, H[i,j-1] + GAP)
    score  = max_{i,j} H[i,j]

Padding contract: pad ``a`` with encode.PAD_A and ``b`` with encode.PAD_B
(distinct sentinels). Pad positions always mismatch, and every DP move into
a pad cell strictly decreases H (mismatch -1 or gap -2) while H >= 0
everywhere, so the max over the padded matrix equals the max over the
valid submatrix: ragged lengths need no masking.

Layers:
  - :func:`sw_score_numpy` — O(mn) NumPy golden, used only in tests.
  - :func:`sw_score_batch` — the plain PyTorch version: an anti-diagonal
    loop over (B, M) int32 tensors. CPU tensors run it; the CUDA kernel
    (ops/sw_cuda.py) is held against it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from mini_parallel_tpu_torch.ops.encode import PAD_A, PAD_B, pad_batch

MATCH_SCORE = 2  # smith_waterman.cl:5
MISMATCH_PENALTY = -1  # smith_waterman.cl:6
GAP_PENALTY = -2  # smith_waterman.cl:7


def sw_score_numpy(a, b, match=MATCH_SCORE, mismatch=MISMATCH_PENALTY,
                   gap=GAP_PENALTY) -> int:
    """Golden quadratic DP (host-only, tests)."""
    if isinstance(a, str):
        a = a.encode("ascii")
    if isinstance(b, str):
        b = b.encode("ascii")
    a = np.frombuffer(bytes(a), dtype=np.uint8)
    b = np.frombuffer(bytes(b), dtype=np.uint8)
    m, n = len(a), len(b)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, H[i - 1, j] + gap,
                          H[i, j - 1] + gap)
            best = max(best, H[i, j])
    return int(best)


def sw_score_batch(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    """Batched SW scores via an anti-diagonal loop (the plain version).

    seq_a: (B, M) uint8 padded with PAD_A; seq_b: (B, N) uint8 padded with
    PAD_B. Returns (B,) int32. Diagonal d = i + j holds cells (i, d - i) for
    the M rows; it depends only on diagonals d-1 and d-2, carried as (B, M)
    int32 tensors. The window w[i] = b[d - i] is a slice of the reversed,
    PAD_B-extended b row, so each step is a handful of elementwise ops.
    """
    B, M = seq_a.shape
    N = seq_b.shape[1]
    dev = seq_a.device
    if B == 0 or M == 0 or N == 0:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    a = seq_a.to(torch.int32)
    # bp[k] = b[k - (M-1)], PAD_B outside; reversed so that the window of
    # diagonal d, w[i] = bp[d + M-1 - i], is the slice rev[W-M-d : W-d]
    bp = torch.cat(
        [
            torch.full((B, M - 1), int(PAD_B), dtype=torch.int32, device=dev),
            seq_b.to(torch.int32),
            torch.full((B, M), int(PAD_B), dtype=torch.int32, device=dev),
        ],
        dim=1,
    )
    rev = bp.flip(1)
    W = rev.shape[1]
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    d1 = torch.zeros((B, M), dtype=torch.int32, device=dev)  # D_{d-1}
    d2 = torch.zeros((B, M), dtype=torch.int32, device=dev)  # D_{d-2}
    best = torch.zeros((B, M), dtype=torch.int32, device=dev)
    for d in range(M + N - 1):
        w = rev[:, W - M - d: W - d]
        s = (a == w).to(torch.int32) * (MATCH_SCORE - MISMATCH_PENALTY) \
            + MISMATCH_PENALTY
        # shift_down(x)[i] = x[i-1], with H[-1, *] = 0
        cand = torch.clamp_min(torch.cat([zcol, d2[:, :-1]], dim=1) + s, 0)
        up = torch.cat([zcol, d1[:, :-1]], dim=1)
        cand = torch.maximum(cand, torch.maximum(up, d1) + GAP_PENALTY)
        best = torch.maximum(best, cand)
        d1, d2 = cand, d1
    return best.amax(dim=1)


def sw_score_pair(a: str | bytes, b: str | bytes,
                  device: torch.device) -> int:
    """Single-pair SW score through the batched path on ``device``."""
    from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_best

    arr_a, _ = pad_batch([a], pad_value=int(PAD_A))
    arr_b, _ = pad_batch([b], pad_value=int(PAD_B))
    return int(sw_score_batch_best(torch.from_numpy(arr_a).to(device),
                                   torch.from_numpy(arr_b).to(device))[0])
