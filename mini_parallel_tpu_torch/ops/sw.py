"""True Smith-Waterman local alignment: the counterpart of
mini_parallel_tpu/ops/sw.py (linear and affine gaps).

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
  - :func:`sw_affine_numpy` / :func:`sw_affine_batch` — the same two
    layers for affine gaps (Gotoh); the affine CUDA kernel is held
    against :func:`sw_affine_batch`.
  - :func:`sw_vs_ref_batch` — every read against one shared reference,
    with the smallest end of the best cell (the ``--rescue`` mapper); the
    vs-reference CUDA kernel is held against it. :func:`sweep_segments`
    reaches the same result by the kernel's segment split (tests).
"""

from __future__ import annotations

import numpy as np
import torch

from mini_parallel_tpu_torch.ops.encode import PAD_A, PAD_B, pad_batch

MATCH_SCORE = 2  # smith_waterman.cl:5
MISMATCH_PENALTY = -1  # smith_waterman.cl:6
GAP_PENALTY = -2  # smith_waterman.cl:7
# reads x reference cells that one step of the plain sw_vs_ref_batch holds
VS_REF_BLOCK_CELLS = 1 << 26
INT32_MAX = (1 << 31) - 1


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


def sw_vs_ref_batch(reads: torch.Tensor, ref: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every read against ONE shared reference (the plain version of
    csrc/sw_vs_ref.cu; the counterpart of the JAX package's
    ``sw_vs_ref_batch_pallas``).

    reads: (B, M) uint8 padded with PAD_A; ref: (N,) uint8. Returns
    (scores (B,) int32, ends (B,) int32): the best linear-gap SW score of
    each read and the smallest 0-based reference index of any cell at that
    score, -1 when the score is 0. Rows that are all pad score 0 against
    anything and are not swept.

    The sweep runs down the read's rows, each row a vector over the whole
    reference: with X[j] = max(0, diag, up), the gap along the row makes
    H[i, j] = max_{k <= j} (X[k] - 2 (j - k)) = cummax(X[k] + 2k) - 2j.
    So a read costs M steps however long the reference is. The swept reads
    go in blocks of at most VS_REF_BLOCK_CELLS reads x reference cells a
    step, which bounds the memory against a genome-length reference.
    """
    B, M = reads.shape
    N = ref.shape[0]
    dev = reads.device
    scores = torch.zeros(B, dtype=torch.int32, device=dev)
    ends = torch.full((B,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero((reads != int(PAD_A)).any(dim=1)).flatten()
    if live.numel() == 0 or M == 0 or N == 0:
        return scores, ends
    per_block = max(1, VS_REF_BLOCK_CELLS // N)
    for k in range(0, live.numel(), per_block):
        rows = live[k:k + per_block]
        scores[rows], ends[rows] = _vs_ref_rows(reads[rows], ref)
    return scores, ends


def sweep_segments(reads: torch.Tensor, ref: torch.Tensor, segment: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain mirror of csrc/sw_vs_ref.cu's segment decomposition
    (its ``sweep_segment``), used by tests: the same result as
    :func:`sw_vs_ref_batch`, reached the kernel's way.

    The reference is cut into segments of ``segment`` columns. The segment
    owning [s, e) runs the DP on ref[c0:e], c0 = max(0, s - 2M), from a
    zero edge, and reports only its own columns: (max score, smallest
    end). The segments of a read meet in the 64-bit key
    (score << 32) | (2^31 - 1 - end), reduced by max and decoded by
    :func:`decode_vs_ref_keys`."""
    if segment <= 0:
        raise ValueError(f"segment width {segment} must be positive")
    B, M = reads.shape
    N = ref.shape[0]
    keys = torch.zeros(B, dtype=torch.int64, device=reads.device)
    live = torch.nonzero((reads != int(PAD_A)).any(dim=1)).flatten()
    if live.numel() and M and N:
        a = reads[live]
        for s in range(0, N, segment):
            e = min(s + segment, N)
            c0 = max(0, s - 2 * M)
            score, end = _vs_ref_rows(a, ref[c0:e], own=s - c0)
            key = (score.to(torch.int64) << 32) | (INT32_MAX - c0 - end)
            keys[live] = torch.maximum(keys[live],
                                       torch.where(score > 0, key, 0))
    return decode_vs_ref_keys(keys)


def decode_vs_ref_keys(keys: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) int64 keys (score << 32) | (2^31 - 1 - end), 0 for no cell
    above 0 -> (scores (B,) int32, ends (B,) int32, -1 at score 0)."""
    scores = (keys >> 32).to(torch.int32)
    ends = torch.where(scores > 0, INT32_MAX - (keys & 0xFFFFFFFF), -1)
    return scores, ends.to(torch.int32)


def _vs_ref_rows(a: torch.Tensor, ref: torch.Tensor, own: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """sw_vs_ref_batch's sweep of reads that are not all pad; the best
    and its smallest end are taken over the columns >= ``own`` only."""
    Bl, M = a.shape
    N = ref.shape[0]
    dev = a.device
    ramp = 2 * torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    col = torch.arange(own, N, dtype=torch.int64, device=dev)[None, :]
    prev = torch.zeros((Bl, N), dtype=torch.int64, device=dev)  # H[i-1, :]
    zcol = torch.zeros((Bl, 1), dtype=torch.int64, device=dev)
    best = torch.zeros(Bl, dtype=torch.int64, device=dev)
    end = torch.zeros(Bl, dtype=torch.int64, device=dev)
    for i in range(M):
        s = torch.where(a[:, i:i + 1] == ref[None, :], MATCH_SCORE,
                        MISMATCH_PENALTY)
        diag = torch.cat([zcol, prev[:, :-1]], dim=1) + s
        x = torch.clamp_min(torch.maximum(diag, prev + GAP_PENALTY), 0)
        h = torch.cummax(x + ramp, dim=1).values - ramp
        mine = h[:, own:]
        row_max = mine.amax(dim=1)
        first = torch.where(mine == row_max[:, None], col, N).amin(dim=1)
        end = torch.where(row_max > best, first,
                          torch.where(row_max == best,
                                      torch.minimum(end, first), end))
        best = torch.maximum(best, row_max)
        prev = h
    return (best.to(torch.int32),
            torch.where(best > 0, end, -1).to(torch.int32))


def sw_score_pair(a: str | bytes, b: str | bytes,
                  device: torch.device) -> int:
    """Single-pair SW score through the batched path on ``device``."""
    from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_best

    return int(sw_score_batch_best(*pair_tensors(a, b, device))[0])


def pair_tensors(a: str | bytes, b: str | bytes,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """One pair as a B = 1 batch on ``device``: a PAD_A-, b PAD_B-padded."""
    arr_a, _ = pad_batch([a], pad_value=int(PAD_A))
    arr_b, _ = pad_batch([b], pad_value=int(PAD_B))
    return (torch.from_numpy(arr_a).to(device),
            torch.from_numpy(arr_b).to(device))


# ---------------------------------------------------------------------------
# Affine-gap local alignment (Gotoh). A gap of length L costs
# gap_open + L * gap_extend; with gap_open=0, gap_extend=GAP_PENALTY this
# reduces exactly to the linear-gap DP above.
# ---------------------------------------------------------------------------

GAP_OPEN = -2
GAP_EXTEND = -1
# Sentinel of an empty gap state. H >= 0 everywhere, so max(NEG, H + open)
# discards it at the first step and no sum ever builds on it.
NEG = -(2**24)


def sw_affine_numpy(a, b, match=MATCH_SCORE, mismatch=MISMATCH_PENALTY,
                    gap_open=GAP_OPEN, gap_extend=GAP_EXTEND) -> int:
    """Golden Gotoh DP (host-only, tests)."""
    if isinstance(a, str):
        a = a.encode("ascii")
    if isinstance(b, str):
        b = b.encode("ascii")
    a = np.frombuffer(bytes(a), dtype=np.uint8)
    b = np.frombuffer(bytes(b), dtype=np.uint8)
    m, n = len(a), len(b)
    neg = -(10**9)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), neg, dtype=np.int64)  # gap in a (along j)
    F = np.full((m + 1, n + 1), neg, dtype=np.int64)  # gap in b (along i)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(E[i, j - 1], H[i, j - 1] + gap_open) + gap_extend
            F[i, j] = max(F[i - 1, j], H[i - 1, j] + gap_open) + gap_extend
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)


def sw_affine_batch(seq_a: torch.Tensor, seq_b: torch.Tensor,
                    gap_open: int = GAP_OPEN,
                    gap_extend: int = GAP_EXTEND) -> torch.Tensor:
    """Batched affine-gap SW scores via an anti-diagonal loop (the plain
    version; same layout contract as :func:`sw_score_batch`).

    Carries H of diagonals d-1 and d-2 and E, F of diagonal d-1 as (B, M)
    int32 tensors: E[i,j] (gap along j) reads E and H of cell (i, j-1),
    the same index on diagonal d-1; F[i,j] (gap along i) reads cell
    (i-1, j), the shifted index. Empty gap states hold the sentinel NEG.
    """
    B, M = seq_a.shape
    N = seq_b.shape[1]
    dev = seq_a.device
    if B == 0 or M == 0 or N == 0:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    a = seq_a.to(torch.int32)
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
    ncol = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    h1 = torch.zeros((B, M), dtype=torch.int32, device=dev)  # H_{d-1}
    h2 = torch.zeros((B, M), dtype=torch.int32, device=dev)  # H_{d-2}
    e1 = torch.full((B, M), NEG, dtype=torch.int32, device=dev)  # E_{d-1}
    f1 = torch.full((B, M), NEG, dtype=torch.int32, device=dev)  # F_{d-1}
    best = torch.zeros((B, M), dtype=torch.int32, device=dev)
    for d in range(M + N - 1):
        w = rev[:, W - M - d: W - d]
        s = (a == w).to(torch.int32) * (MATCH_SCORE - MISMATCH_PENALTY) \
            + MISMATCH_PENALTY
        e = torch.maximum(e1, h1 + gap_open) + gap_extend
        f = torch.maximum(torch.cat([ncol, f1[:, :-1]], dim=1),
                          torch.cat([zcol, h1[:, :-1]], dim=1) + gap_open) \
            + gap_extend
        h = torch.clamp_min(torch.cat([zcol, h2[:, :-1]], dim=1) + s, 0)
        h = torch.maximum(h, torch.maximum(e, f))
        best = torch.maximum(best, h)
        h1, h2, e1, f1 = h, h1, e, f
    return best.amax(dim=1)
