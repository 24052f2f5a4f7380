"""Parity-mode "alignment" scoring: the reference kernel's exact semantics,
the counterpart of mini_parallel_tpu/ops/kadane.py.

The reference's live kernel (`smith_waterman/src/smith_waterman.cl:11-71`)
scores position-wise equality (+2 / -1) and runs a Kadane max-subarray per
work item over a *strided* subsequence (smith_waterman.cl:26-39). Whenever
``len <= group_size * max_groups`` — always, in practice — each work item
sees at most one position, so the score degenerates to::

    2 if any(seq1[i] == seq2[i] for i < min(len1, len2)) else 0

- :func:`reference_align_score` — bit-exact NumPy emulation of the general
  strided dispatch (any length), the golden for parity tests.
- :func:`kadane_score_batch` — the batched device path for the degenerate
  regime, in torch. It is elementwise work plus one reduction; no kernel.
- :func:`kadane_contiguous_batch` — ``contiguous`` mode: the true
  contiguous Kadane score through the segment monoid, in torch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MATCH_SCORE = 2  # smith_waterman.cl:5
MISMATCH_PENALTY = -1  # smith_waterman.cl:6

WORK_GROUP_SIZE = 1024  # gpu.rs:9  (GPU_WORK_GROUP_SIZE)
MAX_WORK_GROUPS = 1_000_000  # gpu.rs:10 (GPU_MAX_WORK_GROUPS)


def _kadane_max(scores: np.ndarray) -> int:
    """max(0, max subarray sum) — smith_waterman.cl:50-51 per work item."""
    best = 0
    cur = 0
    for s in scores:
        cur = max(cur + int(s), 0)
        best = max(best, cur)
    return best


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    return np.asarray(seq, dtype=np.uint8)


def reference_align_score(
    seq1: bytes | str | np.ndarray,
    seq2: bytes | str | np.ndarray,
    work_group_size: int = WORK_GROUP_SIZE,
    max_work_groups: int = MAX_WORK_GROUPS,
) -> int:
    """Bit-exact emulation of ``gpu_align`` (aligner.rs:410) + the live kernel.

    NumPy, host-only; the parity golden. Handles the general strided
    regime (arbitrarily long sequences), not just the degenerate case.
    """
    a = _as_u8(seq1)
    b = _as_u8(seq2)
    n = min(a.size, b.size)
    if n == 0:
        return 0  # aligner.rs:414-416
    scores = np.where(a[:n] == b[:n], MATCH_SCORE, MISMATCH_PENALTY).astype(np.int64)

    num_groups = min(-(-n // work_group_size), max_work_groups)
    chunk = -(-n // num_groups)  # smith_waterman.cl:26
    best = 0
    for g in range(num_groups):
        start = g * chunk
        end = min(start + chunk, n)  # smith_waterman.cl:27-28
        if start >= n:
            break
        for lid in range(work_group_size):
            idx = np.arange(start + lid, end, work_group_size)
            if idx.size == 0:
                continue
            best = max(best, _kadane_max(scores[idx]))
    return best


def degenerate_regime(length: int, work_group_size: int = WORK_GROUP_SIZE,
                      max_work_groups: int = MAX_WORK_GROUPS) -> bool:
    """True when every work item sees <=1 position (chunk <= group_size),
    i.e. len <= wgs * max_groups (1.024e9 with the reference constants)."""
    return -(-length // work_group_size) <= max_work_groups


def kadane_score_batch(seq_a: torch.Tensor, seq_b: torch.Tensor,
                       len_a: torch.Tensor, len_b: torch.Tensor) -> torch.Tensor:
    """Batched parity score in the degenerate regime.

    seq_a, seq_b: (B, L) uint8 (pads must be non-equal sentinels);
    len_a, len_b: (B,) int32 true lengths. Returns (B,) int32: 2 where any
    position i < min(len_a, len_b) matches, else 0.
    """
    n = torch.minimum(len_a, len_b)[:, None]  # aligner.rs:413
    pos = torch.arange(seq_a.shape[1], dtype=torch.int32,
                       device=seq_a.device)[None, :]
    hit = (seq_a == seq_b) & (pos < n)
    return hit.any(dim=1).to(torch.int32) * MATCH_SCORE


# ---------------------------------------------------------------------------
# Contiguous Kadane (the intended algorithm) as an associative monoid: the
# segment summaries combine exactly, so a sequence split anywhere (within a
# device, or across devices) merges to the same score.
# ---------------------------------------------------------------------------


class KadaneSummary(NamedTuple):
    """Segment summary for max-subarray: the classic 4-tuple monoid."""

    total: torch.Tensor  # sum of segment
    best: torch.Tensor  # best subarray sum within segment (>= 0 here)
    prefix: torch.Tensor  # best prefix sum (>= 0: the empty prefix)
    suffix: torch.Tensor  # best suffix sum (>= 0: the empty suffix)


def kadane_combine(l: KadaneSummary, r: KadaneSummary) -> KadaneSummary:
    """Associative merge of two adjacent segment summaries."""
    return KadaneSummary(
        total=l.total + r.total,
        best=torch.maximum(torch.maximum(l.best, r.best), l.suffix + r.prefix),
        prefix=torch.maximum(l.prefix, l.total + r.prefix),
        suffix=torch.maximum(r.suffix, r.total + l.suffix),
    )


def kadane_summary(scores: torch.Tensor, valid: torch.Tensor) -> KadaneSummary:
    """Summarize a (..., L) score segment; invalid positions contribute 0.

    The JAX package's two sequential scans become cumulative ops over the
    prefix sums P (P[-1] = 0): the best run ending at k is
    P[k] - min(0, min_{m<=k} P[m]), the best prefix is max(0, max P), and
    the best suffix is total - min(0, min_{m<L-1} P[m]). Every value is an
    exact integer; sums run in int64 and return as int32.
    """
    s = torch.where(valid, scores, 0).to(torch.int64)
    L = s.shape[-1]
    zeros = s.new_zeros(s.shape[:-1])
    if L == 0:
        z = zeros.to(torch.int32)
        return KadaneSummary(total=z, best=z, prefix=z, suffix=z)
    p = torch.cumsum(s, dim=-1)
    total = p[..., -1]
    low = torch.clamp_max(torch.cummin(p, dim=-1).values, 0)
    best = (p - low).amax(dim=-1)
    prefix = torch.clamp_min(p.amax(dim=-1), 0)
    before_last = torch.clamp_max(
        p[..., :-1].amin(dim=-1) if L > 1 else zeros, 0)
    suffix = torch.clamp_min(total - before_last, 0)
    return KadaneSummary(*(x.to(torch.int32)
                           for x in (total, best, prefix, suffix)))


def kadane_contiguous_batch(seq_a: torch.Tensor, seq_b: torch.Tensor,
                            len_a: torch.Tensor, len_b: torch.Tensor
                            ) -> torch.Tensor:
    """True contiguous Kadane max-run score over position-wise +2/-1,
    batched: the score a *single* work item scanning the whole sequence
    would produce (smith_waterman.cl:49, before the striding scatters it).
    Returns (B,) int32."""
    n = torch.minimum(len_a, len_b)[:, None]
    pos = torch.arange(seq_a.shape[1], dtype=torch.int32,
                       device=seq_a.device)[None, :]
    scores = torch.where(seq_a == seq_b, MATCH_SCORE, MISMATCH_PENALTY)
    return kadane_summary(scores, pos < n).best
