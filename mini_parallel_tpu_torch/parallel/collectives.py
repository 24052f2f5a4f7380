"""Merges of per-shard results: the counterpart of
mini_parallel_tpu/parallel/collectives.py.

Where the JAX package's ``psum`` / ``pmax`` / ``all_gather`` cross the
devices of a ``shard_map``, the port holds one tensor per shard, each on
its shard's device, and folds them on the first shard's device (the mesh's
first device) in shard order. Integer sums and maxima are exact in any
order; the Kadane fold is ordered, left to right.

Reference equivalents being replaced:
- ``total_score += score`` per chunk (`aligner.rs:276`)  -> merge_scores
- ``atomic_max(result, ...)`` (`smith_waterman.cl:69`)   -> merge_max
- k-mer histogram merge                                  -> merge_histogram
- long-sequence Kadane across shards                     -> kadane fold of
  the per-shard 4-tuple summaries (4 scalars per row cross devices)
"""

from __future__ import annotations

import functools

import torch

from mini_parallel_tpu_torch.ops.kadane import (
    KadaneSummary,
    kadane_combine,
    kadane_summary,
)


def _gathered(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard's tensor on the first shard's device, in shard order."""
    if not parts:
        raise ValueError("no shards to merge")
    dev = parts[0].device
    return [p.to(dev, non_blocking=True) for p in parts]


def merge_scores(parts: list[torch.Tensor]) -> torch.Tensor:
    """Sum of the shards' values (the JAX package's psum)."""
    return functools.reduce(torch.add, _gathered(parts))


def merge_max(parts: list[torch.Tensor]) -> torch.Tensor:
    """Elementwise maximum of the shards' values (pmax)."""
    return functools.reduce(torch.maximum, _gathered(parts))


def concat_rows(parts: list[torch.Tensor]) -> torch.Tensor:
    """The shards' row blocks joined in shard order (all_gather of a
    sharded batch axis); one shard's block is returned as it is."""
    gathered = _gathered(parts)
    return gathered[0] if len(gathered) == 1 else torch.cat(gathered)


def merge_histogram(parts: list[torch.Tensor]) -> torch.Tensor:
    """Sum of the shards' histograms (psum of bucket counts)."""
    return merge_scores(parts)


def kadane_merge_over_axis(summaries: list[KadaneSummary]) -> torch.Tensor:
    """Merge per-shard Kadane summaries in shard order: shard i holds the
    i-th contiguous segment. Returns the global ``best``."""
    moved = [KadaneSummary(*_gathered(list(s))) for s in summaries]
    return functools.reduce(kadane_combine, moved).best


def sequence_parallel_kadane(scores: list[torch.Tensor],
                             valid: list[torch.Tensor]) -> torch.Tensor:
    """Exact contiguous Kadane over a sequence split into contiguous
    (..., L_shard) segments, one per shard, in position order."""
    return kadane_merge_over_axis(
        [kadane_summary(s, v) for s, v in zip(scores, valid)])
