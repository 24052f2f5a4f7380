"""The sharded WGS step: the counterpart of
mini_parallel_tpu/parallel/pipeline.py.

One call consumes a (B, L) read batch split over the ``data`` axis of a
mesh and produces globally merged statistics, under the JAX package's keys:

- ``parity_score``: parity alignment score sum (reference --full-wgs
  accounting),
- ``sw_score_sum`` / ``sw_score_max``: true-SW mate-pair r1 x r2 scores,
- ``pairs`` / ``complementary_pairs``: complementarity (README.md:15-16),
- ``base_hist``: base composition of reads_a (A C G T N),
- ``kmer_hist``: a bucketed k = 21 histogram of reads_a (the mergeable
  k-mer summary; exact counts live in models/kmer_model.py),
- ``bases``: the valid bases of reads_a.

Each shard runs :func:`_local_wgs_step` on its rows and device (the SW
scores through ``csrc/sw_score.cu`` on the card); the statistics merge in
shard order (parallel/collectives.py). A separate sequence-parallel entry
scores one long score row split over the ``seq`` axis by the Kadane monoid.
"""

from __future__ import annotations

import torch

from mini_parallel_tpu_torch.ops import encode, kadane, kmer
from mini_parallel_tpu_torch.ops import packed as packedmod
from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_best
from mini_parallel_tpu_torch.parallel import collectives
from mini_parallel_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Mesh,
    put_sharded,
    shard_batch,
)

KMER_HIST_K = 21
KMER_HIST_BUCKETS = 4096  # power of two
# Knuth's multiplicative constant as the JAX package writes it, an int32
_KNUTH = -1640531527

def _kmer_bucket_hist(codes: torch.Tensor, lengths: torch.Tensor,
                      k: int = KMER_HIST_K,
                      buckets: int = KMER_HIST_BUCKETS) -> torch.Tensor:
    """Every valid k-window hashed into ``buckets`` bins: the JAX package's
    hash of its (hi, lo) int32 key words, ``hi * -1640531527 + lo`` with
    int32 wrapping, masked to the bucket bits. The low bits of a product
    are the same with or without the wrap, so the int64 arithmetic here
    gives the same buckets."""
    if codes.shape[1] < k:
        return torch.zeros(buckets, dtype=torch.int32, device=codes.device)
    keys, ok = kmer.pack_kmers(codes, lengths, k=k)
    s = kmer.lo_bits(k)
    mix = (keys >> s) * _KNUTH + (keys & ((1 << s) - 1))
    b = (mix & (buckets - 1))[ok]
    return torch.bincount(b, minlength=buckets).to(torch.int32)


def _local_wgs_step(reads_a: torch.Tensor, reads_b: torch.Tensor,
                    len_a: torch.Tensor, len_b: torch.Tensor) -> dict:
    """One shard's statistics, before the merge."""
    parity = kadane.kadane_score_batch(reads_a, reads_b, len_a, len_b)
    sw_scores = sw_score_batch_best(reads_a, reads_b)
    # complementarity: r1 vs revcomp(r2); perfectly complementary pairs
    # align end to end with all matches => SW == 2 * min(len)
    rc_b = encode.revcomp_padded(reads_b, len_b, int(encode.PAD_B))
    comp_scores = sw_score_batch_best(reads_a, rc_b)
    minlen = torch.minimum(len_a, len_b)
    valid_pair = minlen > 0
    perfect = (comp_scores == 2 * minlen) & valid_pair
    codes = encode.ascii_to_code(reads_a).to(torch.int64)
    pos = torch.arange(reads_a.shape[1], device=reads_a.device)[None, :]
    vmask = pos < len_a[:, None]
    hist = torch.bincount(codes[vmask], minlength=5)[:5].to(torch.int32)
    i32 = torch.int32
    return {
        "parity_score": parity.sum(dtype=i32),
        "sw_score_sum": sw_scores.sum(dtype=i32),
        "sw_score_max": sw_scores.max(),
        "pairs": valid_pair.sum(dtype=i32),
        "complementary_pairs": perfect.sum(dtype=i32),
        "base_hist": hist,
        "kmer_hist": _kmer_bucket_hist(codes, len_a),
        "bases": len_a.sum(dtype=i32),
    }


_MERGE = {"sw_score_max": collectives.merge_max,
          "base_hist": collectives.merge_histogram,
          "kmer_hist": collectives.merge_histogram}


def _merge(parts: list[dict]) -> dict:
    return {key: _MERGE.get(key, collectives.merge_scores)(
        [p[key] for p in parts]) for key in parts[0]}


def make_wgs_step(mesh: Mesh, data_axis: str = DATA_AXIS):
    """The sharded step: fn(reads_a, reads_b, len_a, len_b) -> stats.

    Inputs are (B, L) uint8 and (B,) int32 arrays or tensors, B divisible
    by the data-axis size; reads_a padded with encode.PAD_A, reads_b with
    encode.PAD_B. Each value comes back as a tensor on the mesh's first
    device (int32, as the JAX package's).
    """

    def step(reads_a, reads_b, len_a, len_b) -> dict:
        return _merge([_local_wgs_step(*shard) for shard in shard_batch(
            mesh, (reads_a, reads_b, len_a, len_b), data_axis)])

    return step


def make_wgs_step_packed(mesh: Mesh, data_axis: str = DATA_AXIS):
    """The sharded step over 2-bit packed operands (ops/packed.py): the
    same statistics, each operand crossing to its shard as
    (packed, exc_col, exc_val, lengths), 4x fewer bytes, unpacked there.
    Call as step(pa, pb) with two PackedBatches of the same row count."""

    def step(pa: packedmod.PackedBatch, pb: packedmod.PackedBatch) -> dict:
        parts = []
        for sa, sb in zip(put_sharded(pa, mesh, data_axis),
                          put_sharded(pb, mesh, data_axis)):
            a = packedmod.unpack_device(*sa, int(encode.PAD_A))
            b = packedmod.unpack_device(*sb, int(encode.PAD_B))
            parts.append(_local_wgs_step(a, b, sa[3], sb[3]))
        return _merge(parts)

    return step


def make_seq_parallel_kadane(mesh: Mesh, seq_axis: str = SEQ_AXIS):
    """Exact contiguous Kadane over a (B, L) score matrix split on L into
    contiguous blocks, one per shard of ``seq_axis``: each shard summarizes
    its block and 4 scalars per row cross to the first device.
    -> fn(scores, valid) -> (B,) best."""

    def fn(scores, valid) -> torch.Tensor:
        blocks = [shard_batch(mesh, (torch.as_tensor(x).T,), seq_axis)
                  for x in (scores, valid)]
        return collectives.sequence_parallel_kadane(
            [s[0].T for s in blocks[0]], [v[0].T for v in blocks[1]])

    return fn
