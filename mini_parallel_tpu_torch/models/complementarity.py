"""Direct + complementary lane-pair alignment, the % non-complementary
metric: the counterpart of mini_parallel_tpu/models/complementarity.py.

The reference README's stated WGS goal (`README.md:14-16`): "find what %
of genome is not perfectly complementary". For each mate pair
(r1[i], r2[i]) of an R1/R2 lane pair:

- direct score = alignment(r1, r2): SW in ``sw`` mode, parity Kadane in
  any other mode;
- comp score = SW(r1, revcomp(r2)), always through the SW kernel, with the
  reverse complement taken on the device (ops/encode.py:revcomp_padded);
- the pair is "perfectly complementary" iff comp == 2 * min(len): r1
  aligns end to end, all matches, against the reverse complement of r2.

% non-complementary = 1 - perfect_pairs / pairs.

With a device mesh, packed mate batches shard data-parallel: pad pairs of
length 0 score 0 and are never perfect, and the three sums merge in shard
order (parallel/collectives.py). Without a mesh the same path runs on a
mesh of one shard, the engine's device.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from itertools import zip_longest

import numpy as np
import torch

from mini_parallel_tpu_torch.device import require_cuda
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.ops import encode, kadane
from mini_parallel_tpu_torch.ops import packed as packedmod
from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_best
from mini_parallel_tpu_torch.parallel import collectives
from mini_parallel_tpu_torch.parallel.mesh import (
    engine_mesh,
    mesh_device,
    put_sharded,
)
from mini_parallel_tpu_torch.utils.config import Config


@dataclass
class ComplementarityResult:
    file1: str
    file2: str
    pairs: int = 0
    direct_score_sum: int = 0
    comp_score_sum: int = 0
    perfect_pairs: int = 0
    seconds: float = 0.0
    # reads with no mate (unequal R1/R2 lane sizes, e.g. a truncated
    # download); excluded from the pair metrics
    unpaired_reads: int = 0

    @property
    def pct_non_complementary(self) -> float:
        if self.pairs == 0:
            return 0.0
        return 100.0 * (1.0 - self.perfect_pairs / self.pairs)


def _pair_scores(a: torch.Tensor, b: torch.Tensor, len1: torch.Tensor,
                 len2: torch.Tensor, mode: str):
    """(direct, comp, perfect) per pair; revcomp computed on the device."""
    if mode == "sw":
        direct = sw_score_batch_best(a, b)
    else:
        direct = kadane.kadane_score_batch(a, b, len1, len2)
    rc = encode.revcomp_padded(b, len2, int(encode.PAD_B))
    comp = sw_score_batch_best(a, rc)
    minlen = torch.minimum(len1, len2)
    perfect = (comp == 2 * minlen) & (minlen > 0)
    return direct, comp, perfect


def _pair_stats_packed(pk1, ec1, ev1, ln1, pk2, ec2, ev2, ln2, mode: str):
    """Scalar batch stats over 2-bit packed operands: three device scalars
    per batch instead of three (B,) tensors."""
    a = packedmod.unpack_device(pk1, ec1, ev1, ln1, int(encode.PAD_A))
    b = packedmod.unpack_device(pk2, ec2, ev2, ln2, int(encode.PAD_B))
    return _stat_sums(*_pair_scores(a, b, ln1, ln2, mode))


def _stat_sums(direct, comp, perfect) -> torch.Tensor:
    """(direct sum, comp sum, perfect count) as one (3,) int64 tensor."""
    return torch.stack([direct.sum(dtype=torch.int64),
                        comp.sum(dtype=torch.int64),
                        perfect.sum(dtype=torch.int64)])


class ComplementarityEngine:
    def __init__(self, cfg: Config | None = None, mode: str = "sw",
                 device: torch.device | str | None = None, mesh=None):
        self.cfg = cfg or Config(chunk_size_reads=10_000)
        self.mode = mode
        self.device = require_cuda(mesh_device(mesh, device))
        self.mesh = engine_mesh(mesh, self.device)

    def _pad_for_len(self, maxlen: int) -> int:
        """The one bucket rule: a multiple of 8 (not a power of two)."""
        return -(-max(self.cfg.read_pad, maxlen) // 8) * 8

    def score_pairs_batch(self, r1: list[bytes], r2: list[bytes]
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(direct scores, comp scores, perfect mask) of one mate batch, a
        value a pair, on the engine's device."""
        pad = self._pad_for_len(max(max((len(r) for r in r1), default=1),
                                    max((len(r) for r in r2), default=1)))
        arr1, len1 = encode.pad_batch(r1, pad_to=pad,
                                      pad_value=int(encode.PAD_A))
        arr2, len2 = encode.pad_batch(r2, pad_to=pad,
                                      pad_value=int(encode.PAD_B))
        a, b, la, lb = (torch.from_numpy(x).to(self.device)
                        for x in (arr1, arr2, len1, len2))
        return tuple(x.cpu().numpy()
                     for x in _pair_scores(a, b, la, lb, self.mode))

    def _flat_stats(self, f1, o1, f2, o2, n: int) -> torch.Tensor:
        """Deferred (3,) stats over the first n reads of two flat chunks
        (the io.fastq.iter_flat_chunks contract)."""
        o1, o2 = o1[: n + 1], o2[: n + 1]
        m1 = int(np.diff(o1).max()) if n else 1
        m2 = int(np.diff(o2).max()) if n else 1
        pad = self._pad_for_len(max(m1, m2))
        arr1, len1 = encode.pad_batch_flat(
            f1[: int(o1[-1])], o1, pad_to=pad, pad_value=int(encode.PAD_A))
        arr2, len2 = encode.pad_batch_flat(
            f2[: int(o2[-1])], o2, pad_to=pad, pad_value=int(encode.PAD_B))
        p1 = packedmod.pack_batch(arr1, len1)
        p2 = packedmod.pack_batch(arr2, len2)
        return collectives.merge_scores([
            _pair_stats_packed(*s1, *s2, mode=self.mode)
            for s1, s2 in zip(put_sharded(p1, self.mesh),
                              put_sharded(p2, self.mesh))])

    def analyze_lane_pair(self, file1: str, file2: str, progress=None
                          ) -> ComplementarityResult:
        res = ComplementarityResult(file1=file1, file2=file2)
        t0 = time.perf_counter()
        empty = (np.empty(0, np.uint8), np.zeros(1, np.int64))
        deferred: list[torch.Tensor] = []
        # both producer threads stop when this block ends, exception or not
        with contextlib.ExitStack() as stack:
            it1, it2 = (stack.enter_context(fastq.prefetch(
                fastq.iter_flat_chunks(f, self.cfg.chunk_size_reads)))
                for f in (file1, file2))
            for (f1, o1), (f2, o2) in zip_longest(it1, it2, fillvalue=empty):
                n1, n2 = len(o1) - 1, len(o2) - 1
                n = min(n1, n2)
                res.unpaired_reads += max(n1, n2) - n
                if n == 0:
                    continue
                deferred.append(self._flat_stats(f1, o1, f2, o2, n))
                res.pairs += n
                if progress:
                    progress(f"  {res.pairs} pairs queued")
        if res.unpaired_reads and progress:
            progress(f"  WARNING: {res.unpaired_reads} unpaired reads "
                     f"(unequal lane sizes) excluded from pair metrics")
        if deferred:  # one read of every batch's three sums
            d, c, p = torch.stack(deferred).sum(dim=0).tolist()
            res.direct_score_sum, res.comp_score_sum, res.perfect_pairs = d, c, p
        res.seconds = time.perf_counter() - t0
        return res
