"""The ``--full-wgs`` job of a node's processes, one a card: the port's
multi-process path, ``parallel/distributed.py:
process_full_wgs_distributed``, one rank a process, in the process group
that the environment of benchmark/ranks.py names.

Each rank answers for its own files, its chunk stripe of each file the
plan shares among all ranks, and the totals the program all-gathered, as
that rank sees them. :meth:`Entry.merge` puts the ranks' answers together:
a striped file's reads, bases, chunks and score summed, and every rank's
totals kept. Rank 0 judges each file as entries/full_wgs.py judges one
process's, and the totals against the reference's sums: ``totals_gap``
(rank 0's files, reads, bases and score against the reference's) and
``totals_disagree`` (the ranks whose totals differ from rank 0's).
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.entries import full_wgs


class Entry(full_wgs.Entry):
    def __init__(self, config: dict, inputs, device, seed: int,
                 rank: int = 0, world: int = 1):
        """``rank`` and ``world`` are the harness's; the program reads its
        own from the environment benchmark/ranks.py sets."""
        super().__init__(config, inputs, device, seed)

    def job(self, jobdir: str) -> dict:
        """This rank's part of one ``--full-wgs`` run over every process;
        -> its per-file results and the merged totals it was given."""
        from torch.profiler import record_function

        from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
        from mini_parallel_tpu_torch.parallel.distributed import (
            process_full_wgs_distributed,
        )

        ckpt, results = (os.path.join(jobdir, d) for d in ("ckpt", "results"))
        os.makedirs(ckpt)
        saved = os.environ.get("MPT_RESULTS_DIR")
        os.environ["MPT_RESULTS_DIR"] = results  # its benchmark rows
        try:
            with record_function("process_full_wgs_dataset"):
                engine = AlignmentEngine(self.cfg, mode=self.cfg.mode,
                                         device=self.device)
                res, merged = process_full_wgs_distributed(
                    engine, self.cfg, checkpoint_dir=ckpt,
                    echo=full_wgs._quiet)
        finally:
            if saved is None:
                os.environ.pop("MPT_RESULTS_DIR")
            else:
                os.environ["MPT_RESULTS_DIR"] = saved
        return {"files": [(r.file_path, r.total_reads, r.total_bases,
                           r.chunks, r.failed_chunks, r.score) for r in res],
                "totals": [[merged.files, merged.reads, merged.bases,
                            merged.score]],
                "spans": {}}

    def merge(self, outs: list[dict]) -> dict:
        """The ranks' answers as one: each file once, in job order, its
        stripes summed; the totals of every rank, by rank."""
        sums: dict[str, list[int]] = {}
        for out in outs:
            for path, *numbers in out["files"]:
                acc = sums.setdefault(path, [0] * len(numbers))
                for i, v in enumerate(numbers):
                    acc[i] += v
        order = [f for f in self.files if f in sums]
        order += [f for f in sums if f not in order]
        return {"files": [(f, *sums[f]) for f in order],
                "totals": [t for out in outs for t in out["totals"]],
                "spans": {}}

    @staticmethod
    def _sums(files: list[tuple]) -> list[int]:
        """The totals ``files`` (path, reads, bases, chunks, failed, score)
        add up to: files, reads, bases, score."""
        return [len(files), sum(f[1] for f in files),
                sum(f[2] for f in files), sum(f[5] for f in files)]

    def check(self, outs: list[dict], ref: list[tuple]) -> list[tuple]:
        """The per-file numbers of entries/full_wgs.py, then the totals of
        every job against the reference's sums."""
        limits = self.config["limits"]
        want = np.array(self._sums(ref), np.int64)
        gap = disagree = 0
        for out in outs:
            first, *rest = out["totals"] or [[0, 0, 0, 0]]
            gap += int(np.abs(np.array(first, np.int64) - want).sum())
            disagree += sum(t != first for t in rest)
        return [*super().check(outs, ref),
                ("totals_gap", gap, limits["totals_gap"]),
                ("totals_disagree", disagree, limits["totals_disagree"])]

    def control(self, ref, jobdir: str, outs: list[dict]) -> list[dict]:
        """The control in the program's place (entries/full_wgs.py's), its
        totals the sums of its own files."""
        files = self.reference(bits=self.config["score_bits"] // 2)
        return [{"files": files, "totals": [self._sums(files)],
                 "spans": {}}]
