"""A test entry for cells on several cards: the ``--full-wgs`` job through
the port's multi-process path, ``parallel/distributed.py:
process_full_wgs_distributed``, one rank a process, in the process group
that the environment of benchmark/ranks.py names.

Each rank answers for its own files and its chunk stripe of each file the
plan shares among all ranks; :meth:`Entry.merge` puts the ranks' answers
together, a striped file's reads, bases, chunks and score summed. Rank 0
judges the merged answer as entries/full_wgs.py judges one process's.

``config["fault"]``, where given, plants a fault in one rank's job:
{"rank", "job" (0 is the warm job), "kind": "raise" | "exit" | "sleep",
"seconds" (of the sleep)}.
"""

from __future__ import annotations

import os
import time

from benchmark.entries import full_wgs


class Entry(full_wgs.Entry):
    def __init__(self, config: dict, inputs, device, seed: int,
                 rank: int = 0, world: int = 1):
        super().__init__(config, inputs, device, seed)
        self.rank, self.world = rank, world
        self.jobs_run = 0

    def _fault(self) -> None:
        fault = self.config.get("fault")
        if not fault or (fault["rank"], fault["job"]) != (self.rank,
                                                          self.jobs_run):
            return
        if fault["kind"] == "raise":
            raise RuntimeError(f"a fault planted in rank {self.rank}")
        if fault["kind"] == "exit":
            os._exit(1)
        time.sleep(fault["seconds"])

    def job(self, jobdir: str) -> dict:
        """This rank's part of one ``--full-wgs`` run over every process;
        -> its per-file results."""
        from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
        from mini_parallel_tpu_torch.parallel.distributed import (
            process_full_wgs_distributed,
        )

        self._fault()
        self.jobs_run += 1
        ckpt, results = (os.path.join(jobdir, d) for d in ("ckpt", "results"))
        os.makedirs(ckpt)
        saved = os.environ.get("MPT_RESULTS_DIR")
        os.environ["MPT_RESULTS_DIR"] = results  # its benchmark rows
        try:
            engine = AlignmentEngine(self.cfg, mode=self.cfg.mode,
                                     device=self.device)
            res, _ = process_full_wgs_distributed(
                engine, self.cfg, checkpoint_dir=ckpt, echo=full_wgs._quiet)
        finally:
            if saved is None:
                os.environ.pop("MPT_RESULTS_DIR")
            else:
                os.environ["MPT_RESULTS_DIR"] = saved
        return {"files": [(r.file_path, r.total_reads, r.total_bases,
                           r.chunks, r.failed_chunks, r.score) for r in res],
                "spans": {}}

    def merge(self, outs: list[dict]) -> dict:
        """The ranks' answers as one: each file once, in job order, its
        stripes summed."""
        sums: dict[str, list[int]] = {}
        for out in outs:
            for path, *numbers in out["files"]:
                acc = sums.setdefault(path, [0] * len(numbers))
                for i, v in enumerate(numbers):
                    acc[i] += v
        order = [f for f in self.files if f in sums]
        order += [f for f in sums if f not in order]
        return {"files": [(f, *sums[f]) for f in order], "spans": {}}
