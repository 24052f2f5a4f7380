"""The ``--full-wgs`` job: ``models/wgs.py:process_full_wgs_dataset``
over the sample's lane files with ``AlignmentEngine(mode=...)``, each job
with an empty checkpoint and results directory, as the CLI runs it.

A job's answers are each file's reads, bases, chunks, failed chunks and
score. The plain reference works out every file's reads and bases from the
generated reads and each read's self-score by a plain DP
(reference/sw_self.py); the chunks follow from the reads and the chunk
size.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import work
from benchmark.reference import sw_self


def _quiet(*_args, **_kwargs) -> None:
    pass


class Entry:
    def __init__(self, config: dict, inputs, device: torch.device,
                 seed: int):
        from mini_parallel_tpu_torch.utils.config import Config

        self.config, self.inputs, self.device = config, inputs, device
        eng = config["engine"]
        sample = config["sample"]
        self.cfg = Config(
            wgs_data_dir=os.path.dirname(inputs.files[0]),
            sample_id=sample["sample_id"], lanes=sample["lanes"],
            reads_per_lane=sample["reads_per_lane"],
            chunk_size_reads=eng["chunk_size_reads"], mode=eng["mode"])

    @property
    def files(self) -> list[str]:
        return self.inputs.files

    def job(self, jobdir: str) -> dict:
        """One whole ``--full-wgs`` run; -> its per-file results."""
        from torch.profiler import record_function

        from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
        from mini_parallel_tpu_torch.models.wgs import (
            process_full_wgs_dataset,
        )

        ckpt, results = (os.path.join(jobdir, d) for d in ("ckpt", "results"))
        os.makedirs(ckpt)
        os.makedirs(results)
        with record_function("process_full_wgs_dataset"):
            engine = AlignmentEngine(self.cfg, mode=self.cfg.mode,
                                     device=self.device)
            res = process_full_wgs_dataset(
                engine, self.cfg, checkpoint_dir=ckpt, results_dir=results,
                echo=_quiet, files=self.files)
        return {"files": [(r.file_path, r.total_reads, r.total_bases,
                           r.chunks, r.failed_chunks, r.score) for r in res],
                "spans": {}}

    def reads(self, out: dict) -> int:
        return sum(f[1] for f in out["files"])

    def chunks(self, out: dict) -> tuple[int, int]:
        """(chunks handed to the program, chunks it reported failed)."""
        return (sum(f[3] for f in out["files"]),
                sum(f[4] for f in out["files"]))

    def cells(self) -> int:
        """DP cells the job's reads need: each read against itself."""
        return work.self_alignment_cells(np.concatenate(
            [np.full(s.shape[0], s.shape[1]) for s in self.inputs.seqs]))

    def reference(self, bits: int = 32) -> list[tuple]:
        """Each file's (path, reads, bases, chunks, failed, score) by the
        plain reference; ``bits`` < 32 is the lower-precision control."""
        chunk = self.cfg.chunk_size_reads
        out = []
        for path, seqs in zip(self.files, self.inputs.seqs):
            n = seqs.shape[0]
            score = int(sw_self.self_scores(seqs, device=self.device,
                                            bits=bits).sum())
            out.append((path, n, int(seqs.size), -(-n // chunk), 0, score))
        return out

    def check(self, outs: list[dict], ref: list[tuple]) -> list[tuple]:
        """(name, value, limit) of each number compared, over every job."""
        limits = self.config["limits"]
        gaps = np.zeros(5, np.int64)
        files_off = 0
        for out in outs:
            got = out["files"]
            files_off += abs(len(got) - len(ref)) + sum(
                g[0] != w[0] for g, w in zip(got, ref))
            for g, w in zip(got, ref):
                gaps += np.abs(np.array(g[1:], np.int64)
                               - np.array(w[1:], np.int64))
        names = ("reads_gap", "bases_gap", "chunks_gap", "failed_chunks",
                 "score_gap")
        return [("files_off", files_off, limits["files_off"]),
                *((n, int(v), limits[n]) for n, v in zip(names, gaps))]

    def control(self, ref, jobdir: str, outs: list[dict]) -> list[dict]:
        """The control in the program's place: one job's answers from the
        reference in saturating integers of half the width the
        configuration states for the scores."""
        bits = self.config["score_bits"] // 2
        return [{"files": self.reference(bits=bits), "spans": {}}]
