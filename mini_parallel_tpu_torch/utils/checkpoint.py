"""Per-file checkpoint/resume for long WGS runs.

Reproduces the *intent* of the reference checkpoint system
(`smith_waterman/src/aligner.rs:23-104`): JSON state with one record per
file, saved after every file (including failed partials, aligner.rs:321-333),
and skip-if-completed on restart (aligner.rs:248-259).

The same JSON schema and run id as mini_parallel_tpu/utils/checkpoint.py,
so a checkpoint that either package writes resumes in the other.

Deliberately fixed reference defects (SURVEY.md §2 #4):
- the reference *saves* ``checkpoint_run_{N}.json`` (aligner.rs:55) but
  *loads* ``checkpoint_{run_id}.json`` (aligner.rs:74) with a
  fresh-timestamp run_id (aligner.rs:219), so resume never matched. Here the
  run_id is deterministic (derived from the dataset config) and save/load use
  the same filename.
- run numbers came from a per-process counter that drifted
  (benchmark.rs:429-436); not replicated.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field


@dataclass
class FileCheckpoint:
    # field set mirrors FileCheckpoint, aligner.rs:23-32, plus chunk-level
    # resume (beyond the reference: a failed 52M-read file resumes from its
    # last checkpointed chunk instead of restarting)
    file_path: str
    file_index: int
    score: int
    processing_time_ms: float
    total_bases: int
    total_reads: int
    completed: bool
    chunks_done: int = 0


@dataclass
class CheckpointState:
    # mirrors CheckpointState, aligner.rs:34-40
    run_id: str
    files: list[FileCheckpoint] = field(default_factory=list)
    total_files: int = 0
    completed_files: int = 0
    directory: str = "."

    # -- persistence ------------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"checkpoint_{self.run_id}.json")

    def save(self) -> None:
        payload = {
            "run_id": self.run_id,
            "files": [dataclasses.asdict(f) for f in self.files],
            "total_files": self.total_files,
            "completed_files": self.completed_files,
        }
        os.makedirs(self.directory or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, self.path)  # atomic: a crash never corrupts resume state

    @classmethod
    def load(cls, run_id: str, directory: str = ".") -> "CheckpointState | None":
        path = os.path.join(directory, f"checkpoint_{run_id}.json")
        if not os.path.exists(path):
            return None  # aligner.rs:81: no checkpoint -> fresh run
        with open(path) as f:
            d = json.load(f)
        return cls(
            run_id=d["run_id"],
            files=[FileCheckpoint(**fc) for fc in d["files"]],
            total_files=d["total_files"],
            completed_files=d["completed_files"],
            directory=directory,
        )

    # -- mutation (aligner.rs:85-103) --------------------------------------
    def add_file_result(self, fc: FileCheckpoint) -> None:
        self.files = [f for f in self.files if f.file_index != fc.file_index]
        self.files.append(fc)
        self.completed_files = sum(1 for f in self.files if f.completed)
        self.save()

    def is_file_completed(self, file_index: int) -> bool:
        return any(f.file_index == file_index and f.completed for f in self.files)

    def get_file(self, file_index: int) -> FileCheckpoint | None:
        for f in self.files:
            if f.file_index == file_index:
                return f
        return None

    def totals(self, exclude_index: int | None = None) -> tuple[int, int, int, int]:
        """(files, reads, bases, score) — fold at aligner.rs:342-344.

        ``exclude_index`` omits one file's record — used while that file is
        live so its in-flight partials aren't counted twice (once from its
        mid-file checkpoint, once from the live FileResult)."""
        fs = [f for f in self.files if f.file_index != exclude_index]
        return (
            len(fs),
            sum(f.total_reads for f in fs),
            sum(f.total_bases for f in fs),
            sum(f.score for f in fs),
        )


def deterministic_run_id(sample_id: str, files: list[str], mode: str,
                         chunk_size: int | None = None) -> str:
    """Stable across restarts for the same dataset+mode+chunking — the fix
    for the reference's timestamped run_id (aligner.rs:219) that broke
    resume. chunk_size participates in the hash because chunk-level resume
    points (FileCheckpoint.chunks_done) are indexed in chunk units: loading
    them under a different CHUNK_SIZE_READS would skip the wrong reads and
    silently corrupt scores."""
    payload = "|".join(files) + "|" + mode
    if chunk_size is not None:
        payload += f"|chunk{chunk_size}"
    h = hashlib.sha256(payload.encode()).hexdigest()[:8]
    return f"wgs_{sample_id}_{mode}_{h}"
