"""Multi-process WGS processing: file sharding and the cross-process merge
of totals. The counterpart of mini_parallel_tpu/parallel/distributed.py.

- **file -> process assignment**: a size-aware plan (greedy LPT on the
  file sizes process 0 reads), with files larger than one process's fair
  share striped by chunk across every process;
- each process runs the standard orchestrator on its files, under
  process-scoped checkpoint run ids (independent resume per process);
- totals merge with one ``torch.distributed`` all-gather over gloo at the
  end of the run: per-chunk work never crosses processes.

Spans (utils/spans.py): ``wgs.dist.sizes`` (the file sizes agreed, their
all-gather), ``wgs.dist.plan``, ``wgs.dist.stripe`` (each shared file's
stripe) and ``wgs.dist.merge`` (the totals' all-gathers, where a process
waits for the slowest); counters ``wgs.dist.files`` (this process's
exclusive files), ``wgs.dist.shared`` and ``wgs.dist.planned_bytes`` (its
files' bytes and its stripes' share of the shared files').

A single process degenerates to the local path, so everything here is
testable without a process group.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass

import numpy as np
import torch

from mini_parallel_tpu_torch.models.alignment import (
    AlignmentEngine,
    FileResult,
)
from mini_parallel_tpu_torch.parallel.mesh import (
    initialize_distributed,
    process_count,
    process_index,
)
from mini_parallel_tpu_torch.utils import spans
from mini_parallel_tpu_torch.utils.checkpoint import (
    CheckpointState,
    FileCheckpoint,
    deterministic_run_id,
)
from mini_parallel_tpu_torch.utils.config import Config


def shard_files(files: list[str], process_id: int,
                num_processes: int) -> list[str]:
    """Round-robin interleave (stable under skewed lane sizes)."""
    return [f for i, f in enumerate(files) if i % num_processes == process_id]


@dataclass
class WorkPlan:
    """Size-aware file -> process plan.

    ``exclusive[p]``: files process p runs alone. ``shared``: files too
    large for any single process's fair share — every process runs them
    with ``chunk_stride=(p, nproc)`` (each owns every nproc-th chunk;
    chunk scores are independent sums, so stripes merge exactly).
    """

    exclusive: list[list[str]]
    shared: list[str]

    def makespan_bytes(self, sizes: dict[str, int]) -> int:
        per_shared = sum(sizes.get(f, 0) for f in self.shared) // max(
            len(self.exclusive), 1)
        return per_shared + max(
            (sum(sizes.get(f, 0) for f in shard) for shard in self.exclusive),
            default=0)


def plan_work(files: list[str], num_processes: int,
              sizes: dict[str, int] | None = None) -> WorkPlan:
    """Deterministic size-aware plan, identical on every process.

    Files bigger than the ideal per-process share are chunk-strided across
    all processes; the rest are greedy-LPT assigned (largest first onto the
    least-loaded process, ties to the lower index). Unknown sizes count 1.
    A multi-process run must pass sizes agreed across processes
    (:func:`_agreed_sizes`): a divergent plan would process a file twice or
    not at all. Every process still decodes the whole of a shared file and
    keeps its stripe.
    """
    if num_processes <= 1:
        return WorkPlan(exclusive=[list(files)], shared=[])
    if sizes is None:
        sizes = {f: _stat_size(f) for f in files}
    total = sum(max(sizes.get(f, 1), 1) for f in files)
    ideal = total / num_processes
    shared = [f for f in files if max(sizes.get(f, 1), 1) > ideal]
    rest = [f for f in files if f not in shared]
    loads = [0] * num_processes
    exclusive: list[list[str]] = [[] for _ in range(num_processes)]
    order = sorted(range(len(rest)),
                   key=lambda i: (-max(sizes.get(rest[i], 1), 1), i))
    for i in order:
        p = min(range(num_processes), key=lambda q: (loads[q], q))
        exclusive[p].append(rest[i])
        loads[p] += max(sizes.get(rest[i], 1), 1)
    # each shard in the original file order (checkpoint indices stay stable)
    pos = {f: i for i, f in enumerate(files)}
    for shard in exclusive:
        shard.sort(key=pos.__getitem__)
    return WorkPlan(exclusive=exclusive, shared=shared)


@dataclass
class DistributedTotals:
    files: int
    reads: int
    bases: int
    score: int
    seconds_max: float  # wall time = slowest process


def _all_gather(x: np.ndarray) -> np.ndarray:
    """(nproc, *x.shape): every process's x, by rank (gloo, host tensors)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def merge_totals(local: DistributedTotals) -> DistributedTotals:
    """All-gather every process's totals and reduce. Identity for a single
    process."""
    if process_count() == 1:
        return local
    vec = np.array([local.files, local.reads, local.bases, local.score],
                   np.int64)
    f, r, b, s = _all_gather(vec).sum(axis=0).tolist()
    secs = _all_gather(np.array([local.seconds_max], np.float64))
    return DistributedTotals(files=int(f), reads=int(r), bases=int(b),
                             score=int(s), seconds_max=float(secs.max()))


def _stat_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 1


def _agreed_sizes(files: list[str], nproc: int) -> dict[str, int]:
    """File sizes every process agrees on: process 0's stats, adopted by
    all (a per-process stat divergence would split the plan)."""
    with spans.span("wgs.dist.sizes"):
        local = np.array([max(_stat_size(f), 1) for f in files], np.int64)
        if nproc > 1 and process_count() > 1:
            local = _all_gather(local)[0]
    return dict(zip(files, (int(x) for x in local)))


def _stripe_with_retries(engine, path, pid, nproc, retries, echo,
                         state=None, file_index=0):
    """Run this process's chunk stripe of a shared file, resuming from the
    last chunk checkpoint on failure (``retries`` times).

    With ``state`` (a CheckpointState) the stripe's progress persists like
    an exclusive file's, so a crashed process resumes from its last
    owned-chunk checkpoint. chunks_done counts OWNED chunks, as
    self_align_file's chunk_stride resume does."""
    prior = state.get_file(file_index) if state is not None else None
    if prior is not None and prior.chunks_done == 0:
        prior = None
    partial: list = [prior]

    def on_checkpoint(res: FileResult):
        if state is not None:
            state.add_file_result(FileCheckpoint(
                file_path=path, file_index=file_index, score=res.score,
                processing_time_ms=res.seconds * 1000.0,
                total_bases=res.total_bases, total_reads=res.total_reads,
                completed=False, chunks_done=res.chunks,
            ))
            partial[0] = state.get_file(file_index)
        else:
            snap = copy.copy(res)
            snap.chunks_done = res.chunks  # owned-chunk index space
            snap.processing_time_ms = res.seconds * 1000.0
            partial[0] = snap

    attempt = 0
    while True:
        try:
            return engine.self_align_file(
                path, progress=echo, chunk_stride=(pid, nproc),
                resume=partial[0], checkpoint_every=50,
                on_checkpoint=on_checkpoint)
        except Exception as e:  # any failure of the attempt is retried
            attempt += 1
            if attempt > retries:
                raise RuntimeError(
                    f"shared file {path} stripe {pid}/{nproc} failed: {e}"
                ) from e
            done = getattr(partial[0], "chunks_done", 0) if partial[0] else 0
            echo(f"  shared-file stripe attempt {attempt} failed ({e}); "
                 f"retrying from owned chunk {done}")


def process_full_wgs_distributed(
    engine: AlignmentEngine,
    cfg: Config | None = None,
    checkpoint_dir: str = ".",
    echo=print,
    retries: int = 0,
    on_bench=None,
) -> tuple[list[FileResult], DistributedTotals]:
    """Run --full-wgs across every process of the group; returns (this
    process's results, the globally merged totals). ``on_bench`` gets this
    process's benchmark row, as in :func:`process_full_wgs_dataset`."""
    from mini_parallel_tpu_torch.models.wgs import process_full_wgs_dataset

    initialize_distributed()  # idempotent; the CLI already ran it
    pid, nproc = process_index(), process_count()
    files = cfg.wgs_file_list() if cfg else engine.cfg.wgs_file_list()
    sizes = _agreed_sizes(files, nproc)
    with spans.span("wgs.dist.plan"):
        plan = plan_work(files, nproc, sizes=sizes)
    my_files = plan.exclusive[pid] if pid < len(plan.exclusive) else []
    spans.count("wgs.dist.files", len(my_files))
    spans.count("wgs.dist.shared", len(plan.shared))
    spans.count("wgs.dist.planned_bytes",
                sum(sizes[f] for f in my_files)
                + sum(sizes[f] for f in plan.shared) // nproc)
    echo(f"[host {pid}/{nproc}] processing {len(my_files)}/{len(files)} "
         f"files exclusively"
         + (f" + {len(plan.shared)} shared (chunk-strided)"
            if plan.shared else ""))
    results = process_full_wgs_dataset(engine, cfg,
                                       checkpoint_dir=checkpoint_dir,
                                       echo=echo, files=my_files,
                                       retries=retries, on_bench=on_bench)
    # oversized files: every process runs its chunk stripe, with the same
    # retry and persistent-checkpoint semantics as exclusive files; the
    # stripe state is keyed per (shared set, pid, nproc), so a restarted
    # process resumes or skips instead of re-running
    stripe_state = None
    if plan.shared:
        c = cfg or engine.cfg
        sid = deterministic_run_id(
            c.sample_id, list(plan.shared), engine.mode,
            chunk_size=c.chunk_size_reads) + f"_stripe{pid}of{nproc}"
        stripe_state = CheckpointState.load(sid, checkpoint_dir)
        if stripe_state is None:
            stripe_state = CheckpointState(run_id=sid,
                                           total_files=len(plan.shared),
                                           directory=checkpoint_dir)
    for si, path in enumerate(plan.shared):
        if stripe_state.is_file_completed(si):
            prev = stripe_state.get_file(si)
            echo(f"[host {pid}/{nproc}] shared file {path}: stripe already "
                 f"completed, skipping")
            results.append(FileResult(
                file_path=prev.file_path, score=prev.score,
                total_bases=prev.total_bases, total_reads=prev.total_reads,
                chunks=prev.chunks_done,
                seconds=prev.processing_time_ms / 1000.0))
            continue
        echo(f"[host {pid}/{nproc}] shared file {path}: "
             f"chunks {pid}::{nproc}")
        with spans.span("wgs.dist.stripe"):
            res = _stripe_with_retries(engine, path, pid, nproc, retries,
                                       echo, state=stripe_state,
                                       file_index=si)
        stripe_state.add_file_result(FileCheckpoint(
            file_path=path, file_index=si, score=res.score,
            processing_time_ms=res.seconds * 1000.0,
            total_bases=res.total_bases, total_reads=res.total_reads,
            completed=True, chunks_done=res.chunks))
        results.append(res)
    # stripes sum exactly across processes for reads, bases and score, but
    # each shared FILE counts once globally: process 0 counts it
    n_files = len(my_files) + (len(plan.shared) if pid == 0 else 0)
    local = DistributedTotals(
        files=n_files,
        reads=sum(r.total_reads for r in results),
        bases=sum(r.total_bases for r in results),
        score=sum(r.score for r in results),
        seconds_max=sum(r.seconds for r in results))
    with spans.span("wgs.dist.merge"):
        merged = merge_totals(local)
    if pid == 0 and nproc > 1:
        echo(f"[global] files={merged.files} reads={merged.reads} "
             f"bases={merged.bases} score={merged.score}")
    return results, merged
