"""Full-WGS dataset orchestrator: the --full-wgs production path, the
counterpart of mini_parallel_tpu/models/wgs.py.

Re-creates ``process_full_wgs_dataset`` (`smith_waterman/src/aligner.rs:183-362`):
generate the lane/read file list from config, resume from a per-file
checkpoint, process files in order, report progress every 10 chunks
(aligner.rs:278-282), save a partial checkpoint and abort on file failure
(aligner.rs:318-337) unless ``retries`` allows another attempt, and finish
with a benchmark JSON row. The run id is deterministic, so resume works
across restarts and across the two packages (utils/checkpoint.py).
"""

from __future__ import annotations

import time

from mini_parallel_tpu_torch.models.alignment import AlignmentEngine, FileResult
from mini_parallel_tpu_torch.utils import spans
from mini_parallel_tpu_torch.utils.bench_tracker import BenchmarkTracker
from mini_parallel_tpu_torch.utils.checkpoint import (
    CheckpointState,
    FileCheckpoint,
    deterministic_run_id,
)
from mini_parallel_tpu_torch.utils.config import Config
from mini_parallel_tpu_torch.utils.system_info import get_system_info


def process_full_wgs_dataset(
    engine: AlignmentEngine,
    cfg: Config | None = None,
    checkpoint_dir: str = ".",
    results_dir: str | None = None,
    echo=print,
    files: list[str] | None = None,
    checkpoint_every_chunks: int = 50,
    retries: int = 0,
    on_bench=None,
) -> list[FileResult]:
    """``retries`` > 0 retries a failed file up to N times, each attempt
    resuming from its last chunk checkpoint; retries=0 keeps the
    reference's abort semantics (aligner.rs:318-337)."""
    cfg = cfg or engine.cfg
    files = files if files is not None else cfg.wgs_file_list()
    total_files = len(files)
    info = get_system_info(engine.device)

    echo("=" * 42)
    echo("WGS PROCESSING STARTING")
    echo("=" * 42)
    echo(f"CHUNK_SIZE_READS: {cfg.chunk_size_reads} (from .env)")
    echo(f"Mode: {engine.mode}")
    echo(info.banner())

    run_id = deterministic_run_id(cfg.sample_id, files, engine.mode,
                                  chunk_size=cfg.chunk_size_reads)
    state = CheckpointState.load(run_id, checkpoint_dir)
    if state is not None:
        echo(f"Found existing checkpoint: {state.completed_files} files completed")
    else:
        echo("No existing checkpoint found, starting fresh run")
        state = CheckpointState(run_id=run_id, total_files=total_files,
                                directory=checkpoint_dir)
    # benchmark deltas: a resumed run reports THIS run's throughput
    f0, r0, b0, s0 = state.totals()

    tracker = BenchmarkTracker(
        workload="full_wgs",
        chunk_size_reads=cfg.chunk_size_reads,
        device=info.device_kind,
        mode=engine.mode,
        results_dir=results_dir,
    )
    echo(f"Processing {total_files} files (your complete genome)...")
    echo(f"Checkpoint file: {state.path}")
    echo("=" * 42)

    results: list[FileResult] = []
    for i, path in enumerate(files):
        short = path.rsplit("/", 1)[-1]
        if state.is_file_completed(i):  # aligner.rs:248-259
            echo(f"Skipping file {i+1}/{total_files} (already completed): {short}")
            prev = state.get_file(i)
            if prev is not None:
                results.append(
                    FileResult(
                        file_path=prev.file_path,
                        score=prev.score,
                        total_bases=prev.total_bases,
                        total_reads=prev.total_reads,
                        seconds=prev.processing_time_ms / 1000.0,
                    )
                )
            continue

        # chunk-level resume: a failed file restarts from its last
        # checkpointed chunk, not from read 0
        partial = state.get_file(i)
        if partial is not None and partial.chunks_done > 0:
            echo(
                f"Resuming file {i+1}/{total_files} from chunk "
                f"{partial.chunks_done} ({partial.total_reads} reads done): {short}"
            )
        else:
            partial = None
            echo(f"Processing file {i+1}/{total_files}: {short}")
        t0 = time.perf_counter()

        def on_chunk(res: FileResult, _i=i):
            if res.chunks % 10 == 0:  # aligner.rs:278-282
                echo(
                    f"    Processed {res.chunks} chunks ({res.total_reads} reads), "
                    f"current score: {res.score}"
                )
                f, r, b, s = state.totals(exclude_index=_i)
                tracker.update(f - f0, r + res.total_reads - r0,
                               b + res.total_bases - b0, s + res.score - s0)

        def on_checkpoint(res: FileResult, _i=i, _path=path):
            with spans.span("wgs.checkpoint"):
                state.add_file_result(
                    FileCheckpoint(
                        file_path=_path, file_index=_i, score=res.score,
                        processing_time_ms=res.seconds * 1000.0,
                        total_bases=res.total_bases,
                        total_reads=res.total_reads,
                        completed=False, chunks_done=res.chunks,
                    )
                )

        attempt = 0
        while True:
            try:
                res = engine.self_align_file(
                    path, progress=echo, on_chunk=on_chunk, resume=partial,
                    checkpoint_every=checkpoint_every_chunks,
                    on_checkpoint=on_checkpoint,
                )
                break
            except Exception as e:  # aligner.rs:318-337: save partial
                # keep any mid-file checkpoint (resume point); only write a
                # zero partial when none exists yet
                if state.get_file(i) is None:
                    elapsed_ms = (time.perf_counter() - t0) * 1000
                    state.add_file_result(
                        FileCheckpoint(
                            file_path=path, file_index=i, score=0,
                            processing_time_ms=elapsed_ms, total_bases=0,
                            total_reads=0, completed=False,
                        )
                    )
                attempt += 1
                if attempt > retries:  # reference semantics: abort the run
                    raise RuntimeError(f"File {i+1} failed: {e}") from e
                partial = state.get_file(i)
                if partial is not None and partial.chunks_done == 0:
                    partial = None
                echo(
                    f"  File {i+1} attempt {attempt} failed ({e}); retrying "
                    f"from chunk {partial.chunks_done if partial else 0} "
                    f"({retries - attempt + 1} retr"
                    f"{'y' if retries - attempt + 1 == 1 else 'ies'} left)"
                )

        echo(
            f"  File {i+1} complete: Score={res.score}, Bases={res.total_bases}, "
            f"Time: {res.seconds:.2f} s"
        )
        if res.failed_chunks:  # aligner.rs:284-287: failures skip, not abort
            echo(f"  WARNING: {res.failed_chunks} chunk(s) failed and were "
                 f"skipped (scored 0)")
        tracker.add_device_seconds(res.drain_seconds)
        tracker.add_compile_seconds(res.warmup_seconds)
        with spans.span("wgs.checkpoint"):
            state.add_file_result(
                FileCheckpoint(
                    file_path=path, file_index=i, score=res.score,
                    processing_time_ms=res.seconds * 1000.0,
                    total_bases=res.total_bases, total_reads=res.total_reads,
                    completed=True, chunks_done=res.chunks,
                )
            )
        results.append(res)

    f, r, b, s = state.totals()  # aligner.rs:342-347
    tracker.update(f - f0, r - r0, b - b0, s - s0)
    bench = tracker.finish(host_info={"banner": info.banner()})
    if on_bench is not None:
        on_bench(bench)
    echo("BENCHMARK RESULTS:")
    echo("=" * 21)
    echo(f"Total time: {bench.total_time_seconds:.2f} s")
    echo(
        f"Throughput: {bench.throughput_reads_per_second:.0f} reads/s, "
        f"{bench.throughput_bases_per_second:.0f} bases/s"
    )
    if bench.compile_seconds is not None:
        echo(f"First-result wait: {bench.compile_seconds:.2f} s")
    if bench.steady_state_duty_cycle is not None:
        echo("Host blocked on device (steady state): "
             f"{100*bench.steady_state_duty_cycle:.1f} %")
    elif bench.device_duty_cycle is not None:
        echo(f"Host blocked on device: {100*bench.device_duty_cycle:.1f} %")
    echo(f"All files completed! Checkpoint saved to: {state.path}")
    return results
