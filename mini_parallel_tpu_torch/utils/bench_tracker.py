"""Benchmark run tracking with JSON results: the counterpart of
mini_parallel_tpu/utils/bench_tracker.py, with the same row format.

Mirrors the field *intent* of the reference tracker
(`smith_waterman/src/tools/benchmark.rs:17-34,44-415`): start/update/finish
lifecycle, reads/s + bases/s throughput, per-run JSON under
``benchmark_results/`` plus a legacy aggregate ``benchmark_results.json``
(benchmark.rs:165-208). ``device`` is the card's name; ``device_seconds``
is the wall the host spent blocked draining device results. Fields that
were not measured stay null.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from dataclasses import dataclass, field

UTILIZATION_METHODOLOGY = (
    "device_seconds / device_duty_cycle / steady_state_duty_cycle measure "
    "HOST-BLOCKED-ON-DEVICE wall (the drains that copy the device score "
    "accumulator to the host and so wait for queued device work); device "
    "work overlapped with host decode is invisible — a pipeline-stall "
    "metric, not device utilization. compile_seconds is the wait on the "
    "first result of each new batch shape, kept out of device_seconds."
)


def default_results_dir() -> str:
    """Results directory, overridable via ``MPT_RESULTS_DIR``."""
    return os.environ.get("MPT_RESULTS_DIR", "benchmark_results")


@dataclass
class BenchmarkResult:
    run_number: int
    workload: str
    chunk_size_reads: int
    device: str
    mode: str
    total_time_seconds: float = 0.0
    total_files: int = 0
    total_reads: int = 0
    total_bases: int = 0
    total_score: int = 0
    throughput_reads_per_second: float = 0.0
    throughput_bases_per_second: float = 0.0
    # host wall blocked in drains (FileResult.drain_seconds)
    device_seconds: float | None = None
    device_duty_cycle: float | None = None  # device_seconds / total_time
    # wall blocked on the first result of each new batch shape
    # (FileResult.warmup_seconds), kept out of device_seconds
    compile_seconds: float | None = None
    steady_state_duty_cycle: float | None = None
    host_info: dict = field(default_factory=dict)
    timestamp: str = ""


def next_run_number(results_dir: str | None = None) -> int:
    """Max existing run number + 1, scanned from disk."""
    results_dir = results_dir or default_results_dir()
    if not os.path.isdir(results_dir):
        return 1
    best = 0
    for name in os.listdir(results_dir):
        m = re.match(r"run_(\d+)_benchmark_results\.json$", name)
        if m:
            best = max(best, int(m.group(1)))
    return best + 1


def claim_run_number(results_dir: str | None = None) -> int:
    """Smallest unclaimed run number, reserved atomically by exclusively
    creating (O_EXCL) the per-run file as a placeholder."""
    results_dir = results_dir or default_results_dir()
    os.makedirs(results_dir, exist_ok=True)
    n = next_run_number(results_dir)
    while True:
        path = os.path.join(results_dir, f"run_{n}_benchmark_results.json")
        try:
            with open(path, "x") as f:
                f.write("{}")  # placeholder; finish() overwrites
            return n
        except FileExistsError:
            n += 1


def annotate_run(run_number: int, fields: dict,
                 results_dir: str | None = None) -> bool:
    """Add fields (e.g. the monitor summary, computable only after the
    monitors stop, after finish() wrote the row) to an existing run's
    per-run JSON and its legacy aggregate entry. Returns True if the
    per-run file was updated."""
    results_dir = results_dir or default_results_dir()
    per_run = os.path.join(results_dir,
                           f"run_{run_number}_benchmark_results.json")
    try:
        with open(per_run) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    payload.update(fields)
    with open(per_run, "w") as f:
        json.dump(payload, f, indent=2)
    legacy = os.path.join(os.path.dirname(results_dir.rstrip("/")) or ".",
                          "benchmark_results.json")
    try:
        with open(legacy) as f:
            history = json.load(f)
        for row in history if isinstance(history, list) else []:
            if row.get("run_number") == run_number:
                row.update(fields)
        with open(legacy, "w") as f:
            json.dump(history, f, indent=2)
    except (OSError, json.JSONDecodeError):
        pass
    return True


class BenchmarkTracker:
    def __init__(
        self,
        workload: str,
        chunk_size_reads: int,
        device: str = "",
        mode: str = "kadane",
        results_dir: str | None = None,
    ):
        self.results_dir = results_dir = results_dir or default_results_dir()
        self.result = BenchmarkResult(
            run_number=claim_run_number(results_dir),
            workload=workload,
            chunk_size_reads=chunk_size_reads,
            device=device,
            mode=mode,
            timestamp=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        )
        self._t0 = time.perf_counter()
        self._device_seconds = 0.0
        self._compile_seconds = 0.0

    # lifecycle mirrors start/update/finish (benchmark.rs:423-450)
    def update(self, files: int, reads: int, bases: int, score: int) -> None:
        r = self.result
        r.total_files, r.total_reads, r.total_bases, r.total_score = (
            files, reads, bases, score)

    def add_device_seconds(self, s: float) -> None:
        self._device_seconds += s

    def add_compile_seconds(self, s: float) -> None:
        self._compile_seconds += s

    def finish(self, host_info: dict | None = None) -> BenchmarkResult:
        r = self.result
        r.total_time_seconds = time.perf_counter() - self._t0
        if r.total_time_seconds > 0:
            r.throughput_reads_per_second = r.total_reads / r.total_time_seconds
            r.throughput_bases_per_second = r.total_bases / r.total_time_seconds
        if self._device_seconds > 0:
            r.device_seconds = self._device_seconds
            r.device_duty_cycle = min(1.0, self._device_seconds / r.total_time_seconds)
            steady_wall = r.total_time_seconds - self._compile_seconds
            if steady_wall > 0:
                r.steady_state_duty_cycle = min(
                    1.0, self._device_seconds / steady_wall)
        if self._compile_seconds > 0:
            r.compile_seconds = self._compile_seconds
        r.host_info = dict(host_info or {})
        if r.device_seconds is not None:
            r.host_info.setdefault("utilization_methodology",
                                   UTILIZATION_METHODOLOGY)
        self._save()
        return r

    def _save(self) -> None:
        os.makedirs(self.results_dir, exist_ok=True)
        payload = dataclasses.asdict(self.result)
        per_run = os.path.join(
            self.results_dir, f"run_{self.result.run_number}_benchmark_results.json"
        )
        with open(per_run, "w") as f:
            json.dump(payload, f, indent=2)
        # legacy aggregate list (benchmark.rs:165-208), next to the results dir
        legacy = os.path.join(os.path.dirname(self.results_dir.rstrip("/"))
                              or ".", "benchmark_results.json")
        history: list = []
        if os.path.exists(legacy):
            try:
                with open(legacy) as f:
                    history = json.load(f)
                if not isinstance(history, list):
                    history = [history]
            except (json.JSONDecodeError, OSError):
                history = []
        history.append(payload)
        with open(legacy, "w") as f:
            json.dump(history, f, indent=2)
