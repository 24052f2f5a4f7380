"""Host and GPU monitor supervisor: external observers for long runs. The
counterpart of mini_parallel_tpu/utils/perf_logger.py.

Re-creates the reference's monitor fleet (`smith_waterman/src/perf_logger.rs`):
spawn system monitors writing to ``logs/run_N/`` for the duration of a run
(`perf_logger.rs:74-168`), stop them at the end (`perf_logger.rs:170-206`),
and clean up on Ctrl-C (`perf_logger.rs:271-281`).

- ``iostat``, ``vmstat`` and ``pidstat`` (MONITOR_CMDS), and ``perf record
  -g -p <pid>`` unless ``MPT_PERF_RECORD=0``. A missing binary is logged in
  its ``.log`` file and skipped, as in the JAX package.
- On a CUDA device, the reference's GPU monitor comes back as a fourth
  process: ``nvidia-smi --query-gpu=...`` every 100 ms into
  ``nvidia_smi.log`` (``dmon`` samples at 1 s at the finest, and a
  ``--full-wgs`` run can last under a second). On a CUDA device it is not
  optional: a missing ``nvidia-smi``, or one that writes no sample within
  GPU_MONITOR_START_S, raises, and nothing runs without it.
- A sampler thread writes ``device_memory.jsonl`` rows in the JAX schema,
  ``{"t": ..., "<index>": {"bytes_in_use", "peak_bytes_in_use"}}``, from
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` of the
  monitors' device: one row at start, one every ``sample_interval_s`` and
  one at stop. On a CPU device its rows hold ``t`` only. The JAX queue
  probe (a kernel launched from the sampler to time the queue) is not
  ported: the card has a real counter, and a probe would put work on the
  stream of the path it measures.

All monitors are off the critical path (SURVEY.md §7.6).
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import signal
import subprocess
import threading
import time

import torch

MONITOR_CMDS = {
    # name -> argv (perf_logger.rs:95-135 equivalents)
    "iostat": ["iostat", "-dx", "1"],
    "vmstat": ["vmstat", "1"],
    "pidstat": ["pidstat", "-w", "1"],
}
# the GPU monitor (perf_logger.rs:77-82): one CSV row per sample
NVIDIA_SMI_FIELDS = ("timestamp", "utilization.gpu", "memory.used",
                     "power.draw")
NVIDIA_SMI_PERIOD_MS = 100
GPU_MONITOR_START_S = 15.0  # the longest wait for nvidia-smi's first sample
STOP_WAIT_S = 2.0
BUSY_METHODOLOGY = (
    "device_busy_fraction_est is the time-weighted mean of nvidia-smi's "
    "utilization.gpu / 100, sampled every 100 ms: the share of each sample "
    "period in which any kernel ran on the card, not SM occupancy; each "
    "interval between two samples is weighted by the sample that ends it."
)


class GpuMonitorError(RuntimeError):
    """The GPU monitor could not run on a CUDA device."""


def _next_run_dir(base: str = "logs") -> str:
    os.makedirs(base, exist_ok=True)
    n = 1
    while os.path.exists(os.path.join(base, f"run_{n}")):
        n += 1
    path = os.path.join(base, f"run_{n}")
    os.makedirs(path)
    return path


def nvidia_smi_argv(index: int) -> list[str]:
    """The GPU monitor's command for card ``index`` (nvidia-smi's
    numbering, which is torch's while CUDA_VISIBLE_DEVICES is unset)."""
    return ["nvidia-smi", "-i", str(index),
            f"--query-gpu={','.join(NVIDIA_SMI_FIELDS)}",
            "--format=csv,noheader,nounits", "-lms", str(NVIDIA_SMI_PERIOD_MS)]


class SystemMonitors:
    """Spawn/stop external monitors + a device-memory sampler.

    ``device``: the device the measured run uses (None: CUDA, as every
    entry point of the port). The GPU monitor and the memory counters
    follow it.
    """

    def __init__(self, log_base: str = "logs", sample_interval_s: float = 1.0,
                 device: torch.device | str | None = None):
        from mini_parallel_tpu_torch.device import require_cuda

        self.log_base = log_base
        self.sample_interval_s = sample_interval_s
        self.device = require_cuda(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.run_dir: str | None = None
        self._procs: dict[str, subprocess.Popen] = {}
        self._stop_event = threading.Event()
        self._sampler: threading.Thread | None = None

    def _spawn(self, name: str, argv: list[str]) -> bool:
        """Start one monitor writing to ``<name>.log``; False when its
        binary is missing (logged there)."""
        assert self.run_dir is not None
        with open(os.path.join(self.run_dir, f"{name}.log"), "w") as log:
            try:
                self._procs[name] = subprocess.Popen(
                    argv, stdout=log, stderr=subprocess.STDOUT)
            except FileNotFoundError:
                log.write(f"{argv[0]} not available on this host\n")
                return False
        return True

    def start(self) -> str:
        self.run_dir = _next_run_dir(self.log_base)
        cmds = dict(MONITOR_CMDS)
        # perf record -g -p <pid>, the reference's 5th monitor
        # (perf_logger.rs:152-156); stop() makes perf flush perf.data.
        # MPT_PERF_RECORD=0 disables it (it samples this very process).
        if os.environ.get("MPT_PERF_RECORD", "1") != "0":
            cmds["perf_record"] = [
                "perf", "record", "-g", "-p", str(os.getpid()),
                "-o", os.path.join(self.run_dir, "perf.data"),
            ]
        try:
            for name, argv in cmds.items():
                self._spawn(name, argv)
            if self.device.type == "cuda":
                self._start_gpu_monitor()
        except BaseException:
            self.stop()
            raise
        self._stop_event.clear()
        self._sampler = threading.Thread(target=self._sample_device,
                                         daemon=True, name="mptt-sampler")
        self._sampler.start()
        return self.run_dir

    def _start_gpu_monitor(self) -> None:
        """Start nvidia-smi and wait for its first sample, so the monitor
        covers the run from its start; raise if it cannot run."""
        if not self._spawn("nvidia_smi", nvidia_smi_argv(self.device.index)):
            raise GpuMonitorError(
                "nvidia-smi is not available: the GPU monitor is required "
                "on a CUDA device")
        path = os.path.join(self.run_dir, "nvidia_smi.log")
        proc = self._procs["nvidia_smi"]
        deadline = time.monotonic() + GPU_MONITOR_START_S
        while not read_nvidia_smi_log(path):
            if proc.poll() is not None or time.monotonic() > deadline:
                with open(path, errors="replace") as f:
                    said = f.read()[-500:]
                raise GpuMonitorError(
                    f"nvidia-smi wrote no sample within {GPU_MONITOR_START_S}"
                    f" s (exit code {proc.poll()}): {said!r}")
            time.sleep(0.02)

    def _memory_row(self) -> dict:
        row: dict = {"t": time.time()}
        if self.device.type == "cuda":
            row[str(self.device.index)] = {
                "bytes_in_use": torch.cuda.memory_allocated(self.device),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(
                    self.device),
            }
        return row

    def _sample_device(self) -> None:
        """Device-memory sampler: reads the caching allocator's counters,
        launches nothing."""
        assert self.run_dir is not None
        path = os.path.join(self.run_dir, "device_memory.jsonl")
        with open(path, "w") as f:
            stopped = False
            while True:
                f.write(json.dumps(self._memory_row()) + "\n")
                f.flush()
                if stopped:
                    return
                stopped = self._stop_event.wait(self.sample_interval_s)

    def stop(self) -> None:
        """Stop the sampler (after its last row) and every monitor: SIGINT,
        as Ctrl-C stops each of them by hand (perf record and nvidia-smi
        flush their output on it), then SIGKILL after STOP_WAIT_S."""
        self._stop_event.set()
        if self._sampler is not None:
            self._sampler.join(timeout=STOP_WAIT_S)
            self._sampler = None
        for proc in self._procs.values():
            with contextlib.suppress(ProcessLookupError):
                proc.send_signal(signal.SIGINT)
        for proc in self._procs.values():
            try:
                proc.wait(timeout=STOP_WAIT_S)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(ProcessLookupError):
                    proc.kill()
                proc.wait()
        self._procs.clear()


@contextlib.contextmanager
def system_monitors(log_base: str = "logs",
                    device: torch.device | str | None = None):
    """Context manager + SIGINT cleanup (perf_logger.rs:271-281)."""
    mon = SystemMonitors(log_base=log_base, device=device)
    mon.start()
    prev = signal.getsignal(signal.SIGINT)

    def handler(signum, frame):
        mon.stop()
        if callable(prev):
            prev(signum, frame)
        else:
            raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        prev = None  # non-main thread: no signal hook
    try:
        yield mon
    finally:
        mon.stop()
        if prev is not None:
            with contextlib.suppress(ValueError):
                signal.signal(signal.SIGINT, prev)


def _number(field: str) -> float | None:
    """One nvidia-smi value; None for ``[N/A]``, ``[Not Supported]`` or
    anything else that is not a number."""
    try:
        return float(field)
    except ValueError:
        return None


def read_nvidia_smi_log(path: str) -> list[tuple[float, float | None,
                                                 float | None, float | None]]:
    """The samples of an ``nvidia_smi.log``: (epoch seconds, utilization.gpu
    %, memory.used MiB, power.draw W), a value None where nvidia-smi
    printed ``[N/A]``. Lines that are torn or not samples (an error
    message, a half-written last line) are skipped."""
    out = []
    try:
        f = open(path, errors="replace")
    except FileNotFoundError:
        return out
    with f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != len(NVIDIA_SMI_FIELDS):
                continue
            try:
                t = datetime.datetime.strptime(parts[0],
                                               "%Y/%m/%d %H:%M:%S.%f")
            except ValueError:
                continue
            out.append((t.timestamp(), *(_number(p) for p in parts[1:])))
    return out


def summarize_nvidia_smi(samples) -> dict:
    """The GPU monitor's fields of the summary (BUSY_METHODOLOGY)."""
    out: dict = {}
    util = [(t, u) for t, u, _, _ in samples if u is not None]
    if util:
        # sample i stands for the interval (t[i-1], t[i]]; one sample alone
        # stands for itself
        spans = [(t1 - t0, u1) for (t0, _), (t1, u1) in zip(util, util[1:])]
        total = sum(dt for dt, _ in spans)
        mean = (sum(dt * u for dt, u in spans) / total if total > 0
                else util[-1][1])
        out["device_busy_fraction_est"] = round(mean / 100.0, 4)
        out["device_busy_methodology"] = BUSY_METHODOLOGY
        out["gpu_utilization_max_pct"] = max(u for _, u in util)
    for key, col in (("peak_gpu_memory_used_mib", 2), ("max_power_draw_w", 3)):
        vals = [s[col] for s in samples if s[col] is not None]
        if vals:
            out[key] = max(vals)
    return out


def summarize_monitor_logs(run_dir: str) -> dict:
    """Post-run summary parsed from the monitor logs — the analogue of the
    reference's log parsers (benchmark.rs:249-414), with real numbers only
    (fields are absent when a monitor didn't run, never invented). The
    vmstat, iostat and device-memory fields are the JAX package's; the
    GPU monitor adds those of :func:`summarize_nvidia_smi`."""
    out: dict = {}

    def _floats(parts, idx):
        try:
            return float(parts[idx])
        except (ValueError, IndexError):
            return None

    # vmstat: max context switches/s (cs column), min free memory
    path = os.path.join(run_dir, "vmstat.log")
    if os.path.exists(path):
        cs_max, free_min = None, None
        with open(path) as f:
            header_idx = {}
            for line in f:
                parts = line.split()
                if "cs" in parts and "free" in parts:
                    header_idx = {name: i for i, name in enumerate(parts)}
                    continue
                if not header_idx or not parts or not parts[0].isdigit():
                    continue
                cs = _floats(parts, header_idx.get("cs", -1))
                fr = _floats(parts, header_idx.get("free", -1))
                if cs is not None:
                    cs_max = cs if cs_max is None else max(cs_max, cs)
                if fr is not None:
                    free_min = fr if free_min is None else min(free_min, fr)
        if cs_max is not None:
            out["max_context_switches_per_s"] = cs_max
        if free_min is not None:
            out["min_free_memory_kb"] = free_min

    # iostat -dx: peak read throughput (rkB/s column)
    path = os.path.join(run_dir, "iostat.log")
    if os.path.exists(path):
        peak = None
        with open(path) as f:
            col = None
            for line in f:
                parts = line.split()
                if parts and parts[0] == "Device":
                    for i, name in enumerate(parts):
                        if name.startswith("rkB/s"):
                            col = i
                    continue
                if col is None or not parts:
                    continue
                v = _floats(parts, col)
                if v is not None:
                    peak = v if peak is None else max(peak, v)
        if peak is not None:
            out["peak_disk_read_kb_per_s"] = peak

    # device_memory.jsonl: peak device memory in use
    path = os.path.join(run_dir, "device_memory.jsonl")
    if os.path.exists(path):
        peak = None
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                for key, val in row.items():
                    if key == "t" or not isinstance(val, dict):
                        continue
                    v = val.get("peak_bytes_in_use") or val.get("bytes_in_use")
                    if v:
                        peak = v if peak is None else max(peak, v)
        if peak is not None:
            out["peak_device_bytes_in_use"] = int(peak)

    out.update(summarize_nvidia_smi(
        read_nvidia_smi_log(os.path.join(run_dir, "nvidia_smi.log"))))
    return out
