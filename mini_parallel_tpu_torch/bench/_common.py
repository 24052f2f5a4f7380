"""Shared parts of the bench modules: the device flag, the card fields, the
card and host timers, the kernel launch counts, the watchdog and the JSON
emitter.

Every row a module prints carries ``device: {"name", "power_limit_w",
"nvidia_smi"}`` (the card as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints it; ``"cpu"`` and null on the CPU) and
``correct``. A module exits 1 when a row is not correct, 2 without CUDA
unless the caller asked for the CPU, and 3 when the watchdog fires.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time

import torch

from mini_parallel_tpu_torch.device import (
    NoAcceleratorError,
    nvidia_smi_line,
    require_cuda,
)

# The reference's only stated performance target: "sub-200 ms processing"
# per 10k-read chunk (improvements.txt:61), which it did not reach.
REFERENCE_TARGET_MS = 200.0
REPEATS = 5  # card-timer runs a row reports the median, min and max of
DEFAULT_TIMEOUT_S = 1800.0


def add_common_flags(ap, cpu_flag: bool = False) -> None:
    """``--device cuda|cpu`` (``--cpu`` where the JAX script has that flag)
    and ``--out FILE``."""
    if cpu_flag:
        ap.add_argument("--cpu", action="store_true",
                        help="run on the CPU (8 CPU shards)")
    else:
        ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write every row to this file as a JSON list")


def bench_device(args) -> torch.device:
    """The card (``cuda:<current>``) unless the arguments ask for the CPU.
    Raises NoAcceleratorError without CUDA: nothing falls back."""
    if getattr(args, "cpu", False) or getattr(args, "device", "cuda") == "cpu":
        return torch.device("cpu")
    require_cuda()
    return torch.device("cuda", torch.cuda.current_device())


def card_fields(device: torch.device) -> dict:
    """The ``device`` field of every row."""
    if device.type == "cpu":
        return {"name": "cpu", "power_limit_w": None, "nvidia_smi": None}
    line = nvidia_smi_line()
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    try:
        watts = float(limit.split()[0])
    except (IndexError, ValueError):  # "[N/A]" on a card without a limit
        watts = None
    return {"name": name, "power_limit_w": watts, "nvidia_smi": line}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_times(fn, device: torch.device, launches: int = 1,
               repeats: int = REPEATS) -> dict:
    """ms per call of ``fn``: one warm-up call, then ``repeats`` runs of
    ``launches`` back-to-back calls, each run timed by CUDA events around
    it (chip_smoke.py's ``time_samples``); on the CPU by the host clock.
    -> {"ms" (the median), "min_ms", "max_ms", "samples", "launches",
    "timer"}."""
    fn()
    synchronize(device)
    samples = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / launches)
        else:
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / launches)
    return {"ms": statistics.median(samples), "min_ms": min(samples),
            "max_ms": max(samples),
            "samples": len(samples), "launches": launches,
            "timer": "cuda_events" if device.type == "cuda" else "host_clock"}


def host_clock(fn, device: torch.device):
    """(fn(), seconds): the host clock around ``fn`` and a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by kernel name; each counts its
    launches in ``launches``."""
    from mini_parallel_tpu_torch.ops import pairhmm_cuda, sw_cuda, sw_long
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    return {"sw_score": sw_cuda.sw_score_batch_cuda,
            "sw_affine_score": sw_cuda.sw_affine_batch_cuda,
            "sw_vs_ref": sw_cuda.sw_vs_ref_batch_cuda,
            "sw_moves": tbc.sw_moves_batch_cuda,
            "sw_affine_moves": tbc.sw_affine_moves_batch_cuda,
            "pairhmm": pairhmm_cuda.pairhmm_batch_cuda,
            "pairhmm_f64": pairhmm_cuda.pairhmm_f64_batch_cuda,
            "sw_long": sw_long.sw_strip_cuda,
            "sw_long_affine": sw_long.sw_affine_strip_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def launched_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a :func:`launch_counts`),
    with their launch counts."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


class Watchdog:
    """After MPT_BENCH_TIMEOUT seconds (default 1800) without
    :meth:`cancel`, print the row of ``metric`` with value null and an
    error, kill the processes in ``children`` and exit with 3: a hung
    device leaves a record instead of silence (bench.py's watchdog)."""

    def __init__(self, metric: str, unit: str):
        self.metric, self.unit = metric, unit
        self.card: dict | None = None
        self.children: list = []  # subprocess.Popen objects to kill
        self.budget = float(os.environ.get("MPT_BENCH_TIMEOUT",
                                           DEFAULT_TIMEOUT_S))
        self._timer = threading.Timer(self.budget, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def _fire(self) -> None:
        for p in self.children:
            p.kill()
        print(json.dumps({
            "metric": self.metric, "value": None, "unit": self.unit,
            "error": f"no measurement after {self.budget:.0f} s",
            "device": self.card, "correct": False}), flush=True)
        os._exit(3)

    def cancel(self) -> None:
        self._timer.cancel()


class Emitter:
    """Prints each row as one JSON line with the card fields, keeps it for
    ``--out``; :meth:`finish` writes the file and gives the exit code."""

    def __init__(self, card: dict, out: str | None = None):
        self.card, self.out = card, out
        self.rows: list[dict] = []

    def emit(self, row: dict) -> dict:
        """Print ``row`` (which holds ``correct``) with the card fields
        before ``correct``; -> the printed row."""
        row = dict(row)
        correct = bool(row.pop("correct"))
        row.update(device=self.card, correct=correct)
        self.rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    def finish(self) -> int:
        if self.out:
            with open(self.out, "w") as f:
                json.dump(self.rows, f, indent=1)
        return 0 if all(r["correct"] for r in self.rows) else 1


def run(main, name: str, cpu_flag: str = "--device cpu", argv=None) -> int:
    """``main(argv)``'s exit code; without CUDA (and without the CPU asked
    for) one error line on stderr and 2."""
    try:
        return main(argv)
    except NoAcceleratorError:
        print(f"{name}: CUDA is not available; pass {cpu_flag} to run on "
              "the CPU", file=sys.stderr)
        return 2
