"""The device trace of one job: torch.profiler (CUPTI) over the job, its
Chrome trace read back, and what the metric readers need from it.

:class:`Trace` holds the device operations (kernels, copies, sets) and the
host events of the traced window, which is the benchmark's own
``bench.job`` span. Times are seconds from the window's start.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

JOB_SPAN = "bench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    window_s: float
    # (name, category, start s, duration s) of each device operation
    device: list[tuple[str, str, float, float]] = field(default_factory=list)
    # (name, start s, duration s) of each host op and annotation
    host: list[tuple[str, float, float]] = field(default_factory=list)

    @classmethod
    def from_chrome(cls, events: list[dict]) -> "Trace":
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == JOB_SPAN]
        if len(spans) != 1:
            raise ValueError(f"{len(spans)} {JOB_SPAN} spans in the trace")
        t0 = float(spans[0]["ts"])
        t1 = t0 + float(spans[0]["dur"])
        out = cls(window_s=(t1 - t0) * 1e-6)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if ts + dur < t0 or ts > t1:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                out.device.append((e["name"], cat, (ts - t0) * 1e-6,
                                   dur * 1e-6))
            elif cat in HOST_CATS and e["name"] != JOB_SPAN:
                out.host.append((e["name"], (ts - t0) * 1e-6, dur * 1e-6))
        return out

    def intervals(self) -> np.ndarray:
        """(n, 2) merged [start, end) of every device operation, clipped to
        the window."""
        if not self.device:
            return np.zeros((0, 2))
        iv = np.array([(s, s + d) for _, _, s, d in self.device])
        iv = np.clip(iv, 0.0, self.window_s)
        iv = iv[np.argsort(iv[:, 0])]
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.array(merged)

    def busy_s(self) -> float:
        iv = self.intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) if iv.size else 0.0

    def kernel_s(self, contains: str = "") -> float:
        """Summed device time of the kernels whose name holds
        ``contains``."""
        return sum(d for n, c, _, d in self.device
                   if c == "kernel" and contains in n)

    def launches(self) -> int:
        return len(self.device)

    def gaps(self) -> list[tuple[float, float]]:
        """[start, end) of each stretch of the window with no device
        operation."""
        iv = self.intervals()
        edges = [0.0, *iv.reshape(-1).tolist(), self.window_s]
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def host_labels(self, times: list[float]) -> list[str]:
        """What the host was doing at each of ``times``: the benchmark's
        span and the innermost torch op around it, or no torch op at all
        (Python, NumPy, or the program's native code)."""
        if not self.host:
            return ["host: no torch op"] * len(times)
        names = [n for n, _, _ in self.host]
        start = np.array([s for _, s, _ in self.host])
        dur = np.array([d for _, _, d in self.host])
        out = []
        for t in times:
            around = np.flatnonzero((start <= t) & (t < start + dur))
            if around.size == 0:
                out.append("host: no torch op")
                continue
            outer = names[around[np.argmax(dur[around])]]
            inner = names[around[np.argmin(dur[around])]]
            out.append(outer if outer == inner else f"{outer} > {inner}")
        return out

    def op_seconds(self) -> dict[str, float]:
        """The device time of each device operation's name."""
        by_op: dict[str, float] = {}
        for n, _, _, d in self.device:
            by_op[n] = by_op.get(n, 0.0) + d
        return by_op

    def gap_seconds(self) -> dict[str, float]:
        """The idle seconds of the window by what the host was doing in
        the middle of each gap."""
        by_gap: dict[str, float] = {}
        gaps = self.gaps()
        for (a, b), label in zip(gaps, self.host_labels(
                [(a + b) / 2 for a, b in gaps])):
            by_gap[label] = by_gap.get(label, 0.0) + (b - a)
        return by_gap

    def breakdown(self) -> dict:
        return breakdown([self])


def _summed(tables) -> list[list]:
    """The ``TOP`` largest entries of the name-to-seconds ``tables``,
    each name's seconds summed over the tables."""
    total: dict[str, float] = {}
    for table in tables:
        for name, s in table.items():
            total[name] = total.get(name, 0.0) + s
    return [[n, s] for n, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def breakdown(traces) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing in the middle of each, each name's
    seconds summed over ``traces`` (one a card)."""
    traces = list(traces)
    return {"device_ops": _summed(t.op_seconds() for t in traces),
            "idle_gaps": _summed(t.gap_seconds() for t in traces)}


def device_time(traces) -> dict:
    """``busy_s`` and ``window_s`` summed over ``traces`` (one a card), so
    that 1 - busy_s / window_s is the cards' mean idle share."""
    traces = list(traces)
    return {"busy_s": sum(t.busy_s() for t in traces),
            "window_s": sum(t.window_s for t in traces)}


KERNEL_ACTIVITY = 5  # libkineto's ActivityType::CONCURRENT_KERNEL
NOT_KERNELS = ("Memcpy", "Memset")  # CUPTI's names of copies and sets


def is_kernel(e) -> bool:
    """Whether a profiler record is a kernel run on the device: by its
    activity type where torch gives it, else a device record that is no
    copy, set or annotation."""
    if hasattr(e, "activity_type"):
        return e.activity_type() == KERNEL_ACTIVITY
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith(NOT_KERNELS)
            and not getattr(e, "is_user_annotation", lambda: False)())


def warm_profiler(cpu: bool = True) -> None:
    """Start and stop the profiler once, so that CUPTI's first start falls
    in set-up and not in the window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def kernel_seconds(fn):
    """(fn(), the summed device time of the kernels it ran, the number of
    those kernels): CUPTI's kernel records, read from the profiler's own
    results without a Chrome trace. Copies and sets are left out: the
    device time of a copy from pageable host memory includes the host's
    staging, so it reads the host's load."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ns, n = 0, 0
    for e in prof.profiler.kineto_results.events():
        if is_kernel(e):
            ns += e.duration_ns()
            n += 1
    return out, ns * 1e-9, n


def traced(fn, path: str):
    """(fn(), Trace) with the profiler on around ``fn`` inside the
    ``bench.job`` span; the Chrome trace is written to ``path`` and read
    back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(JOB_SPAN):
            out = fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    return out, Trace.from_chrome(events)
