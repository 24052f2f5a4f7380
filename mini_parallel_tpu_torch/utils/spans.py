"""Spans and counters inside the port: one in-memory recorder.

A span names a stretch of work on one thread: ``with span("align.pack",
chunk=i): ...``. Spans of one chunk carry the chunk's index in its stream
as ``chunk``, given or taken from the span they run in; a span in which the host waits for the device ends in
``.sync``. ``count(name, n)`` adds to a counter.

The recorder is off by default. Then :func:`span` checks one module
variable and whether a torch profiler is recording; with none, it returns
one shared no-op object and reads no clock. While a torch profiler records, every span
also opens ``torch.profiler.record_function(name)``, so the spans of the
threads the profiler captures sit in its trace beside the device's records,
on the trace's clock, whether the recorder is on or not.

:func:`start` turns the recorder on and :func:`stop` turns it off and
returns the :class:`Recording`: every span closed in between, with its
thread, its start and end by ``time.perf_counter_ns``, the span it ran in
(the innermost open span of its thread) and its chunk; the counters; and,
when a profiler was recording at :func:`start`, the clock anchor: the
``perf_counter_ns`` read inside a ``record_function("mptt.clock")``, which
places any span, of a thread the profiler did not capture too, on the
trace's clock (:func:`append_to_chrome_trace`). Nothing is written unless a
caller asks.

:func:`timed` is a span that reads the clock even when the recorder is off:
its ``seconds`` is its duration once it has closed, for the few timings the
program reports itself.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.profiler import record_function

ANCHOR = "mptt.clock"

_profiling = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_buffer: "_Buffer | None" = None  # the recording; None: the recorder is off


class Span(NamedTuple):
    id: int
    name: str
    thread: int  # the OS thread id, as the profiler's trace gives it
    start_ns: int
    end_ns: int
    parent: int | None  # id of the span it ran in, on the same thread
    chunk: int | None


class _Buffer:
    """What one recording gathers while it is on; its spans as plain
    tuples in :class:`Span`'s order."""

    def __init__(self):
        self.spans: list[tuple] = []
        self.counters: dict[str, int] = {}
        self.threads: dict[int, str] = {}
        self.anchor_ns: int | None = None


@dataclass
class Recording:
    spans: list[Span]
    counters: dict[str, int]
    threads: dict[int, str]  # OS thread id -> thread name
    # perf_counter_ns read inside the ANCHOR annotation; None when no
    # profiler recorded at start()
    anchor_ns: int | None = None

    def totals(self) -> dict[str, dict]:
        """{name: {"count", "seconds", "self_seconds"}}: each name's spans,
        their summed duration, and their summed self time (the duration
        less the part its child spans on the same thread cover)."""
        covered: dict[int, int] = {}
        for s in self.spans:
            if s.parent is not None:
                covered[s.parent] = (covered.get(s.parent, 0)
                                     + s.end_ns - s.start_ns)
        out: dict[str, dict] = {}
        for s in self.spans:
            t = out.setdefault(s.name, {"count": 0, "seconds": 0.0,
                                        "self_seconds": 0.0})
            dur = s.end_ns - s.start_ns
            t["count"] += 1
            t["seconds"] += dur * 1e-9
            t["self_seconds"] += (dur - covered.get(s.id, 0)) * 1e-9
        return out


# the recorder off and no profiler recording: one shared context that does
# nothing at all
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "chunk", "buffer", "start_ns", "end_ns", "parent",
                 "id", "_stack", "_tid", "_annotation")

    def __init__(self, name: str, chunk: int | None, buffer):
        self.name, self.chunk, self.buffer = name, chunk, buffer
        self._annotation = None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "_Span":
        if _profiling():
            self._annotation = record_function(self.name)
            self._annotation.__enter__()
        if self.buffer is not None:
            thread = _thread(self.buffer)
            stack = self._stack = thread.stack
            self._tid = thread.tid
            self.parent = None
            if stack:
                self.parent, chunk = stack[-1]
                if self.chunk is None:
                    self.chunk = chunk
            self.id = next(_ids)
            stack.append((self.id, self.chunk))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.buffer is not None:
            self._stack.pop()
            self.buffer.spans.append((
                self.id, self.name, self._tid, self.start_ns,
                self.end_ns, self.parent, self.chunk))
        if self._annotation is not None:
            self._annotation.__exit__(*exc)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _thread(buffer: _Buffer):
    """This thread's state in the recording ``buffer``: ``tid``, its OS
    thread id, read once (it costs a system call), and ``stack``, its open
    spans as (id, chunk)."""
    state = _local
    if getattr(state, "buffer", None) is not buffer:
        state.buffer, state.stack = buffer, []
        state.tid = threading.get_native_id()
        with _lock:
            buffer.threads[state.tid] = threading.current_thread().name
    return state


def span(name: str, chunk: int | None = None):
    """A context manager naming the work in its block; ``chunk``: the
    index of the chunk it works on in its stream, by default that of the
    span it runs in."""
    buffer = _buffer
    if buffer is None:
        if not _profiling():
            return _NOOP
        return record_function(name)
    return _Span(name, chunk, buffer)


def timed(name: str, chunk: int | None = None) -> _Span:
    """:func:`span` that times itself even with the recorder off: its
    ``seconds`` once it has closed."""
    return _Span(name, chunk, _buffer)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    buffer = _buffer
    if buffer is None:
        return
    with _lock:
        buffer.counters[name] = buffer.counters.get(name, 0) + n


def recording() -> bool:
    """Whether the recorder is on: a counter whose value costs work is
    computed only then."""
    return _buffer is not None


def start() -> None:
    """Turn the recorder on with nothing recorded. Under a recording torch
    profiler, also place the clock anchor in its trace."""
    global _buffer
    buffer = _Buffer()
    if _profiling():
        with record_function(ANCHOR):
            buffer.anchor_ns = time.perf_counter_ns()
    _buffer = buffer


def stop() -> Recording:
    """Turn the recorder off; -> what it recorded since :func:`start`. A
    span still open then is left out."""
    global _buffer
    buffer, _buffer = _buffer, None
    if buffer is None:
        raise RuntimeError("the span recorder is not on")
    with _lock:
        return Recording([Span._make(s) for s in buffer.spans],
                         dict(buffer.counters), dict(buffer.threads),
                         buffer.anchor_ns)


def append_to_chrome_trace(path: str, rec: Recording) -> int:
    """Append to the profiler's Chrome trace at ``path`` the spans of the
    threads the profiler did not capture, as complete events on their own
    thread, placed on the trace's clock by the anchor, and the counters as
    counter events at the trace's end. -> the spans appended. Without an
    anchor (no profiler recorded at start) only the counters go in."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    captured = {e.get("tid") for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cpu_op", "user_annotation")}
    pid = next((e["pid"] for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cpu_op", "user_annotation")), 0)
    anchor = next((e for e in events if e.get("ph") == "X"
                   and e.get("name") == ANCHOR), None)
    end_us = max((float(e["ts"]) + float(e.get("dur", 0)) for e in events
                  if e.get("ph") == "X"), default=0.0)
    added = 0
    if anchor is not None and rec.anchor_ns is not None:
        at_us = float(anchor["ts"]) + float(anchor.get("dur", 0)) / 2
        for tid in sorted(set(rec.threads) - captured):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": rec.threads[tid]}})
        for s in rec.spans:
            if s.thread in captured:
                continue
            events.append({
                "ph": "X", "cat": "user_annotation", "name": s.name,
                "pid": pid, "tid": s.thread,
                "ts": at_us + (s.start_ns - rec.anchor_ns) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {} if s.chunk is None else {"chunk": s.chunk}})
            added += 1
    for name, n in sorted(rec.counters.items()):
        events.append({"ph": "C", "name": name, "pid": pid, "ts": end_us,
                       "args": {"value": n}})
    with open(path, "w") as f:
        json.dump(trace, f)
    return added
