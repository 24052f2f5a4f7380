"""A cell on N > 1 cards: one process a card, rank 0 the harness's own.

Rank 0 runs in the harness's process on the first card it is given
(``cuda:0``); ranks 1 .. N-1 are processes started with the spawn method,
rank r on ``cuda:r``. Each rank has the environment that a process of
``torchrun --nproc-per-node N`` has, which the port's
``parallel/mesh.py:initialize_distributed`` reads; rank 0 sets it on its
own process for the run and puts the old values back after it. The harness
does not join the program's process group: it speaks to each rank over a
pipe of its own. A rank builds ``Entry(config, inputs, device, seed,
rank=r, world=N)`` once, from the lane paths alone (the reference's arrays
stay with rank 0), and keeps it, its CUDA context and the program's
extensions for the whole run, as a one-card cell keeps its engine.

A job is one command to every rank: each runs ``entry.job`` on a directory
of its own, rank 0 on a thread of the harness, so that the harness waits
on every rank alike. A rank that raises, ends, or gives no answer within
the limit fails the job; every rank is then killed and reaped. A rank
dies with the harness's process, however that ends (``PR_SET_PDEATHSIG``),
and ends when its pipe closes.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import signal
import socket
import threading
import time
import traceback
from multiprocessing import connection

SETUP_LIMIT_S = 1000.0  # entries and the warm job; a first run builds
JOB_LIMIT_S = 120.0  # the least a job's answers are waited for
WARM_FACTOR = 4  # ... or this many times the slowest rank's warm job
STOP_S = 60.0  # for a rank to stop once asked, before it is killed
PR_SET_PDEATHSIG = 1  # <linux/prctl.h>
ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
       "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
       "LOCAL_WORLD_SIZE")


class RankFailure(RuntimeError):
    """A rank raised, ended, or gave no answer in time."""


def rank_env(rank: int, world: int, port: int, card: int) -> dict:
    """The environment of rank ``rank`` of ``world`` on card ``card``, as
    ``torchrun --nproc-per-node <world>`` gives it, with the coordinator
    the JAX package's CLI names."""
    return {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(card), "LOCAL_WORLD_SIZE": str(world)}


def rank_device(device, rank: int):
    """Rank ``rank``'s device: ``cuda:(rank mod the cards visible)``, which
    is ``cuda:rank`` where there are as many cards as ranks, or
    ``device`` itself off the card."""
    import torch

    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(entry, jobdir: str, mode: str, device, trace_path: str) -> dict:
    """One job of this rank, as a one-card cell runs it: ``mode`` "trace"
    under the profiler, "card" with its kernels' device time, "plain" or
    "warm" (its directory removed after it) alone. -> {"out", "wall"} and
    the trace or the kernel time, or {"error": traceback}."""
    import torch

    from benchmark import trace as tracing

    t0 = time.perf_counter()
    try:
        if mode == "trace":
            out, tr = tracing.traced(lambda: entry.job(jobdir), trace_path)
            answer = {"trace": tr}
        elif mode == "card":
            out, ks, n = tracing.kernel_seconds(lambda: entry.job(jobdir))
            answer = {"kernel_s": ks, "kernels": n}
        else:
            out = entry.job(jobdir)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            answer = {}
    except Exception:  # the rank reports the job failed
        return {"error": traceback.format_exc()}
    answer.update(out=out, wall=time.perf_counter() - t0)
    if mode == "warm":
        shutil.rmtree(jobdir)
    return answer


def gather(answers: list[dict]) -> dict:
    """What one job's answers (by rank) give the run: each rank's trace by
    rank, and the device time of the kernels of all ranks with their
    count."""
    return {"traces": {r: a["trace"] for r, a in enumerate(answers)
                       if a.get("trace") is not None},
            "kernel_s": sum(a.get("kernel_s", 0.0) for a in answers),
            "kernels": sum(a.get("kernels", 0) for a in answers)}


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when ``parent`` ends."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:  # it ended before the call above
        os._exit(1)


def serve(conn, rank: int, world: int, env: dict, entry_path: str,
          config: dict, inputs, device, seed: int, profiler: str | None,
          parent: int) -> None:
    """The main of rank ``rank`` (1 .. N-1): build the entry, then answer
    the harness's commands until it says stop or its pipe closes."""
    _die_with(parent)
    os.dup2(2, 1)  # a rank prints nothing to the result's stream
    os.environ.update(env)
    import torch

    from benchmark import run
    from benchmark import trace as tracing

    if device.type == "cuda":
        torch.cuda.set_device(device)
    failed = None
    try:
        entry = run.load_file(entry_path, "benchmark_rank_entry").Entry(
            config, inputs, device, seed, rank=rank, world=world)
        if profiler:
            tracing.warm_profiler(cpu=profiler == "cpu+cuda")
    except Exception:  # the answer to every job, the warm one first
        failed = {"error": traceback.format_exc()}
    while True:
        try:
            msg = conn.recv()
        except EOFError:  # the harness is gone
            return
        if msg[0] == "job":
            _, jobdir, mode, trace_path = msg
            conn.send(failed or run_job(entry, jobdir, mode, device,
                                        trace_path))
        elif msg[0] == "report":
            conn.send({"peak": (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0),
                       "loaded": run.forbidden_modules()})
        else:
            return


def _stop_resource_tracker() -> None:
    """Stop the resource tracker process that a spawn starts: it would
    outlive the run by a moment. The next spawn starts it again."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if tracker._pid is None:
        return
    if hasattr(tracker, "_stop"):
        tracker._stop()
    else:  # a Python without _stop: what it does
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


class Ranks:
    """Ranks 1 .. N-1 of a cell, each a process on its card, and rank 0's
    job thread in this process. A context manager: leaving it kills and
    reaps every rank, whatever happened."""

    def __init__(self, parts: dict, inputs, device, seed: int,
                 profiler: str | None):
        from benchmark import traffic

        self.world = parts["cell"]["chips"]
        self.device = device
        self.limit_s = SETUP_LIMIT_S
        self._closed = False
        self._thread: threading.Thread | None = None
        self._box: list = []
        self._done_r, self._done_w = multiprocessing.Pipe(duplex=False)
        port = free_port()
        cards = [rank_device(device, r) for r in range(self.world)]
        local = [r if c.index is None else c.index
                 for r, c in enumerate(cards)]
        self._saved = {k: os.environ.get(k) for k in ENV}
        os.environ.update(rank_env(0, self.world, port, local[0]))
        paths = traffic.Inputs(files=list(inputs.files), seqs=[], quals=[],
                               reference=inputs.reference)
        spawn = multiprocessing.get_context("spawn")
        self.conns, self.procs, self.pids = [], [], []
        try:
            for r in range(1, self.world):
                here, there = spawn.Pipe()
                p = spawn.Process(
                    target=serve, name=f"benchmark-rank{r}", daemon=True,
                    args=(there, r, self.world,
                          rank_env(r, self.world, port, local[r]),
                          str(parts["entry"]), parts["config"], paths,
                          cards[r], seed, profiler, os.getpid()))
                p.start()
                there.close()
                self.conns.append(here)
                self.procs.append(p)
                self.pids.append(p.pid)
        except BaseException:
            self.close(kill=True)
            raise

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=True)

    def _rank0(self, entry, jobdir, mode, trace_path) -> None:
        self._box.append(run_job(entry, jobdir, mode, self.device,
                                 trace_path))
        self._done_w.send(None)

    def job(self, entry, jobdir: str, mode: str) -> list[dict]:
        """Every rank's answer, by rank, to one job under ``jobdir``
        (rank r in ``jobdir/rank<r>``); raises RankFailure when a rank
        raised, ended, or gave no answer within the limit."""
        deadline = time.perf_counter() + self.limit_s
        dirs = [os.path.join(jobdir, f"rank{r}") for r in range(self.world)]
        traces = [os.path.join(os.path.dirname(jobdir), f"trace{r}.json")
                  for r in range(self.world)]
        for r, conn in enumerate(self.conns, 1):
            try:
                conn.send(("job", dirs[r], mode, traces[r]))
            except OSError:
                raise RankFailure(f"rank {r} ended") from None
        self._thread = threading.Thread(
            target=self._rank0, args=(entry, dirs[0], mode, traces[0]),
            name="benchmark-rank0", daemon=True)
        self._thread.start()
        answers: list = [None] * self.world
        pending = {self._done_r: 0}
        pending.update({c: r for r, c in enumerate(self.conns, 1)})
        ended = {p.sentinel: r for r, p in enumerate(self.procs, 1)}
        while pending:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise RankFailure(
                    f"rank(s) {sorted(pending.values())} gave no answer "
                    f"within {self.limit_s!r} s")
            waiting = set(pending.values())
            ready = connection.wait(
                [*pending, *(s for s, r in ended.items() if r in waiting)],
                timeout=left)
            for obj in ready:
                r = pending.pop(obj, None)
                if r is None:
                    continue
                try:
                    answer = obj.recv()
                except (EOFError, OSError):
                    raise RankFailure(f"rank {r} ended") from None
                answers[r] = self._box.pop() if r == 0 else answer
                if "error" in answers[r]:
                    raise RankFailure(
                        f"rank {r} raised:\n{answers[r]['error']}")
            for obj in ready:
                r = ended.get(obj)
                if r in pending.values():  # ended, its answer not sent
                    p = self.procs[r - 1]
                    p.join(1)
                    raise RankFailure(
                        f"rank {r} ended with exit code {p.exitcode}")
        return answers

    def warm(self, entry, jobdir: str, limit_s: float | None) -> list[dict]:
        """The warm job on every rank within the set-up's limit; then the
        limit of every later job: ``limit_s``, or the larger of
        ``JOB_LIMIT_S`` and ``WARM_FACTOR`` times the slowest warm job."""
        answers = self.job(entry, jobdir, "warm")
        slowest = max(a["wall"] for a in answers)
        self.limit_s = (limit_s if limit_s is not None
                        else max(JOB_LIMIT_S, WARM_FACTOR * slowest))
        return answers

    def reports(self) -> list[dict]:
        """Each rank process's peak device memory and the JAX modules it
        loaded: {"peak", "loaded"}, ranks 1 .. N-1."""
        out = []
        for r, conn in enumerate(self.conns, 1):
            conn.send(("report",))
            if not conn.poll(STOP_S):
                raise RankFailure(f"rank {r} gave no report")
            out.append(conn.recv())
        return out

    def close(self, kill: bool = False) -> None:
        """Stop every rank (asked first unless ``kill``), reap it, and put
        this process back as it was: the multiprocessing resource tracker
        the spawn started stopped, the program's process group that rank 0
        joined here destroyed, the environment restored. Once."""
        if self._closed:
            return
        self._closed = True
        for conn in self.conns:
            if not kill:
                try:
                    conn.send(("stop",))
                except OSError:  # the rank is gone
                    pass
        for p in self.procs:
            if not kill:
                p.join(STOP_S)
            if p.is_alive():
                p.kill()
            p.join()
        for conn in self.conns:
            conn.close()
        self.conns, self.procs = [], []
        _stop_resource_tracker()
        # rank 0's job, stuck in a collective with a peer now gone, ends
        if self._thread is not None:
            self._thread.join(STOP_S)
        if self._thread is None or not self._thread.is_alive():
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                dist.destroy_process_group()
            self._done_r.close()
            self._done_w.close()
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self._saved = {}
