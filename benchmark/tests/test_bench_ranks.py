"""A cell on several chips (ranks.py) on the CPU: ranks over gloo through
the test entry rank_entry.py, whose merged answer is correct and equals one
process's; a rank that raises, ends or hangs, and an exchange left out,
make the run not correct, within the limit, with no process left behind;
and what the result line gathers from every card, on stub traces."""

import json
import multiprocessing
import os
import time

import pytest

from benchmark import ranks, run, traffic
from benchmark.tests.test_bench_metrics import chrome
from benchmark.tests.tiny import CPU, on_ranks, tiny, tiny_ranks
from benchmark.trace import JOB_SPAN, Trace, breakdown, device_time
from mini_parallel_tpu_torch.parallel.distributed import plan_work

SEED = 2**31 + 4321
LIMIT_S = 10.0  # the wait for a job's answers in these tests


@pytest.fixture()
def two_threads_a_rank(monkeypatch):
    """Four ranks on the CPUs of a test host: each process computes on two
    threads, so that they do not crowd the cores."""
    import torch

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the rank processes'
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def spy(monkeypatch, two_threads_a_rank):
    """Rank 0's entry in this process, watched: its merged answers
    ("merged"), every job's answer ("jobs"), the rank processes' ids
    ("pids"), when the ranks were first closed ("closed", the host's
    clock); ``spy["drop"]`` drops those ranks' answers from the merge."""
    seen = {"merged": [], "jobs": [], "pids": [], "closed": [], "drop": ()}
    load = run.load_file

    def load_file(path, name):
        mod = load(path, name)
        inner_job, inner_merge = mod.Entry.job, getattr(mod.Entry, "merge",
                                                        None)

        def job(self, jobdir):
            out = inner_job(self, jobdir)
            seen["jobs"].append(out)
            return out

        def merge(self, outs):
            outs = [o for r, o in enumerate(outs) if r not in seen["drop"]]
            seen["merged"].append(inner_merge(self, outs))
            return seen["merged"][-1]

        mod.Entry = type("Entry", (mod.Entry,), {"job": job, "merge": merge})
        return mod

    enter = ranks.Ranks.__enter__

    def enter_and_see(self):
        seen["pids"] += self.pids
        return enter(self)

    close = ranks.Ranks.close

    def close_and_see(self, kill=False):
        close(self, kill)
        seen["closed"].append(time.perf_counter())

    monkeypatch.setattr(run, "load_file", load_file)
    monkeypatch.setattr(ranks.Ranks, "__enter__", enter_and_see)
    monkeypatch.setattr(ranks.Ranks, "close", close_and_see)
    return seen


def answers_by_file(files):
    return {os.path.basename(f[0]): f[1:] for f in files}


def assert_no_process_left(pids):
    assert multiprocessing.active_children() == []
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    from multiprocessing import resource_tracker

    assert resource_tracker._resource_tracker._pid is None


@pytest.mark.parametrize("world,files,shared", [
    (4, 8, 0),  # every file one rank's alone
    (4, 2, 2),  # each file striped across all four ranks
    (2, 3, 0),  # two files on one rank, one on the other
])
def test_ranks_give_one_process_answer(world, files, shared, spy, tmp_path):
    parts = tiny_ranks(world, files)
    inputs = traffic.generate(parts["config"]["sample"], parts["traffic"],
                              SEED, str(tmp_path / "in"))
    plan = plan_work(inputs.files, world, sizes={
        f: os.path.getsize(f) for f in inputs.files})
    assert len(plan.shared) == shared
    res, walls, loaded = run.run_cell(parts, SEED, 0.2, False, CPU,
                                      limit_s=LIMIT_S)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and loaded == [] and walls
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert_no_process_left(spy["pids"])
    assert len(spy["pids"]) == world - 1
    merged = spy["merged"][-1]["files"]
    assert len(merged) == files

    one = tiny("wgs_sw.lanes_gz")  # the same lanes, one process
    one["config"]["sample"].update(lanes=files, reads_per_lane=1)
    spy["jobs"].clear()
    single, _, _ = run.run_cell(one, SEED, 0.2, False, CPU)
    assert single["correct"]
    # each file's reads, bases, chunks, failed chunks and score
    assert answers_by_file(merged) == answers_by_file(
        spy["jobs"][-1]["files"])


@pytest.mark.parametrize("fault", [
    {"rank": 1, "job": 1, "kind": "raise"},
    {"rank": 0, "job": 1, "kind": "raise"},
    {"rank": 1, "job": 1, "kind": "exit"},
    {"rank": 2, "job": 1, "kind": "sleep", "seconds": 3600},
], ids=["raise", "rank0-raise", "exit", "sleep"])
def test_a_failing_rank_fails_the_run_and_leaves_nothing(fault, spy,
                                                         capsys):
    t0 = time.perf_counter()
    res, _, _ = run.run_cell(tiny_ranks(4, 2, fault), SEED, 0.2, False, CPU,
                             t_start=t0, limit_s=LIMIT_S)
    assert not res["correct"]
    assert res["failed"] > 0 and res["attempted"] >= res["failed"]
    # from the window's start until every rank is reaped (the plain
    # reference on the CPU after it is not the harness's wait)
    setup_end = t0 + res["metrics"]["setup_s"]["value"]
    assert spy["closed"][0] - setup_end < LIMIT_S + 30
    assert_no_process_left(spy["pids"])
    assert len(spy["pids"]) == 3
    err = capsys.readouterr().err
    assert f"rank {fault['rank']}" in err or "gave no answer" in err
    assert "JAX_COORDINATOR_ADDRESS" not in os.environ


def test_an_exchange_left_out_is_not_correct(spy):
    """Rank 0 merges without rank 1's answer: its files or stripes are
    missing from the job's answer."""
    spy["drop"] = (1,)
    res, _, _ = run.run_cell(tiny_ranks(2, 2), SEED, 0.2, False, CPU,
                             limit_s=LIMIT_S)
    assert not res["correct"]
    assert res["checks"]["reads_gap"]["value"] > 0
    assert_no_process_left(spy["pids"])


def stub_trace(shift_ms: float, window_ms: float = 10.0) -> Trace:
    """The synthetic 10 ms job of test_bench_metrics with its kernels
    moved by ``shift_ms`` and its window stretched to ``window_ms``."""
    ev = []
    for e in chrome():
        e = dict(e)
        if e["name"] == JOB_SPAN:
            e["dur"] = window_ms * 1000.0
        elif e["cat"] == "kernel" and e["name"] != "outside":
            e["ts"] += shift_ms * 1000.0
        ev.append(e)
    return Trace.from_chrome(ev)


def test_device_readings_are_gathered_from_every_card():
    t0, t1 = stub_trace(0.0), stub_trace(2.0, window_ms=20.0)
    answers = [{"out": {}, "wall": 1.0, "trace": t0, "kernel_s": 0.002,
                "kernels": 4},
               {"out": {}, "wall": 1.5, "trace": t1, "kernel_s": 0.003,
                "kernels": 5}]
    got = ranks.gather(answers)
    assert got["traces"] == {0: t0, 1: t1}
    assert got["kernel_s"] == pytest.approx(0.005) and got["kernels"] == 9
    dt = device_time(got["traces"].values())
    assert dt["busy_s"] == pytest.approx(t0.busy_s() + t1.busy_s())
    assert dt["window_s"] == pytest.approx(0.030)
    bd = breakdown([t0, t1])
    ops = dict(bd["device_ops"])
    assert ops["void sw_score_kernel<5>()"] == pytest.approx(0.004)
    assert ops["Memcpy HtoD"] == pytest.approx(0.002)
    gaps = dict(bd["idle_gaps"])
    one = [dict(t.breakdown()["idle_gaps"]) for t in (t0, t1)]
    for label in gaps:
        assert gaps[label] == pytest.approx(sum(o.get(label, 0.0)
                                                for o in one))
    # one card: the sums are that card's own readings, unchanged
    assert breakdown([t0]) == t0.breakdown()
    assert device_time([t0]) == {"busy_s": t0.busy_s(),
                                 "window_s": t0.window_s}


class StubRanks:
    """Rank 1 stood in: rank 0 runs the whole job in this process (no
    process group), rank 1 answers for no file; each answers with a stub
    trace and kernel time, and rank 1 reports a stub peak memory (rank 0's
    on the CPU is 0)."""

    TRACES = (stub_trace(0.0), stub_trace(2.0, window_ms=20.0))
    PEAK = 9_000

    def __init__(self, parts, inputs, device, seed, profiler):
        self.pids = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def job(self, entry, jobdir, mode):
        out = entry.job(os.path.join(jobdir, "rank0"))
        return [{"out": out, "wall": 1.0, "trace": self.TRACES[0],
                 "kernel_s": 0.002, "kernels": 4},
                {"out": {"files": [], "spans": {}}, "wall": 1.0,
                 "trace": self.TRACES[1], "kernel_s": 0.003, "kernels": 5}]

    def warm(self, entry, jobdir, limit_s):
        return self.job(entry, jobdir, "warm")

    def reports(self):
        return [{"peak": self.PEAK, "loaded": ["jax (stub)"]}]

    def close(self, kill=False):
        pass


def test_the_result_line_sums_the_cards(monkeypatch):
    monkeypatch.setattr(ranks, "Ranks", StubRanks)
    res, _, loaded = run.run_cell(tiny_ranks(2, 2), SEED, 0.2, True, CPU)
    assert res["correct"], res["checks"]
    t0, t1 = StubRanks.TRACES
    assert res["device"]["busy_s"] == pytest.approx(t0.busy_s()
                                                    + t1.busy_s())
    assert res["device"]["window_s"] == pytest.approx(0.030)
    assert res["breakdown"] == breakdown([t0, t1])
    assert res["device"]["memory_peak_bytes"] == StubRanks.PEAK
    assert loaded == ["jax (stub) (rank 1)"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]


@pytest.mark.cuda
def test_ranks_on_the_cards(cuda_device):
    """Four ranks at the ``wgs_sw.lanes_gz`` cell's own size, rank r on
    ``cuda:(r mod the cards visible)``, untraced with the card time of every
    rank and traced: each correct, each card read. Prints each result."""
    import torch

    spec = run.load_spec()
    parts = on_ranks(run.resolve(spec, "wgs_sw.lanes_gz"), 4)
    parts["end_to_end"] += [m for m in spec["end_to_end"]
                            if m["name"] == "card_ms_per_mreads"]
    print(json.dumps({"cards": torch.cuda.device_count(),
                      "cpus": len(os.sched_getaffinity(0))}))
    for trace in (False, True):
        res, walls, loaded = run.run_cell(parts, 2**31 + 2027 + trace, 5.0,
                                          trace, cuda_device)
        print(json.dumps(res))
        # rank 0 is this process: its reference's peak is not the next
        # run's
        torch.cuda.reset_peak_memory_stats(cuda_device)
        assert res["correct"], res["checks"]
        assert res["device"]["count"] == 4 and loaded == []
        assert res["device"]["memory_peak_bytes"] > 0
        if trace:
            assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
            assert res["breakdown"]["device_ops"]
        else:
            assert res["metrics"]["card_ms_per_mreads"]["value"] > 0
    assert multiprocessing.active_children() == []
