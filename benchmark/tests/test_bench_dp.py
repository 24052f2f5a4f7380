"""The ``wgs_dp4`` configuration on the CPU: its entry (entries/
full_wgs_dp.py) on four ranks over gloo is correct, and not correct once a
rank's merged totals are altered; its control fails; and the readers of
every rank's spans (rank_spans.py and the three metrics that use it) on a
synthetic two-rank trace, and on traces without the spans they read."""

import copy
import multiprocessing

import pytest
import torch

from benchmark import run, traffic
from benchmark.tests.test_bench_spans import _chrome
from benchmark.tests.tiny import CPU
from benchmark.trace import Trace

SEED = 2**31 + 8765
LIMIT_S = 10.0  # the wait for a job's answers in these tests
CELL = "wgs_dp4.lanes_gz"


def tiny_dp(lanes: int = 4) -> dict:
    """The cell with its sample cut: ``2 * lanes`` files of 300 reads in
    128-read chunks (each of four ranks runs two files)."""
    parts = copy.deepcopy(run.resolve(run.load_spec(), CELL))
    parts["config"]["sample"].update(lanes=lanes, reads_per_file=300)
    parts["config"]["engine"]["chunk_size_reads"] = 128
    return parts


@pytest.fixture()
def alter(monkeypatch):
    """Rank 0's entry in this process with its merge watched: the merged
    answers in ``seen["merged"]``; ``seen["rank"]``, where set, is the
    rank whose totals are altered before the merge. Each rank process
    computes on two threads, and this process's are put back after."""
    seen = {"merged": [], "rank": None}
    load = run.load_file

    def load_file(path, name):
        mod = load(path, name)
        inner = mod.Entry.merge

        def merge(self, outs):
            if seen["rank"] is not None:
                outs = copy.deepcopy(outs)
                outs[seen["rank"]]["totals"][0][1] += 1  # one read more
            seen["merged"].append(inner(self, outs))
            return seen["merged"][-1]

        mod.Entry = type("Entry", (mod.Entry,), {"merge": merge})
        return mod

    monkeypatch.setattr(run, "load_file", load_file)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    yield seen
    torch.set_num_threads(threads)


def test_four_ranks_are_correct(alter):
    res, walls, loaded = run.run_cell(tiny_dp(), SEED, 0.2, False, CPU,
                                      limit_s=LIMIT_S)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and loaded == [] and walls
    assert set(res["metrics"]) == {"setup_s"}  # card time needs the card
    assert {"totals_gap", "totals_disagree"} <= set(res["checks"])
    merged = alter["merged"][-1]
    assert len(merged["files"]) == 8 and len(merged["totals"]) == 4
    assert all(t == merged["totals"][0] for t in merged["totals"])
    assert merged["totals"][0][:3] == [8, 8 * 300, 8 * 300 * 150]
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("rank,numbers", [
    (0, {"totals_gap", "totals_disagree"}),
    (2, {"totals_disagree"}),
])
def test_a_ranks_altered_totals_are_not_correct(alter, rank, numbers):
    alter["rank"] = rank
    res, _, _ = run.run_cell(tiny_dp(), SEED, 0.2, False, CPU,
                             limit_s=LIMIT_S)
    assert not res["correct"]
    failing = {n for n, c in res["checks"].items()
               if c["value"] > c["limit"]}
    assert failing == numbers


def test_control_fails_program_passes(tmp_path):
    """One process (no group), as benchmark/control.py runs an entry: the
    program passes every number; the control, scores in saturating 8-bit
    integers, fails the scores and the totals they add up to."""
    parts = tiny_dp(lanes=1)
    config = parts["config"]
    entry = run.load_file(parts["entry"], "dp_entry").Entry(
        config, traffic.generate(config["sample"], parts["traffic"], 77,
                                 str(tmp_path / "in")), CPU, 77)
    out = entry.job(str(tmp_path / "job"))
    ref = entry.reference()
    ctl = entry.control(ref, str(tmp_path / "control"), [out])
    assert [n for n, v, lim in entry.check([out], ref) if v > lim] == []
    assert [n for n, v, lim in entry.check(ctl, ref) if v > lim] == [
        "score_gap", "totals_gap"]


# two ranks' traced jobs: rank 0's 10 ms, rank 1's 10 ms with its own waits
RANK0 = [("process_full_wgs_dataset", 0.0, 10.0),  # the benchmark's own
         ("wgs.dist.sizes", 0.0, 0.5), ("wgs.dist.plan", 0.5, 0.1),
         ("align.file", 1.0, 8.0), ("fastq.wait", 1.0, 2.0),
         ("align.chunk", 3.0, 1.0), ("align.pack", 3.0, 0.3),
         ("align.chunk", 4.0, 1.0), ("align.pack", 4.0, 0.2),
         ("wgs.dist.merge", 9.0, 1.0)]
RANK1 = [("process_full_wgs_dataset", 0.0, 10.0),
         ("wgs.dist.sizes", 0.0, 1.5), ("wgs.dist.plan", 1.5, 0.1),
         ("align.file", 2.0, 7.5), ("fastq.wait", 2.0, 1.0),
         ("align.chunk", 3.0, 2.0), ("align.pack", 3.0, 0.5),
         ("wgs.dist.merge", 9.5, 0.5)]


def two_ranks(*jobs) -> run.Context:
    traces = {r: Trace.from_chrome(_chrome(job)) for r, job in enumerate(jobs)}
    return run.Context(trace=traces[0], traces=traces,
                       traced_by_rank=[{"rank": 0, "chunks": 2},
                                       {"rank": 1, "chunks": 1}])


def metric(name):
    return run.metric_reader(name)


def test_each_rank_reader_on_two_ranks():
    ctx = two_ranks(RANK0, RANK1)
    # (0.5 + 1.0) + (1.5 + 0.5) ms of 20
    assert metric("merge_wait_share")(ctx) == pytest.approx(3.5 / 20)
    assert metric("rank_decode_wait_share")(ctx) == pytest.approx(3.0 / 20)
    # align.pack 0.3 + 0.2 + 0.5 ms over the ranks' three chunks
    assert metric("rank_pack_ms")(ctx) == pytest.approx(1.0 / 3)
    # rank 0 alone, as decode_wait_share reads it
    assert metric("decode_wait_share")(ctx) == pytest.approx(0.2)


NAMES = ("merge_wait_share", "rank_decode_wait_share", "rank_pack_ms")


@pytest.mark.parametrize("name", NAMES)
def test_rank_readers_return_nothing_without_their_spans(name):
    bench_only = [s for s in RANK0 if s[0] == "process_full_wgs_dataset"]
    assert metric(name)(two_ranks(bench_only, bench_only)) is None
    assert metric(name)(run.Context()) is None
    # a program without the wgs.dist spans (the parent's): the merge wait
    # has nothing to read, the decoder's waits and the packs do
    old = [s for s in RANK0 if not s[0].startswith("wgs.dist.")]
    value = metric(name)(two_ranks(old, old))
    assert (value is None) == (name == "merge_wait_share")
