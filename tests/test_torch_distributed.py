"""The port's multi-process --full-wgs (mini_parallel_tpu_torch/parallel/
distributed.py) on the CPU, against the JAX package's
mini_parallel_tpu/parallel/distributed.py.

The work plan (round-robin shards, the size-aware LPT plan with shared
files), the chunk-strided stripes of a shared file with their owned-chunk
resume, the stripe retries and their persistent checkpoints, the process
group's environment contract, the card and CPU shares of the processes of
one node, two processes over gloo running the CLI's --full-wgs, whose
merged totals must equal the single-process run's, and four processes
through process_full_wgs_distributed, whose merged totals must equal a
plain self-score DP over every read, with their ``wgs.dist.*`` spans.
Every comparison is exact.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from benchmark.reference import sw_self
from mini_parallel_tpu.models.alignment import AlignmentEngine as JAlignment
from mini_parallel_tpu.parallel import distributed as jdist
from mini_parallel_tpu.utils.config import Config as JConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.parallel import distributed
from mini_parallel_tpu_torch.parallel.mesh import (
    cpu_share,
    initialize_distributed,
    local_card,
)
from mini_parallel_tpu_torch.utils.checkpoint import CheckpointState
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(tmp_path, **kw):
    base = dict(wgs_data_dir=str(tmp_path), sample_id="S", lanes=1,
                reads_per_lane=1, chunk_size_reads=4, read_pad=64)
    base.update(kw)
    return Config(**base)


def _lane(tmp_path, rng, n_reads, name="S_L001_R1_001.fastq.gz"):
    path = str(tmp_path / name)
    fastq.write_fastq(path, [random_dna(rng, 300) for _ in range(n_reads)])
    return path


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------


def test_shard_files_round_robin_matches_jax():
    files = [f"f{i}" for i in range(16)]
    shards = [distributed.shard_files(files, p, 3) for p in range(3)]
    assert shards == [jdist.shard_files(files, p, 3) for p in range(3)]
    assert sorted(sum(shards, [])) == sorted(files)  # an exact partition
    assert [len(s) for s in shards] == [6, 5, 5]
    assert shards[0][:2] == ["f0", "f3"]  # interleaved, not block-split
    assert distributed.shard_files(["a", "b"], 0, 1) == ["a", "b"]


@pytest.mark.parametrize("sizes,nproc", [
    ({"big": 10_000, "s1": 1_000, "s2": 1_000, "s3": 1_000}, 2),
    ({f"f{i}": s for i, s in enumerate([5, 5, 4, 4, 3, 3, 2, 2, 1, 1])}, 2),
    ({f"f{i}": s for i, s in enumerate([7, 1, 1, 9, 3, 0, 2, 8, 8])}, 3),
    ({"a": 1, "b": 1}, 1),
])
def test_plan_work_matches_jax(sizes, nproc):
    """The plan == the JAX package's on the same sizes, deterministic,
    and every file is planned exactly once."""
    files = list(sizes)
    plan = distributed.plan_work(files, nproc, sizes=sizes)
    jplan = jdist.plan_work(files, nproc, sizes=sizes)
    assert (plan.exclusive, plan.shared) == (jplan.exclusive, jplan.shared)
    assert distributed.plan_work(files, nproc, sizes=sizes) == plan
    assert sorted(sum(plan.exclusive, []) + plan.shared) == sorted(files)
    assert plan.makespan_bytes(sizes) == jplan.makespan_bytes(sizes)


def test_plan_work_skewed_lanes_within_15pct():
    """A 10:1 lane skew: the big file is striped and the makespan lands
    within 15% of the even split, where round-robin's is ~1.7x."""
    sizes = {"big": 10_000, "s1": 1_000, "s2": 1_000, "s3": 1_000}
    plan = distributed.plan_work(list(sizes), 2, sizes=sizes)
    assert plan.shared == ["big"]
    ideal = sum(sizes.values()) / 2
    assert plan.makespan_bytes(sizes) <= 1.15 * ideal
    rr = [sum(sizes[f] for f in distributed.shard_files(list(sizes), p, 2))
          for p in range(2)]
    assert max(rr) > 1.5 * ideal
    lpt = distributed.plan_work(
        [f"f{i}" for i in range(10)], 2,
        sizes={f"f{i}": s for i, s in enumerate([5, 5, 4, 4, 3, 3, 2, 2, 1,
                                                 1])})
    assert lpt.shared == [] and sorted(
        len(s) for s in lpt.exclusive) == [5, 5]


def test_merge_totals_and_sizes_in_one_process(tmp_path):
    t = distributed.DistributedTotals(2, 10, 100, 4, 1.5)
    assert distributed.merge_totals(t) == t
    f = tmp_path / "x"
    f.write_bytes(b"1234")
    assert distributed._agreed_sizes([str(f), str(tmp_path / "gone")], 1) \
        == {str(f): 4, str(tmp_path / "gone"): 1}


# ----------------------------------------------------------------------
# chunk stripes, retries, checkpoints
# ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["kadane", "sw"])
def test_chunk_stride_partitions_exactly(tmp_path, rng, mode):
    """The two stripes sum to the whole file, balanced within a chunk, and
    each equals the JAX package's stripe."""
    cfg = _cfg(tmp_path)
    path = _lane(tmp_path, rng, 37)  # 10 chunks, the last ragged
    eng = AlignmentEngine(cfg, mode=mode, device=CPU)
    full = eng.self_align_file(path)
    stripes = [eng.self_align_file(path, chunk_stride=(p, 2))
               for p in range(2)]
    for key in ("score", "total_reads", "total_bases", "chunks"):
        assert sum(getattr(s, key) for s in stripes) == getattr(full, key)
    assert abs(stripes[0].chunks - stripes[1].chunks) <= 1
    jeng = JAlignment(JConfig(**vars(cfg)), mode=mode)
    for p, s in enumerate(stripes):
        j = jeng.self_align_file(path, chunk_stride=(p, 2))
        assert (s.score, s.total_reads, s.total_bases, s.chunks) == \
            (j.score, j.total_reads, j.total_bases, j.chunks)


def test_chunk_stride_resume_owned_index_space(tmp_path, rng):
    """resume.chunks_done counts OWNED chunks under chunk_stride: resuming
    at 2 skips the first two owned chunks and seeds their totals."""
    cfg = _cfg(tmp_path)
    path = _lane(tmp_path, rng, 41)  # 11 chunks; stripe (1, 2) owns 5
    eng = AlignmentEngine(cfg, mode="kadane", device=CPU)
    full = eng.self_align_file(path, chunk_stride=(1, 2))
    head = {}
    eng.self_align_file(path, chunk_stride=(1, 2), checkpoint_every=2,
                        on_checkpoint=lambda r: head.setdefault(
                            "r", (r.chunks, r.score, r.total_bases,
                                  r.total_reads)))

    class Partial:
        pass

    p = Partial()
    p.chunks_done, p.score, p.total_bases, p.total_reads = head["r"]
    p.processing_time_ms = 0.0
    tail = eng.self_align_file(path, chunk_stride=(1, 2), resume=p)
    assert full.chunks == 5 and p.chunks_done == 2
    assert (tail.chunks, tail.score, tail.total_bases, tail.total_reads) == \
        (full.chunks, full.score, full.total_bases, full.total_reads)


def _crash_after(monkeypatch, n_checkpoints: int, times: int):
    """Make self_align_file checkpoint every owned chunk and raise after
    ``n_checkpoints`` of them, on its first ``times`` calls."""
    orig = AlignmentEngine.self_align_file
    calls = {"n": 0}

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > times:
            return orig(self, *a, **kw)
        inner, seen = kw["on_checkpoint"], {"c": 0}

        def boom(res):
            inner(res)
            seen["c"] += 1
            if seen["c"] == n_checkpoints:
                raise RuntimeError("transient")

        return orig(self, *a, **dict(kw, checkpoint_every=1,
                                     on_checkpoint=boom))

    monkeypatch.setattr(AlignmentEngine, "self_align_file", flaky)
    return calls


def test_stripe_with_retries_recovers(tmp_path, rng, monkeypatch):
    """A failure mid-stripe resumes from the in-memory owned-chunk
    checkpoint and completes exactly; with no retry left it raises."""
    cfg = _cfg(tmp_path)
    path = _lane(tmp_path, rng, 40)
    eng = AlignmentEngine(cfg, mode="kadane", device=CPU)
    want = eng.self_align_file(path, chunk_stride=(0, 2))
    calls = _crash_after(monkeypatch, 2, times=1)
    got = distributed._stripe_with_retries(eng, path, 0, 2, retries=1,
                                           echo=lambda *_: None)
    assert (got.score, got.total_reads, got.chunks) == \
        (want.score, want.total_reads, want.chunks)
    assert calls["n"] == 2
    _crash_after(monkeypatch, 1, times=5)
    with pytest.raises(RuntimeError, match="stripe 0/2 failed"):
        distributed._stripe_with_retries(eng, path, 0, 2, retries=1,
                                         echo=lambda *_: None)


def test_stripe_checkpoint_survives_process_restart(tmp_path, rng,
                                                    monkeypatch):
    """Stripe progress persists in a CheckpointState: a fresh process
    (no in-memory partial) resumes from the on-disk owned-chunk checkpoint,
    and the file format is the JAX package's."""
    cfg = _cfg(tmp_path)
    path = _lane(tmp_path, rng, 40)
    eng = AlignmentEngine(cfg, mode="kadane", device=CPU)
    want = eng.self_align_file(path, chunk_stride=(0, 2))
    state = CheckpointState(run_id="stripe_test", total_files=1,
                            directory=str(tmp_path))
    orig = AlignmentEngine.self_align_file
    _crash_after(monkeypatch, 2, times=1)
    with pytest.raises(RuntimeError, match="host died|transient"):
        distributed._stripe_with_retries(eng, path, 0, 2, retries=0,
                                         echo=lambda *_: None, state=state,
                                         file_index=0)
    monkeypatch.setattr(AlignmentEngine, "self_align_file", orig)
    state2 = CheckpointState.load("stripe_test", str(tmp_path))
    assert state2.get_file(0).chunks_done == 2
    from mini_parallel_tpu.utils.checkpoint import CheckpointState as JState

    assert JState.load("stripe_test", str(tmp_path)).get_file(
        0).chunks_done == 2
    got = distributed._stripe_with_retries(eng, path, 0, 2, retries=0,
                                           echo=lambda *_: None,
                                           state=state2, file_index=0)
    assert (got.score, got.total_reads, got.chunks) == \
        (want.score, want.total_reads, want.chunks)


def test_distributed_wgs_in_one_process_matches_jax(tmp_path, rng,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MPT_RESULTS_DIR", str(tmp_path / "results"))
    cfg = _cfg(tmp_path, sample_id="D", lanes=2, chunk_size_reads=5)
    reads = [random_dna(rng, 300) for _ in range(10)]
    for lane in (1, 2):
        fastq.write_fastq(str(tmp_path / f"D_L{lane:03d}_R1_001.fastq.gz"),
                          reads)
    (tmp_path / "port").mkdir()
    results, merged = distributed.process_full_wgs_distributed(
        AlignmentEngine(cfg, mode="kadane", device=CPU), cfg,
        checkpoint_dir=str(tmp_path / "port"), echo=lambda *_: None)
    jcfg = JConfig(**vars(cfg))
    _, jmerged = jdist.process_full_wgs_distributed(
        JAlignment(jcfg, mode="kadane"), jcfg,
        checkpoint_dir=str(tmp_path), echo=lambda *_: None)
    assert (merged.files, merged.reads, merged.bases, merged.score) == \
        (jmerged.files, jmerged.reads, jmerged.bases, jmerged.score) == \
        (2, 20, 6000, 8)
    assert len(results) == 2


def test_initialize_distributed_env_contract(monkeypatch, tmp_path):
    """No coordinator: single process. A coordinator without a world size
    or rank is an error (the CLI prints ERROR: and exits 1), never a
    guess."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    threads = torch.get_num_threads()
    assert initialize_distributed() is False
    assert torch.get_num_threads() == threads  # no group: no cap
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="rank"):
        initialize_distributed()
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="outside"):
        initialize_distributed()
    monkeypatch.delenv("JAX_PROCESS_ID")
    monkeypatch.chdir(tmp_path)
    out = []
    assert cli.main(["--full-wgs", "--allow-cpu"], echo=out.append) == 1
    assert out[-1].startswith("ERROR:")


# ----------------------------------------------------------------------
# the processes of one node: their cards and their CPUs
# ----------------------------------------------------------------------


@pytest.mark.parametrize("procs,share", [
    (None, None), ("1", None), ("4", 8), ("16", 2), ("64", 1),
])
def test_cpu_share_of_a_node(monkeypatch, procs, share):
    """On a stated 32 CPUs each of LOCAL_WORLD_SIZE processes takes its
    share for torch's threads; alone (LOCAL_WORLD_SIZE unset or 1) a
    process takes what it took before (None: no cap)."""
    if procs is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", procs)
    assert cpu_share(32) == share
    if share is not None:
        assert cpu_share() == max(1, len(os.sched_getaffinity(0))
                                  // int(procs))


def test_local_card(monkeypatch):
    """LOCAL_RANK, or the rank mod the cards; one beyond the visible cards
    is an error naming both; rank 0 warns where processes share a card."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert [local_card(r, 4) for r in range(6)] == [0, 1, 2, 3, 0, 1]
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert local_card(7, 4) == 2
    monkeypatch.setenv("LOCAL_RANK", "4")
    with pytest.raises(ValueError, match="LOCAL_RANK 4 .* 4 CUDA card"):
        local_card(0, 4)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")  # four ranks on one card
    with pytest.warns(UserWarning, match="4 processes .* 1 CUDA card"):
        assert local_card(0, 1) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert local_card(3, 1) == 0  # only rank 0 says it
        assert local_card(0, 4) == 0


# ----------------------------------------------------------------------
# two processes over gloo (tests/test_multiprocess.py)
# ----------------------------------------------------------------------

_WORKER = r"""
import json, os, sys
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.utils import perf_logger

# one monitor that always runs, so each rank's summary has a known value
perf_logger.MONITOR_CMDS = {"vmstat": [
    "sh", "-c", "printf ' r  b free cs\\n 1  0 4242 77\\n'; exec sleep 60"]}
os.environ["MPT_PERF_RECORD"] = "0"
out = []
rc = cli.main(["--full-wgs", "--mode", "kadane", "--allow-cpu", "--env",
               sys.argv[1]], echo=out.append)
json.dump({"rc": rc, "lines": out}, open(sys.argv[2], "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("lane_reads,shared", [((10, 10, 10, 10), 0),
                                               ((10, 5, 5, 60), 1)])
def test_two_process_full_wgs_over_gloo(tmp_path, rng, lane_reads, shared):
    """Two CLI processes, JAX_COORDINATOR_ADDRESS on localhost: both print
    the same Global totals, equal to the single-process run's; the files
    are partitioned, and a lane larger than half the data is striped by
    chunk over both. Each rank's benchmark row carries its monitor
    summary."""
    try:
        port = _free_port()
    except OSError as e:
        pytest.skip(f"cannot bind a local socket: {e}")
    data = tmp_path / "data"
    data.mkdir()
    for k, n in enumerate(lane_reads, 1):
        fastq.write_fastq(str(data / f"MP_L{k:03d}_R1_001.fastq.gz"),
                          [random_dna(rng, 300) for _ in range(n)])
    # set in the workers' environment too: a .env never overrides what an
    # earlier test's CLI run left in this process's environment
    run_env = {"WGS_DATA_DIR": str(data), "WGS_SAMPLE_ID": "MP",
               "WGS_LANES": str(len(lane_reads)), "WGS_READS_PER_LANE": "1",
               "GPU_CHUNK_SIZE_READS": "5", "MPT_MESH_SHAPE": ""}
    env_file = tmp_path / "mp.env"
    env_file.write_text("".join(f"{k}={v}\n" for k, v in run_env.items()))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for pid in range(2):
        d = tmp_path / f"p{pid}"
        d.mkdir()
        env = dict(os.environ, **run_env,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   MPT_RESULTS_DIR=str(d / "results"),
                   PYTHONPATH=os.pathsep.join([REPO] + sys.path))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(env_file), str(d / "out.json")],
            cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode(errors="replace")[-3000:]
    runs = [json.loads((tmp_path / f"p{pid}" / "out.json").read_text())
            for pid in range(2)]
    (tmp_path / "one").mkdir()
    cfg = Config(wgs_data_dir=str(data), sample_id="MP",
                 lanes=len(lane_reads), reads_per_lane=1, chunk_size_reads=5)
    _, local = distributed.process_full_wgs_distributed(
        AlignmentEngine(cfg, mode="kadane", device=CPU), cfg,
        checkpoint_dir=str(tmp_path / "one"), echo=lambda *_: None)
    reads = sum(lane_reads)
    assert (local.files, local.reads, local.bases) == (4, reads, 300 * reads)
    want = (f"Global totals: DistributedTotals(files={local.files}, "
            f"reads={local.reads}, bases={local.bases}, "
            f"score={local.score}, seconds_max=")
    local_files = []
    for pid, run in enumerate(runs):
        assert run["rc"] == 0
        (line,) = [ln for ln in run["lines"] if ln.startswith("Global")]
        assert line.startswith(want), line
        (host,) = [ln for ln in run["lines"]
                   if ln.startswith(f"[host {pid}/2] processing")]
        local_files.append(int(host.split()[3].split("/")[0]))
        assert (f"+ {shared} shared" in host) == bool(shared)
        print([ln for ln in run["lines"] if "onitor" in ln]); print(list((tmp_path / f"p{pid}").rglob("*")))
        (row,) = (tmp_path / f"p{pid}" / "results").glob(
            "run_*_benchmark_results.json")
        assert json.loads(row.read_text())["monitor_summary"] == {
            "max_context_switches_per_s": 77.0, "min_free_memory_kb": 4242.0}
    assert sum(local_files) + shared == 4


# ----------------------------------------------------------------------
# four processes of one node through process_full_wgs_distributed
# ----------------------------------------------------------------------

_RANK = r"""
import json, os, sys
import torch
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.parallel import distributed
from mini_parallel_tpu_torch.parallel.mesh import initialize_distributed
from mini_parallel_tpu_torch.utils import spans
from mini_parallel_tpu_torch.utils.config import Config

threads = torch.get_num_threads()
initialize_distributed()
cfg = Config(wgs_data_dir=sys.argv[1], sample_id="DP", lanes=int(sys.argv[2]),
             reads_per_lane=1, chunk_size_reads=5, mode="sw")
spans.start()
results, merged = distributed.process_full_wgs_distributed(
    AlignmentEngine(cfg, mode="sw", device=torch.device("cpu")), cfg,
    checkpoint_dir=os.getcwd(), echo=lambda *_: None)
rec = spans.stop()
names = {s.id: s.name for s in rec.spans}
json.dump({"threads": [threads, torch.get_num_threads()],
           "merged": [merged.files, merged.reads, merged.bases, merged.score],
           "files": [(r.file_path, r.total_reads, r.total_bases, r.score)
                     for r in results],
           "spans": [(s.name, names.get(s.parent)) for s in rec.spans],
           "counters": rec.counters}, open(sys.argv[3], "w"))
"""


@pytest.mark.parametrize("lane_reads,shared", [((8,) * 8, 0),
                                               ((8, 4, 4, 4, 4, 40), 1)],
                         ids=["equal", "skewed"])
def test_four_processes_of_a_node_over_gloo(tmp_path, rng, lane_reads,
                                            shared):
    """Four processes of one node (LOCAL_WORLD_SIZE 4), equal lanes and a
    lane large enough to be striped over all four: every rank's merged
    totals equal the plain self-score DP's sums over every read, each file
    counted once; each rank caps torch's threads at its share of the
    CPUs; and its ``wgs.dist.*`` spans and counters
    are recorded, a stripe's file spans inside its ``wgs.dist.stripe``."""
    try:
        port = _free_port()
    except OSError as e:
        pytest.skip(f"cannot bind a local socket: {e}")
    data = tmp_path / "data"
    data.mkdir()
    seqs = []
    for k, n in enumerate(lane_reads, 1):
        reads = [random_dna(rng, 100) for _ in range(n)]
        fastq.write_fastq(str(data / f"DP_L{k:03d}_R1_001.fastq.gz"), reads)
        seqs.append(np.frombuffer(bytearray(b"".join(reads)),
                                  np.uint8).reshape(n, 100))
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    procs = []
    for pid in range(4):
        d = tmp_path / f"p{pid}"
        d.mkdir()
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="4", JAX_PROCESS_ID=str(pid),
                   LOCAL_RANK=str(pid), LOCAL_WORLD_SIZE="4",
                   MPT_RESULTS_DIR=str(d / "results"),
                   PYTHONPATH=os.pathsep.join([REPO] + sys.path))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(data), str(len(lane_reads)),
             str(d / "out.json")], cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode(errors="replace")[-3000:]
    ranks = [json.loads((tmp_path / f"p{pid}" / "out.json").read_text())
             for pid in range(4)]
    scores = [int(sw_self.self_scores(s).sum()) for s in seqs]
    reads = sum(lane_reads)
    want = [len(lane_reads), reads, 100 * reads, sum(scores)]
    share = len(os.sched_getaffinity(0)) // 4
    per_file: dict[str, list[int]] = {}
    for r in ranks:
        assert r["merged"] == want
        before, after = r["threads"]
        assert after == min(before, max(share, 1))
        for path, *numbers in r["files"]:
            acc = per_file.setdefault(os.path.basename(path), [0, 0, 0])
            per_file[os.path.basename(path)] = [
                a + b for a, b in zip(acc, numbers)]
        roots = [n for n, parent in r["spans"] if parent is None
                 and n.startswith("wgs.dist.")]
        assert sorted(roots) == sorted(
            ["wgs.dist.sizes", "wgs.dist.plan", "wgs.dist.merge"]
            + ["wgs.dist.stripe"] * shared)
        if shared:
            assert ["align.file", "wgs.dist.stripe"] in r["spans"]
        assert r["counters"]["wgs.dist.shared"] == shared
    # each file once, its stripes summed: the plain DP's reads and scores
    assert per_file == {f"DP_L{k:03d}_R1_001.fastq.gz": [n, 100 * n, sc]
                        for k, (n, sc) in enumerate(zip(lane_reads, scores),
                                                    1)}
    assert sum(r["counters"]["wgs.dist.files"] for r in ranks) \
        == len(lane_reads) - shared
    sizes = [os.path.getsize(f) for f in sorted(data.iterdir())]
    planned = sum(r["counters"]["wgs.dist.planned_bytes"] for r in ranks)
    assert sum(sizes) - 4 <= planned <= sum(sizes)
