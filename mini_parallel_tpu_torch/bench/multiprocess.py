"""N-process distributed-WGS measurement: the counterpart of the JAX
package's root ``bench_multiprocess.py``.

    python -m mini_parallel_tpu_torch.bench.multiprocess [--sizes 1,2,4]
        [--reads-scale 1.0] [--device cuda|cpu] [--out FILE]

For each N of ``--sizes`` it starts N processes joined over gloo on
localhost (``parallel/mesh.py:initialize_distributed``, the
``JAX_COORDINATOR_ADDRESS`` contract), which run the production path,
``parallel/distributed.py:process_full_wgs_distributed`` in kadane mode,
over bench_multiprocess.py's skewed 8-lane fixture (60k, 10k x 3, 8k x 2
and 7k x 2 reads of 150 bp, scaled by ``--reads-scale``). One row per N:

- all-gather traffic: the calls, bytes in and out and seconds of
  ``distributed._all_gather`` (the path's only collective), wrapped in the
  worker as the JAX worker wraps ``process_allgather``;
- the plan: ``plan_work``'s makespan bytes over an even split, and the
  shared (chunk-striped) files;
- the cost: busy CPU seconds of all processes against one process's
  (``work_inflation``), and the slowest process's wall;
- the merged (files, reads, bases, score), identical at every N: the
  row's ``correct``.

On the card every process uses cuda:0 (NCCL refuses two ranks on one
card; the group is gloo, as the port's). Wall times of processes that
share one card and the host's cores do not show scaling:
``performance_representative`` is false on every row.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from mini_parallel_tpu_torch.bench._common import (
    Emitter,
    Watchdog,
    add_common_flags,
    bench_device,
    card_fields,
    run,
)

MODULE = "mini_parallel_tpu_torch.bench.multiprocess"
REPO_ROOT = Path(__file__).resolve().parents[2]
LANE_READS = (60_000, 10_000, 10_000, 10_000, 8_000, 8_000, 7_000, 7_000)
WORKER_TIMEOUT_S = 3600
TOTALS = ("files", "reads", "bases", "score")


def make_fixture(tmp: str, scale: float) -> None:
    """bench_multiprocess.py's 8 lanes, ~6:1 byte skew: lane 1 is
    oversized (chunk-striped at N >= 2), the rest exercise the LPT plan."""
    import gzip

    rng = np.random.default_rng(0)
    alpha = np.array(list("ACGT"))
    lane_reads = [int(n * scale) for n in LANE_READS]
    for lane, n in enumerate(lane_reads, 1):
        p = os.path.join(tmp, f"SC_L{lane:03d}_R1_001.fastq.gz")
        with gzip.open(p, "wt", compresslevel=1) as f:
            for i in range(n):
                f.write(
                    f"@r{i}\n{''.join(rng.choice(alpha, size=150))}\n+\nI\n")


def worker(args) -> int:
    """One process of the group: the traced production path, its facts
    written to ``args.worker`` as JSON."""
    import torch

    from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
    from mini_parallel_tpu_torch.parallel import distributed
    from mini_parallel_tpu_torch.parallel.mesh import (
        initialize_distributed,
        process_count,
        process_index,
    )
    from mini_parallel_tpu_torch.utils.config import Config

    traffic = {"calls": 0, "bytes_in": 0, "bytes_out": 0, "seconds": 0.0}
    all_gather = distributed._all_gather

    def traced(x):
        t0 = time.perf_counter()
        out = all_gather(x)
        traffic["seconds"] += time.perf_counter() - t0
        traffic["calls"] += 1
        traffic["bytes_in"] += int(np.asarray(x).nbytes)
        traffic["bytes_out"] += int(out.nbytes)
        return out

    distributed._all_gather = traced
    initialize_distributed()
    device = bench_device(args)  # cuda:<rank % cards> after the bring-up
    pid, nproc = process_index(), process_count()
    cfg = Config(wgs_data_dir=os.environ["T_DIR"], sample_id="SC", lanes=8,
                 reads_per_lane=1, chunk_size_reads=10_000)
    eng = AlignmentEngine(cfg, mode="kadane", device=device)
    bringup = time.time() - float(os.environ["T_SPAWN"])
    files = cfg.wgs_file_list()
    plan = distributed.plan_work(
        files, nproc, sizes=distributed._agreed_sizes(files, nproc))
    sizes = {f: distributed._stat_size(f) for f in files}
    # the plan probe above gathered sizes for this report only: the traced
    # traffic covers the production path alone
    traffic.update(calls=0, bytes_in=0, bytes_out=0, seconds=0.0)
    cpu_before = time.process_time()
    t0 = time.perf_counter()
    results, merged = distributed.process_full_wgs_distributed(
        eng, cfg, checkpoint_dir=os.environ["T_CKPT"], echo=lambda *_: None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    with open(args.worker, "w") as f:
        json.dump({
            "pid": pid, "nproc": nproc, "device": str(device),
            "bringup_seconds": bringup,
            "process_seconds": t1 - t0,
            "cpu_seconds": time.process_time(),
            "cpu_work_seconds": time.process_time() - cpu_before,
            "local_files": len(results),
            "local_reads": sum(r.total_reads for r in results),
            **{k: getattr(merged, k) for k in TOTALS},
            "allgather": traffic,
            "plan_shared": plan.shared,
            "plan_makespan_bytes": plan.makespan_bytes(sizes),
            "total_bytes": sum(sizes.values()),
        }, f)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_n(tmp: str, nproc: int, device: str, watchdog: Watchdog
          ) -> list[dict]:
    """Start ``nproc`` workers in one group; -> each one's facts."""
    port = _free_port()
    procs, logs = [], []
    for pid in range(nproc):
        ckpt = os.path.join(tmp, f"ck{nproc}_{pid}")
        os.makedirs(ckpt, exist_ok=True)
        env = dict(os.environ)
        env.update(
            T_DIR=tmp, T_CKPT=ckpt, T_SPAWN=repr(time.time()),
            MPT_RESULTS_DIR=os.path.join(tmp, "results"),
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES=str(nproc), JAX_PROCESS_ID=str(pid),
            PYTHONPATH=os.pathsep.join(
                [str(REPO_ROOT)] + [p for p in
                                    [os.environ.get("PYTHONPATH")] if p]))
        log = open(os.path.join(tmp, f"worker_{nproc}_{pid}.log"), "w")
        logs.append(log)
        p = subprocess.Popen(
            [sys.executable, "-m", MODULE, "--device", device,
             "--worker", os.path.join(tmp, f"out_{nproc}_{pid}.json")],
            env=env, cwd=ckpt, stdout=subprocess.DEVNULL, stderr=log)
        procs.append(p)
        watchdog.children.append(p)
    try:
        rcs = [p.wait(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        watchdog.children.clear()
    for pid, rc in enumerate(rcs):
        if rc != 0:
            path = os.path.join(tmp, f"worker_{nproc}_{pid}.log")
            with open(path) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(f"N={nproc}: worker {pid} exited {rc}:\n{tail}")
    outs = []
    for pid in range(nproc):
        with open(os.path.join(tmp, f"out_{nproc}_{pid}.json")) as f:
            outs.append(json.load(f))
    return outs


def size_row(nproc: int, outs: list[dict], golden: dict) -> dict:
    merged = {k: outs[0][k] for k in TOTALS}
    agree = all({k: o[k] for k in TOTALS} == merged for o in outs)
    return {
        "metric": "multiprocess_full_wgs",
        "nproc": nproc,
        "performance_representative": False,
        "host_cores": os.cpu_count(),
        "process_devices": [o["device"] for o in outs],
        "merged": merged,
        "bit_exact_vs_1proc": agree and merged == golden,
        "max_wall_seconds": max(o["process_seconds"] for o in outs),
        "sum_cpu_seconds": sum(o["cpu_seconds"] for o in outs),
        "sum_cpu_work_seconds": sum(o["cpu_work_seconds"] for o in outs),
        "bringup_seconds_max": max(o["bringup_seconds"] for o in outs),
        "allgather_calls": sum(o["allgather"]["calls"] for o in outs),
        "allgather_bytes_in": sum(o["allgather"]["bytes_in"] for o in outs),
        "allgather_bytes_out": sum(o["allgather"]["bytes_out"] for o in outs),
        "allgather_seconds_max": max(o["allgather"]["seconds"] for o in outs),
        "plan_shared_files": len(outs[0]["plan_shared"]),
        "plan_makespan_bytes": outs[0]["plan_makespan_bytes"],
        "plan_makespan_over_ideal": (outs[0]["plan_makespan_bytes"]
                                     / (outs[0]["total_bytes"] / nproc)),
        "reads_per_local_shard": [o["local_reads"] for o in outs],
        "correct": agree and merged == golden,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {MODULE}",
        description="--full-wgs in N processes over gloo: one row per N.")
    ap.add_argument("--reads-scale", type=float, default=1.0)
    ap.add_argument("--sizes", default="1,2,4",
                    help="comma-separated process counts")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    add_common_flags(ap)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    watchdog = Watchdog("multiprocess_full_wgs", "x_vs_1proc")
    device = bench_device(args)
    emitter = Emitter(card_fields(device), args.out)
    watchdog.card = emitter.card
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = []
    with tempfile.TemporaryDirectory(prefix="mpt_bench_mp_") as tmp:
        make_fixture(tmp, args.reads_scale)
        golden = None
        for nproc in sizes:
            outs = run_n(tmp, nproc, device.type, watchdog)
            if golden is None:
                golden = {k: outs[0][k] for k in TOTALS}
            rows.append(size_row(nproc, outs, golden))
    watchdog.cancel()
    # the extra busy CPU time over one process (shared files decoded by
    # every process, per-process bring-up excluded): independent of load
    base = next((r for r in rows if r["nproc"] == 1), None)
    for r in rows:
        r["work_inflation"] = (r["sum_cpu_work_seconds"]
                               / base["sum_cpu_work_seconds"]
                               if base else None)
        emitter.emit(r)
    emitter.emit({
        "metric": "multiprocess_work_inflation_4proc",
        "value": next((r["work_inflation"] for r in rows
                       if r["nproc"] == 4), None),
        "unit": "x_vs_1proc",
        "correct": all(r["correct"] for r in rows)})
    return emitter.finish()


if __name__ == "__main__":
    sys.exit(run(main, "bench.multiprocess"))
