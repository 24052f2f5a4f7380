"""Run one cell of BENCHMARK.json once on the card this process sees.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up imports the port, generates the cell's inputs from the seed under
TMPDIR (traffic.py), builds the configuration's entry (entries/) and runs
one whole job, which also builds every kernel the job needs; set-up ends
there and ``setup_s`` is the process's time until then. The window then
runs whole jobs back to back, one client in a closed loop, for
``--seconds``; the job running when the time is up is finished and
counted. ``reads_per_s`` is all reads of all jobs over the window's whole
time; ``card_ms_per_mreads`` is the device time of every kernel of those
jobs, from CUPTI's records of each job, per million of their reads. With
``--trace 1`` the window's first job runs under the profiler and the
per-layer metrics are read from it (metrics/), the others from the
untraced jobs after it. Once the window has closed and the peak device
memory is read, the plain reference (reference/) decides ``correct`` over
every job. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.

Exits 2 without the CUDA cards the cell asks for and 3 when JAX or the JAX
package got loaded, printing no result in either case.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mini_parallel_tpu")
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout


@dataclass
class Context:
    """What a per-layer metric reader reads (metrics/<name>.py)."""

    trace: object = None  # trace.Trace of the traced job
    traced: dict = field(default_factory=dict)  # its reads, chunks, wall
    jobs: list = field(default_factory=list)  # untraced: wall, reads, spans
    decode_s: float | None = None
    card: dict | None = None  # peaks.json's entry for the card
    cells: int | None = None  # DP cells the traced job's reads need


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(ctx)`` of the per-layer metric ``name``: metrics/<name>.py,
    or for a quantity split by the end-to-end metric it moves
    (``<quantity>.<part>``) with no file of its own, the quantity's."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_file(path, "benchmark_metric_" + name.replace(".", "_")).read


def resolve(spec: dict, workload: str) -> dict:
    """A cell with its configuration, traffic mix, entry module and the
    per-layer metrics it reports, each found by name."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    metrics = [m for m in spec["per_layer"]
               if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": config, "traffic": traffic,
            "entry": HERE / "entries" / f"{config['entry']}.py",
            "per_layer": metrics,
            "end_to_end": [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]}


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(parts: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of a resolved cell (:func:`resolve`) on ``device``; -> (the
    result object, the wall seconds of each untraced job)."""
    import torch

    from benchmark import card, traffic
    from benchmark import trace as tracing

    config = parts["config"]
    entry_mod = load_file(parts["entry"], f"benchmark_entry_{config['entry']}")
    on_card = device.type == "cuda"
    ends = {m["name"] for m in parts["end_to_end"]}
    card_time = on_card and not trace and "card_ms_per_mreads" in ends
    with tempfile.TemporaryDirectory(prefix="benchmark-") as work:
        inputs = traffic.generate(config["sample"], parts["traffic"], seed,
                                  os.path.join(work, "inputs"))
        entry = entry_mod.Entry(config, inputs, device, seed)
        if trace and on_card:
            tracing.warm_profiler()
        elif card_time:
            tracing.warm_profiler(cpu=False)
        entry.job(os.path.join(work, "warm"))
        shutil.rmtree(os.path.join(work, "warm"))
        if on_card:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start

        outs, ctx, error = [], Context(), None
        kernel_s, kernels = 0.0, 0
        t0 = time.perf_counter()
        k = 0
        while True:
            jobdir = os.path.join(work, f"job{k}")
            tj = time.perf_counter()
            try:
                if trace and k == 0 and on_card:
                    out, ctx.trace = tracing.traced(
                        lambda: entry.job(jobdir),
                        os.path.join(work, "trace.json"))
                elif card_time:
                    out, ks, n = tracing.kernel_seconds(
                        lambda: entry.job(jobdir))
                    kernel_s, kernels = kernel_s + ks, kernels + n
                else:
                    out = entry.job(jobdir)
                    if on_card:
                        torch.cuda.synchronize(device)
            except Exception:  # the run reports the job failed
                error = traceback.format_exc()
                print(error, file=sys.stderr)
                break
            wall = time.perf_counter() - tj
            outs.append(out)
            chunks = entry.chunks(out)
            if trace and k == 0:
                ctx.traced = {"reads": entry.reads(out), "chunks": chunks[0],
                              "wall": wall}
            else:
                ctx.jobs.append({"wall": wall, "reads": entry.reads(out),
                                 "spans": out["spans"]})
            k += 1
            if (time.perf_counter() - t0 >= seconds
                    and (not trace or ctx.jobs)):
                break
        window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)

        fields = card.card_fields(device)
        metrics: dict = {}
        reads = sum(entry.reads(o) for o in outs)
        if trace:
            from mini_parallel_tpu_torch.io import fastq

            td = time.perf_counter()
            for _ in fastq.iter_flat_chunks_multi(
                    entry.files, config["engine"]["chunk_size_reads"]):
                pass
            ctx.decode_s = time.perf_counter() - td
            ctx.card = card.peaks(fields["name"]) if on_card else None
            ctx.cells = getattr(entry, "cells", lambda: None)()
            for m in parts["per_layer"]:
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            metrics["reads_per_s"] = {"value": reads / window_s,
                                      "unit": "reads/s"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            if card_time and kernel_s > 0:
                metrics["card_ms_per_mreads"] = {
                    "value": kernel_s * 1e3 / (reads / 1e6),
                    "unit": "ms/Mreads"}
                print(f"window kernels: {kernels} launches, {kernel_s!r} s "
                      f"over {len(outs)} jobs", file=sys.stderr)
            metrics = {m["name"]: metrics[m["name"]]
                       for m in parts["end_to_end"] if m["name"] in metrics}

        attempted = sum(entry.chunks(o)[0] for o in outs)
        failed = sum(entry.chunks(o)[1] for o in outs)
        if error is not None:
            per_job = (entry.chunks(outs[0])[0] if outs else 1)
            attempted += per_job
            failed += per_job
        if on_card:
            torch.cuda.empty_cache()
        ref = entry.reference()
        checks = entry.check(outs, ref) if outs else []
        correct = (error is None and bool(outs)
                   and all(v <= lim for _, v, lim in checks))
        device_field = {
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name(device) if on_card
                     else "cpu"),
            "count": parts["cell"]["chips"] if on_card else 0,
            "memory_peak_bytes": int(peak),
        }
        if on_card:
            device_field["power_limit_w"] = fields["power_limit_w"]
        result = {"correct": correct, "attempted": int(attempted),
                  "failed": int(failed), "metrics": metrics,
                  "device": device_field}
        if trace and ctx.trace is not None:
            device_field["busy_s"] = ctx.trace.busy_s()
            device_field["window_s"] = ctx.trace.window_s
            result["breakdown"] = ctx.trace.breakdown()
        result["checks"] = {name: {"value": v, "limit": lim}
                            for name, v, lim in checks}
        return result, [j["wall"] for j in ctx.jobs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    parts = resolve(load_spec(), args.workload)

    CACHE.mkdir(exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    chips = parts["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result, walls = run_cell(parts, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"untraced job walls (s): {walls}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
