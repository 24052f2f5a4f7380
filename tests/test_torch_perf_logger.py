"""The port's system monitors, monitor summary, annotate_run and --profile
on the CPU: the summary and the annotated rows held to the JAX package's
functions on the same files, byte for byte or value for value (exact); the
GPU monitor's parser on fixed logs; the CLI's monitored --full-wgs and its
profiler traces."""

import json
import os
import stat
import sys
import textwrap

import pytest
import torch

from mini_parallel_tpu.utils import bench_tracker as jbench
from mini_parallel_tpu.utils import perf_logger as jperf
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.utils import bench_tracker, perf_logger
from tests.conftest import random_dna

CPU = torch.device("cpu")

VMSTAT = [
    "procs memory\n"
    " r  b   swpd   free   buff  cache si so bi bo in cs us sy id wa st\n"
    " 1  0      0 800000 10000 20000  0  0  5 10 200 345 1 1 98 0 0\n"
    " 2  0      0 700000 10000 20000  0  0  5 10 300 999 2 1 97 0 0\n",
    # a header repeated mid-log, a torn last line, no cs before the header
    " 9  9 9 9\n"
    "procs -----------memory---------- ---swap-- -----io---- -system-- ----cpu----\n"
    " r  b   swpd   free   buff  cache   si   so    bi    bo   in   cs us sy id wa st\n"
    " 0  0      0 6400000 1000 2000    0    0     1     2   50  120  0  0 100  0  0\n"
    " r  b   swpd   free   buff  cache   si   so    bi    bo   in   cs us sy id wa st\n"
    " 3  0      0 6300000 1000 2000    0    0     1     2   50  4500  9  1 90  0  0\n"
    " 1  0      0 62",
    "",
]
IOSTAT = [
    "Linux 6.1 (host)\n\n"
    "Device            r/s     rkB/s   rrqm/s  %rrqm r_await rareq-sz\n"
    "nvme0n1          1.00     40.00     0.00   0.00    0.10    40.00\n"
    "sda              0.00      0.00     0.00   0.00    0.00     0.00\n\n"
    "Device            r/s     rkB/s   rrqm/s  %rrqm r_await rareq-sz\n"
    "nvme0n1         90.00   9000.50     0.00   0.00    0.10    40.00\n",
    "Device: tps kB_read/s\nsda 1 2\n",
]
DEVICE_MEMORY = [
    json.dumps({"t": 1, "0": {"bytes_in_use": 100, "peak_bytes_in_use": 5000}})
    + "\n" + json.dumps({"t": 2, "0": {"bytes_in_use": 7000,
                                       "peak_bytes_in_use": 0}}) + "\n"
    + "{torn\n" + json.dumps({"t": 3}) + "\n",
    json.dumps({"t": 1}) + "\n",
]


@pytest.mark.parametrize("case", range(3))
def test_summary_equals_jax(tmp_path, case):
    """vmstat.log, iostat.log and device_memory.jsonl give the JAX keys and
    values; a missing file gives no key."""
    for name, texts in (("vmstat.log", VMSTAT), ("iostat.log", IOSTAT),
                        ("device_memory.jsonl", DEVICE_MEMORY)):
        if case < len(texts) and texts[case]:
            (tmp_path / name).write_text(texts[case])
    got = perf_logger.summarize_monitor_logs(str(tmp_path))
    assert got == jperf.summarize_monitor_logs(str(tmp_path))
    assert case == 2 or got


NVIDIA_SMI_LOG = textwrap.dedent("""\
    2026/10/17 06:00:00.000, 0, 500, 70.00
    2026/10/17 06:00:00.100, 100, 1500, 250.50
    2026/10/17 06:00:00.300, [N/A], 1600, [N/A]
    NVIDIA-SMI has failed: no devices were found
    2026/10/17 06:00:00.400, 50, [N/A], 300.25
    2026/10/17 06:00:00.500, 20
    2026/10/17 06:00:0
    """)


def test_nvidia_smi_parser_and_summary(tmp_path):
    """[N/A] fields are None and left out, torn lines and messages are
    skipped; utilization is weighted by the interval each sample ends."""
    (tmp_path / "nvidia_smi.log").write_text(NVIDIA_SMI_LOG)
    samples = perf_logger.read_nvidia_smi_log(str(tmp_path / "nvidia_smi.log"))
    assert [s[1:] for s in samples] == [(0.0, 500.0, 70.0),
                                        (100.0, 1500.0, 250.5),
                                        (None, 1600.0, None),
                                        (50.0, None, 300.25)]
    assert samples[1][0] - samples[0][0] == pytest.approx(0.1, abs=1e-6)
    out = perf_logger.summarize_monitor_logs(str(tmp_path))
    # 0.1 s at 100 %, then 0.3 s at 50 % (the [N/A] sample drops out)
    assert out["device_busy_fraction_est"] == round((0.1 * 100 + 0.3 * 50)
                                                    / 0.4 / 100, 4)
    assert out["gpu_utilization_max_pct"] == 100.0
    assert out["peak_gpu_memory_used_mib"] == 1600.0
    assert out["max_power_draw_w"] == 300.25
    assert out["device_busy_methodology"] == perf_logger.BUSY_METHODOLOGY
    (tmp_path / "nvidia_smi.log").write_text(
        "2026/10/17 06:00:00.000, 37, 1, 2\n")
    assert perf_logger.summarize_monitor_logs(str(tmp_path))[
        "device_busy_fraction_est"] == 0.37
    (tmp_path / "nvidia_smi.log").write_text("[N/A]\n")
    assert perf_logger.summarize_monitor_logs(str(tmp_path)) == {}


def test_monitors_start_stop_leave_no_child(tmp_path):
    with perf_logger.system_monitors(log_base=str(tmp_path / "logs"),
                                     device=CPU) as mon:
        procs = list(mon._procs.values())
        assert mon.run_dir == str(tmp_path / "logs" / "run_1")
    assert mon._procs == {} and mon._sampler is None
    assert all(p.poll() is not None for p in procs)
    rows = [json.loads(ln) for ln in
            open(os.path.join(mon.run_dir, "device_memory.jsonl"))]
    assert len(rows) >= 2 and all(set(r) == {"t"} for r in rows)  # CPU: t only
    assert perf_logger.SystemMonitors(device=CPU).device == CPU


def test_run_dirs_increment_and_perf_record_optional(tmp_path, monkeypatch):
    base = str(tmp_path / "logs")
    dirs = []
    for _ in range(2):
        m = perf_logger.SystemMonitors(log_base=base, device=CPU)
        dirs.append(m.start())
        m.stop()
    assert [os.path.basename(d) for d in dirs] == ["run_1", "run_2"]
    assert all(os.path.exists(os.path.join(d, "perf_record.log"))
               for d in dirs)
    monkeypatch.setenv("MPT_PERF_RECORD", "0")
    m = perf_logger.SystemMonitors(log_base=base, device=CPU)
    d = m.start()
    m.stop()
    assert not os.path.exists(os.path.join(d, "perf_record.log"))
    assert os.path.exists(os.path.join(d, "vmstat.log"))  # logged or run


def test_monitors_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from mini_parallel_tpu_torch.device import NoAcceleratorError

    with pytest.raises(NoAcceleratorError):
        perf_logger.SystemMonitors()


def _fake_nvidia_smi(bin_dir, body: str) -> None:
    path = bin_dir / "nvidia-smi"
    path.write_text(f"#!{sys.executable}\n{body}")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


@pytest.mark.parametrize("body, error", [
    (None, "not available"),
    ("import sys\nprint('NVIDIA-SMI has failed')\nsys.exit(9)\n",
     "exit code 9"),
    ("import sys, time\nprint(' '.join(sys.argv[1:]), flush=True)\n"
     "for _ in range(3):\n"
     "    print('2026/10/17 06:00:00.000, 10, 20, 30.5', flush=True)\n"
     "    time.sleep(0.05)\n"
     "time.sleep(60)\n", None),
])
def test_gpu_monitor_is_required(tmp_path, monkeypatch, body, error):
    """On a CUDA device the GPU monitor must start and sample: a missing
    nvidia-smi, or one that exits without a sample, raises."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    if body is not None:
        _fake_nvidia_smi(bin_dir, body)
    monkeypatch.setenv("PATH", str(bin_dir))
    mon = perf_logger.SystemMonitors(log_base=str(tmp_path / "logs"),
                                     device=CPU)
    mon.device = torch.device("cuda", 0)
    mon.run_dir = perf_logger._next_run_dir(mon.log_base)
    try:
        if error:
            with pytest.raises(perf_logger.GpuMonitorError, match=error):
                mon._start_gpu_monitor()
        else:
            mon._start_gpu_monitor()
            log = os.path.join(mon.run_dir, "nvidia_smi.log")
            assert open(log).readline().split() == perf_logger.nvidia_smi_argv(
                0)[1:]
            assert perf_logger.read_nvidia_smi_log(log)
    finally:
        procs = list(mon._procs.values())
        mon.stop()
    assert all(p.poll() is not None for p in procs)


def _rows(results_dir, n):
    rows = [{"run_number": k, "workload": "full_wgs", "total_score": 10 * k}
            for k in range(1, n + 1)]
    os.makedirs(results_dir)
    for r in rows:
        with open(os.path.join(results_dir,
                               f"run_{r['run_number']}_benchmark_results.json"),
                  "w") as f:
            json.dump(r, f, indent=2)
    with open(os.path.join(os.path.dirname(results_dir),
                           "benchmark_results.json"), "w") as f:
        json.dump(rows, f, indent=2)


@pytest.mark.parametrize("run, legacy", [(2, True), (3, False), (9, True)])
def test_annotate_run_bytes_equal_jax(tmp_path, run, legacy):
    fields = {"monitor_summary": {"device_busy_fraction_est": 0.0123,
                                  "max_power_draw_w": 312.5}}
    outs = []
    for pkg, fn in (("port", bench_tracker.annotate_run),
                    ("jax", jbench.annotate_run)):
        results = str(tmp_path / pkg / "benchmark_results")
        _rows(results, 3)
        if not legacy:
            os.remove(os.path.join(os.path.dirname(results),
                                   "benchmark_results.json"))
        outs.append((fn(run, fields, results_dir=results), {
            p: open(os.path.join(dp, p), "rb").read()
            for dp, _, files in os.walk(tmp_path / pkg) for p in files}))
    assert outs[0] == outs[1]
    assert outs[0][0] == (run <= 3)


def _wgs_fixture(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reads = [random_dna(rng, 120) for _ in range(30)]
    for r in (1, 2):
        fastq.write_fastq(str(tmp_path / f"MON_L001_R{r}_001.fastq.gz"), reads)
    values = {"WGS_DATA_DIR": str(tmp_path), "WGS_SAMPLE_ID": "MON",
              "WGS_LANES": "1", "WGS_READS_PER_LANE": "2",
              "GPU_CHUNK_SIZE_READS": "10",
              "MPT_RESULTS_DIR": str(tmp_path / "br")}
    env = tmp_path / "t.env"
    env.write_text("".join(f"{k}={v}\n" for k, v in values.items()))
    # a .env never overrides the environment, which earlier CLI runs in
    # this process may have filled: set it, and have it restored after
    for k, v in values.items():
        monkeypatch.setenv(k, v)
    # one monitor that always runs, so the summary has a known value
    monkeypatch.setattr(perf_logger, "MONITOR_CMDS", {"vmstat": [
        sys.executable, "-c",
        "print(' r  b free cs'); print(' 1  0 4242 77', flush=True)\n"
        "import time; time.sleep(60)"]})
    monkeypatch.setenv("MPT_PERF_RECORD", "0")
    return str(env), reads


def test_cli_full_wgs_runs_under_monitors(tmp_path, rng, monkeypatch):
    env, reads = _wgs_fixture(tmp_path, rng, monkeypatch)
    out = []
    assert cli.main(["--full-wgs", "--mode", "sw", "--allow-cpu", "--env",
                     env], echo=out.append) == 0
    assert sorted(os.listdir(tmp_path / "logs")) == ["run_1"]
    summary = {"max_context_switches_per_s": 77.0, "min_free_memory_kb": 4242.0}
    assert f"Monitor summary (logs/run_1): {summary}" in out
    row = json.loads((tmp_path / "br" / "run_1_benchmark_results.json")
                     .read_text())
    assert row["monitor_summary"] == summary
    assert row["total_score"] == 2 * 2 * sum(map(len, reads))
    legacy = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert legacy[-1]["monitor_summary"] == summary


def _trace(trace_dir) -> dict:
    names = os.listdir(trace_dir)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")
    with open(os.path.join(trace_dir, names[0])) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["full-wgs", "direct", "kmer",
                                  "failing files"])
def test_cli_profile_writes_a_cpu_trace(tmp_path, rng, monkeypatch, mode):
    """--profile DIR traces the whole dispatch on the CPU; a mode that
    fails still leaves its trace."""
    env, _ = _wgs_fixture(tmp_path, rng, monkeypatch)
    lane = str(tmp_path / "MON_L001_R1_001.fastq.gz")
    argv, rc = {
        "full-wgs": (["--full-wgs", "--env", env], 0),
        "direct": (["-1", "ACGTTGCA", "-2", "ACGATGCA", "--mode", "sw"], 0),
        "kmer": (["--kmer", lane, "-k", "15"], 0),
        "failing files": (["--files", "-1", "missing.fastq.gz", "-2", lane,
                           "--env", env], 1),
    }[mode]
    out = []
    assert cli.main(argv + ["--allow-cpu", "--profile", "traces"],
                    echo=out.append) == rc
    trace = _trace(tmp_path / "traces")
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert out[-1].startswith("Profile trace written to traces/")
    if mode == "failing files":
        assert any(ln.startswith("ERROR:") for ln in out)
    else:
        assert "cpu_op" in cats
