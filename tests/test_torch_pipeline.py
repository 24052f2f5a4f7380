"""The port's --full-wgs slice end to end on the CPU: the engine, the
orchestrator, checkpoints and the CLI, held against the JAX package's
AlignmentEngine on the same FASTQ fixtures. Exact equality throughout."""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from mini_parallel_tpu.models.alignment import AlignmentEngine as JaxEngine
from mini_parallel_tpu.models.wgs import (
    process_full_wgs_dataset as jax_process_full_wgs_dataset,
)
from mini_parallel_tpu.ops import kadane as jkadane
from mini_parallel_tpu.utils.config import Config as JaxConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.device import NoAcceleratorError, require_cuda
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.models import alignment
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.models.wgs import process_full_wgs_dataset
from mini_parallel_tpu_torch.ops import sw_cuda
from mini_parallel_tpu_torch.utils import bench_tracker, system_info
from mini_parallel_tpu_torch.utils.checkpoint import (
    CheckpointState,
    deterministic_run_id,
)
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cfg(tmp_path):
    return Config(wgs_data_dir=str(tmp_path), sample_id="TEST", lanes=2,
                  reads_per_lane=1, chunk_size_reads=5, read_pad=64)


def _jax_cfg(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


def _reads(rng, n, lo, hi, alphabet=b"ACGT"):
    return [random_dna(rng, int(rng.integers(lo, hi + 1)), alphabet)
            for _ in range(n)]


def _lane(tmp_path, name, reads):
    path = str(tmp_path / name)
    fastq.write_fastq(path, reads)
    return path


def _same(got, want):
    return ((got.score, got.total_bases, got.total_reads, got.chunks)
            == (want.score, want.total_bases, want.total_reads, want.chunks))


@pytest.mark.parametrize("mode", ["kadane", "sw"])
@pytest.mark.parametrize("packed", [True, False])
def test_self_align_file_matches_jax(tmp_path, rng, cfg, mode, packed):
    # 23 reads in chunks of 5: ragged lengths, N bases, a partial last
    # chunk, and (kadane) chunks on both sides of the 1000-base skip
    reads = _reads(rng, 23, 150, 280, alphabet=b"ACGTN")
    reads[7] = reads[7][:3]
    path = _lane(tmp_path, "lane.fastq.gz", reads)
    cfg = dataclasses.replace(cfg, packed_transfer=packed,
                              read_pad=64 if packed else 62)
    got = AlignmentEngine(cfg, mode=mode, device=CPU).self_align_file(path)
    want = JaxEngine(_jax_cfg(cfg), mode=mode).self_align_file(path)
    assert _same(got, want)
    assert got.chunks == 5 and got.failed_chunks == 0
    if mode == "sw":
        assert got.score == 2 * sum(map(len, reads))


def test_self_align_chunk_resume_and_forced_fold(tmp_path, rng, cfg,
                                                 monkeypatch):
    reads = _reads(rng, 20, 40, 90)
    path = _lane(tmp_path, "resume.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="sw", device=CPU)
    clean = eng.self_align_file(path)
    snaps = []
    eng.self_align_file(path, checkpoint_every=1,
                        on_checkpoint=lambda r: snaps.append(copy.copy(r)))
    assert [s.chunks for s in snaps] == [1, 2, 3, 4]
    mid = snaps[2]
    mid.chunks_done = mid.chunks
    assert mid.score == sum(2 * len(r) for r in reads[:15])
    resumed = eng.self_align_file(path, resume=mid)
    assert _same(resumed, clean)
    # every enqueue folds the device accumulator into the host total first
    monkeypatch.setattr(alignment, "_ACC_LIMIT", 1)
    for mode in ("sw", "kadane"):
        forced = AlignmentEngine(cfg, mode=mode, device=CPU).self_align_file(path)
        monkeypatch.undo()
        unforced = AlignmentEngine(cfg, mode=mode, device=CPU).self_align_file(path)
        assert _same(forced, unforced)
        monkeypatch.setattr(alignment, "_ACC_LIMIT", 1)


def test_self_align_skips_failed_chunks(tmp_path, rng, cfg, monkeypatch):
    """aligner.rs:284-287: a chunk that blows the device budget is logged
    and scores 0; the rest of the file still scores."""
    reads = [random_dna(rng, 300) for _ in range(15)]
    monster = [random_dna(rng, 300_000)] + [random_dna(rng, 300)] * 4
    path = _lane(tmp_path, "oversize.fastq.gz", reads + monster)
    info = system_info.SystemInfo(hbm_bytes_limit=3 * 1024 * 1024)
    monkeypatch.setattr(alignment, "get_system_info", lambda device: info)
    logs = []
    res = AlignmentEngine(cfg, mode="kadane", device=CPU).self_align_file(
        path, progress=logs.append)
    assert res.failed_chunks == 1 and res.score == 6
    assert res.chunks == 4 and res.total_reads == 20
    assert any("Alignment failed for chunk" in ln for ln in logs)
    with pytest.raises(alignment.SequenceTooLarge):
        alignment.check_device_budget(10 * 1024 * 1024, CPU)
    alignment.check_device_budget(100, CPU)


def test_score_read_batch_and_strings_match_jax(rng, cfg):
    ra = _reads(rng, 9, 0, 70, alphabet=b"ACGTN")
    rb = _reads(rng, 9, 0, 70, alphabet=b"ACGTN")
    for mode in ("kadane", "sw"):
        for packed in (True, False):
            c = dataclasses.replace(cfg, packed_transfer=packed)
            got = AlignmentEngine(c, mode=mode, device=CPU).score_read_batch(ra, rb)
            want = JaxEngine(_jax_cfg(c), mode=mode).score_read_batch(ra, rb)
            assert got.tolist() == want.tolist(), (mode, packed)
        eng, jeng = AlignmentEngine(cfg, mode=mode, device=CPU), JaxEngine(
            _jax_cfg(cfg), mode=mode)
        for a, b in [("ACGT", "ACGA"), ("AAAA", "TTTT"), ("", "ACGT"),
                     ("ACGTTGCA", "ACGTAGCA"), (ra[0], rb[0])]:
            assert eng.score_strings(a, b) == jeng.score_strings(a, b)
    assert AlignmentEngine(cfg, mode="kadane", device=CPU).score_strings(
        "ACGT", "ACGA") == jkadane.reference_align_score("ACGT", "ACGA")


def test_full_wgs_resumes_from_jax_checkpoint(tmp_path, rng, cfg,
                                              monkeypatch):
    """The JAX package completes file 1 and fails on the missing file 2,
    saving its checkpoint; the port resumes from it, skips file 1 and
    matches a clean JAX run over both files."""
    monkeypatch.chdir(tmp_path)
    lanes = [_reads(rng, 12, 100, 150, alphabet=b"ACGTN") for _ in range(2)]
    _lane(tmp_path, "TEST_L001_R1_001.fastq.gz", lanes[0])
    jcfg = _jax_cfg(cfg)
    with pytest.raises(RuntimeError, match="File 2 failed"):
        jax_process_full_wgs_dataset(JaxEngine(jcfg, mode="sw"), jcfg,
                                     checkpoint_dir=str(tmp_path),
                                     results_dir=str(tmp_path / "jr"),
                                     echo=lambda *_: None)
    _lane(tmp_path, "TEST_L002_R1_001.fastq.gz", lanes[1])
    out = []
    got = process_full_wgs_dataset(
        AlignmentEngine(cfg, mode="sw", device=CPU), cfg,
        checkpoint_dir=str(tmp_path), results_dir=str(tmp_path / "pr"),
        echo=out.append)
    assert sum("Skipping file" in ln for ln in out) == 1
    want = jax_process_full_wgs_dataset(
        JaxEngine(jcfg, mode="sw"), jcfg, checkpoint_dir=str(tmp_path / "x"),
        results_dir=str(tmp_path / "jr"), echo=lambda *_: None)
    assert [(r.score, r.total_bases, r.total_reads) for r in got] == \
        [(r.score, r.total_bases, r.total_reads) for r in want]
    run_id = deterministic_run_id(cfg.sample_id, cfg.wgs_file_list(), "sw",
                                  chunk_size=cfg.chunk_size_reads)
    assert CheckpointState.load(run_id, str(tmp_path)).completed_files == 2
    row = json.loads((tmp_path / "pr" / "run_1_benchmark_results.json").read_text())
    assert row["total_reads"] == 12 and row["device"] == "cpu"
    jrow = json.loads((tmp_path / "jr" / "run_2_benchmark_results.json").read_text())
    assert set(row) == set(jrow)  # the same row format


def test_full_wgs_retries_resume_from_chunk(tmp_path, rng, cfg, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reads = [random_dna(rng, 300) for _ in range(20)]  # 4 chunks per file
    for lane in (1, 2):
        _lane(tmp_path, f"TEST_L{lane:03d}_R1_001.fastq.gz", reads)
    real_flat = fastq.iter_flat_chunks
    fails = {"left": 1}

    def flaky(path, chunk_size, **kw):
        for i, chunk in enumerate(real_flat(path, chunk_size, **kw)):
            if i == 3 and fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("transient disk error")
            yield chunk

    monkeypatch.setattr(fastq, "iter_flat_chunks", flaky)
    out = []
    results = process_full_wgs_dataset(
        AlignmentEngine(cfg, mode="kadane", device=CPU), cfg,
        checkpoint_dir=str(tmp_path), results_dir=str(tmp_path / "r"),
        echo=out.append, checkpoint_every_chunks=2, retries=1)
    assert any("attempt 1 failed" in ln and "from chunk 2" in ln for ln in out)
    assert [r.score for r in results] == [8, 8]
    assert all(r.total_reads == 20 for r in results)


def test_cli_full_wgs_sw_allow_cpu(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reads = _reads(rng, 11, 60, 151, alphabet=b"ACGTN")
    for r in (1, 2):
        _lane(tmp_path, f"CLI_L001_R{r}_001.fastq.gz", reads)
    env = tmp_path / "t.env"
    env.write_text(f"WGS_DATA_DIR={tmp_path}\nWGS_SAMPLE_ID=CLI\nWGS_LANES=1\n"
                   "WGS_READS_PER_LANE=2\nGPU_CHUNK_SIZE_READS=4\n")
    monkeypatch.setenv("MPT_RESULTS_DIR", str(tmp_path / "br"))
    out = []
    rc = cli.main(["--full-wgs", "--mode", "sw", "--allow-cpu", "--env",
                   str(env)], echo=out.append)
    assert rc == 0 and "Processed 2 files" in out
    row = json.loads((tmp_path / "benchmark_results.json").read_text())[-1]
    assert row["total_score"] == 2 * 2 * sum(map(len, reads))
    assert row["mode"] == "sw" and row["total_reads"] == 22
    out = []
    assert cli.main(["--test-wgs", "--env", str(env)], echo=out.append) == 0
    assert sum(f"{sum(map(len, reads))} bases" in ln for ln in out) == 2
    out = []
    assert cli.main(["-1", "ACGTT", "-2", "ACGAT", "--mode", "sw",
                     "--allow-cpu"], echo=out.append) == 0
    assert out[-1] == "Alignment score: 7"


@pytest.mark.parametrize("argv", [
    ["--files", "-1", "a", "-2", "b", "--profile", "p"],
    ["--kmer", "x.fastq.gz", "--profile", "p"],
    ["--complementarity", "-1", "a", "-2", "b", "--profile", "p"],
    ["--variant-prep", "x", "--reference", "r.fa", "--gapped", "--genotype",
     "--profile", "p"],
    ["--long-align", "-1", "a", "-2", "b", "--profile", "p"],
    ["--full-wgs", "--profile", "p"],
    ["--kmer", "a.fastq.gz,b.fastq.gz", "-k", "15", "--canonical",
     "--profile", "p"],
    ["--variant-prep", "x", "--reference", "r.fa", "--gapped", "--rescue",
     "--profile", "p"],
    ["--variant-prep", "x", "--reference", "r.fa", "--genotype", "--kmer",
     "k.fastq.gz", "--profile", "p"],
    [],
])
def test_cli_not_yet_ported_exits_2(argv, monkeypatch, tmp_path):
    """--profile is ported; device meshes are what every mode still
    refuses: each argv under MPT_MESH_SHAPE exits 2 "not yet ported", and
    its --profile trace of the refused run is still written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "10")
    monkeypatch.setenv("MPT_MESH_SHAPE", "2")
    out = []
    assert cli.main(argv + ["--allow-cpu"] if argv else argv,
                    echo=out.append) == 2
    assert argv == [] or any("not yet ported" in ln for ln in out)
    if argv:
        (trace,) = os.listdir(tmp_path / "p")
        assert trace.endswith(".pt.trace.json")


def test_cli_and_engine_require_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    out = []
    assert cli.main(["-1", "AC", "-2", "AC"], echo=out.append) == 1
    assert "CUDA is not available" in out[-1]
    with pytest.raises(NoAcceleratorError):
        AlignmentEngine(Config(chunk_size_reads=5))
    with pytest.raises(NoAcceleratorError):
        require_cuda("cuda")
    assert require_cuda("cpu") == CPU


def test_engine_not_yet_ported_paths(cfg, monkeypatch):
    """Device meshes are the one engine path still to port: every mode
    refuses them, on the engine and through the CLI."""
    for mode in alignment.MODES:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            AlignmentEngine(dataclasses.replace(cfg, mesh_shape=(2,)),
                            mode=mode, device=CPU)
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "10")
    monkeypatch.setenv("MPT_MESH_SHAPE", "2")
    out = []
    assert cli.main(["--files", "-1", "a", "-2", "b", "--allow-cpu"],
                    echo=out.append) == 2
    assert "not yet ported" in out[-1]
    eng = AlignmentEngine(cfg, mode="sw", device=CPU)
    assert eng.score_strings("A" * 2048, "A" * 2048) == 4096
    assert eng.score_strings("A" * 2049, "A") == 2  # the strip engine


def test_bench_row_matches_jax_format():
    from mini_parallel_tpu.utils import bench_tracker as jbench

    fields = [f.name for f in dataclasses.fields(bench_tracker.BenchmarkResult)]
    assert fields == [f.name for f in dataclasses.fields(jbench.BenchmarkResult)]


def test_import_leaves_jax_out():
    """Importing every module of the port loads neither jax nor the JAX
    package (fresh interpreter: this test process has both loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mini_parallel_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "        if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'mini_parallel_tpu' or k.startswith('mini_parallel_tpu.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 15 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_counter_untouched_on_cpu_path(tmp_path, rng, cfg,
                                              monkeypatch):
    monkeypatch.setattr(sw_cuda.sw_score_batch_cuda, "launches", 0)
    path = _lane(tmp_path, "c.fastq.gz", _reads(rng, 6, 30, 40))
    AlignmentEngine(cfg, mode="sw", device=CPU).self_align_file(path)
    assert sw_cuda.sw_score_batch_cuda.launches == 0
