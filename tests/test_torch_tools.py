"""The port's tools on the CPU: the kernel gate's rows on the plain
versions, the CLI smoke, the line counters, the scale-data generator, the
resilience soak and the autotune sweep, each held to the JAX package's tool
on the same inputs where the JAX tool runs here (exact: bytes, counts,
scores). Card-only behaviour is marked ``cuda``."""

import gzip
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mini_parallel_tpu.models.alignment import AlignmentEngine as JaxEngine
from mini_parallel_tpu.models.wgs import (
    process_full_wgs_dataset as jax_process_full_wgs_dataset,
)
from mini_parallel_tpu.ops import sw as jsw
from mini_parallel_tpu.tools import make_scale_data as jscale
from mini_parallel_tpu.tools import smoke as jsmoke
from mini_parallel_tpu.utils.config import Config as JaxConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.tools import (
    autotune,
    kernel_check,
    linecount,
    make_scale_data,
    smoke,
    soak_resilience,
    stdin_linecount,
)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def small_long(monkeypatch):
    """The long rows at 1,500 x 2,000 with the segment across a 512-column
    strip edge (the defaults are 30,000 x 40,000)."""
    for name, value in (("LONG_M", 1_500), ("LONG_N", 2_000),
                        ("LONG_SEGMENT", 300), ("LONG_A_AT", 200),
                        ("LONG_B_AT", 900)):
        monkeypatch.setattr(kernel_check, name, value)


@pytest.mark.parametrize("name", [n for n, _ in kernel_check.CHECKS])
def test_kernel_check_row_passes_on_the_plain_versions(name, small_long):
    fn = dict(kernel_check.CHECKS)[name]
    ok, detail = fn(np.random.default_rng(0), 24, CPU)
    assert ok, detail


def test_kernel_check_rows_are_the_jax_rows_and_the_chain():
    from mini_parallel_tpu.tools import kernel_check as jkc

    assert [n for n, _ in kernel_check.CHECKS] == [
        n for n, _ in jkc.CHECKS] + ["roofline-chain"]


def test_kernel_check_exit_codes(small_long, capsys):
    assert kernel_check.main(["--allow-cpu", "--reads", "12"]) == 0
    out = capsys.readouterr().out
    assert out.count("  PASS  ") == 15 and "not the kernel gate" in out
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA card")
    assert kernel_check.main([]) == 1
    assert capsys.readouterr().out.startswith("FAIL:")


def test_kernel_check_counts_a_crash_as_a_failure(monkeypatch, capsys):
    def boom(rng, B, dev):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(kernel_check, "CHECKS", [("sw-wavefront", boom)])
    assert kernel_check.main(["--allow-cpu"]) == 1
    assert "FAIL  sw-wavefront" in capsys.readouterr().out


@pytest.mark.parametrize("seed", range(4))
def test_vs_ref_golden_equals_jax_golden(seed):
    """The gate's anti-diagonal golden == the JAX package's quadratic loop
    golden (scores and smallest ends), ties and pad rows included."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 120).tobytes()
    reads = [ref[10:40], ref[50:80] + ref[10:20], b"",
             rng.choice(np.frombuffer(b"ACGT", np.uint8), 25).tobytes(),
             b"ACGT" * 3, ref[100:120] * 2]
    arr = np.full((len(reads), 48), 0xFE, np.uint8)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = np.frombuffer(r, np.uint8)
    scores, ends = kernel_check.vs_ref_golden(arr, ref)
    want = [jsw.sw_vs_ref_numpy(r, ref) if r else (0, -1) for r in reads]
    assert list(zip(scores.tolist(), ends.tolist())) == want


def test_smoke_fixtures_equal_jax(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    fx = smoke._fixtures(str(tmp_path / "p"))
    jfx = jsmoke._fixtures(str(tmp_path / "j"))
    assert {k: os.path.basename(v) for k, v in fx.items()} == {
        k: os.path.basename(v) for k, v in jfx.items()}
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 10
    for name in names:
        opener = gzip.open if name.endswith(".gz") else open
        with opener(tmp_path / "p" / name, "rb") as a, \
                opener(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert [m for m, _ in smoke.modes(fx)] == [
        "direct", "direct-sw", "test-wgs", "full-wgs", "pair-files", "kmer",
        "kmer-multi", "complementarity", "variant-prep",
        "variant-gapped-affine", "genotype", "long-align"]


def test_smoke_passes_every_row_on_the_cpu(small_long, monkeypatch, capsys):
    monkeypatch.setenv("WGS_SAMPLE_ID", "ELSEWHERE")
    cwd = os.getcwd()
    assert smoke.main(["--allow-cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("13/13 checks passed")
    assert out.count("[PASS] ") == 13
    assert os.getcwd() == cwd and os.environ["WGS_SAMPLE_ID"] == "ELSEWHERE"


def _lines_files(tmp_path):
    recs = b"".join(b"@r%d\nACGT\n+\nIIII\n" % i for i in range(5000))
    files = {"plain.fastq": recs, "crlf.fastq": recs.replace(b"\n", b"\r\n"),
             "open_end.fastq": recs + b"@x\nAC", "empty.fastq": b""}
    paths = []
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        (tmp_path / (name + ".gz")).write_bytes(gzip.compress(data, 1))
        paths += [str(tmp_path / name), str(tmp_path / (name + ".gz"))]
    cut = gzip.compress(recs * 20, 1)
    (tmp_path / "cut.fastq.gz").write_bytes(cut[:len(cut) // 2])
    return paths, str(tmp_path / "cut.fastq.gz")


def _run(module: str, args: list[str], stdin: bytes | None = None):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          input=stdin, capture_output=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_linecount_equals_jax(tmp_path):
    """Same counts as the JAX tool; a truncated .gz exits 1 in both (the JAX
    tool's Python fallback dies in a traceback there, the port prints an
    ERROR line)."""
    paths, cut = _lines_files(tmp_path)
    got = _run("mini_parallel_tpu_torch.tools.linecount", paths)
    want = _run("mini_parallel_tpu.tools.linecount", paths)
    assert got.returncode == want.returncode == 0
    assert got.stdout == want.stdout and got.stdout.count(b" lines\n") == 8
    got = _run("mini_parallel_tpu_torch.tools.linecount", [paths[0], cut])
    want = _run("mini_parallel_tpu.tools.linecount", [paths[0], cut])
    assert got.returncode == want.returncode == 1
    assert got.stdout == want.stdout == f"{paths[0]}: 20000 lines\n".encode()
    assert got.stderr.decode().startswith(f"{cut}: ERROR ")
    assert linecount.main([]) == 2


@pytest.mark.parametrize("engine", ["python", "native"])
def test_count_lines_engines(tmp_path, engine):
    if engine == "native":
        try:
            fastq.resolved_engine("native")
        except fastq.BuildError:
            pytest.skip("the native decoder does not build here")
    paths, cut = _lines_files(tmp_path)
    want = [20000, 20000, 20000, 20000, 20002, 20002, 0, 0]
    assert [fastq.count_lines(p, engine) for p in paths] == want
    with pytest.raises(OSError):
        fastq.count_lines(cut, engine)


def test_stdin_linecount_equals_jax(tmp_path, monkeypatch, capsys):
    data = gzip.decompress(gzip.compress(b"@r\nACGT\n+\nIIII\n" * 2500)) + b"x"
    got = _run("mini_parallel_tpu_torch.tools.stdin_linecount", [], data)
    want = _run("mini_parallel_tpu.tools.stdin_linecount", [], data)
    assert got.returncode == want.returncode == 0
    assert got.stdout == want.stdout == b"10001\n"
    monkeypatch.setattr(stdin_linecount, "PROGRESS_EVERY", 4000)
    assert stdin_linecount.main(io.BytesIO(data)) == 0
    out, err = capsys.readouterr()
    assert out == "10001\n" and err == "... 4000 lines\n... 8000 lines\n"


def test_make_scale_data_equals_jax(tmp_path, capsys):
    out = tmp_path / "scale"
    assert make_scale_data.main([str(out), "--lanes", "2",
                                 "--reads-per-lane", "200"]) == 0
    assert "wrote 2 lanes x 200 reads (400 total, 150bp)" in \
        capsys.readouterr().out
    for lane in (1, 2):
        want = tmp_path / f"jax{lane}.fastq.gz"
        jscale.write_lane(str(want), 200, 150, lane)
        got = out / f"SCALE_L{lane:03d}_R1_001.fastq.gz"
        assert gzip.decompress(got.read_bytes()) == \
            gzip.decompress(want.read_bytes())


def _soak_set(tmp_path, monkeypatch):
    """4 lanes x 700 reads, 10 reads a chunk (70 chunks a file, checkpoints
    every 50), and a clean --full-wgs kadane run over them."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    data = tmp_path / "data"
    data.mkdir()
    for lane in range(1, 5):
        fastq.write_fastq(
            str(data / f"SCALE_L{lane:03d}_R1_001.fastq.gz"),
            [rng.choice(np.frombuffer(b"ACGT", np.uint8), 150).tobytes()
             for _ in range(700)])
    values = {"WGS_DATA_DIR": "data", "WGS_SAMPLE_ID": "SCALE",
              "WGS_LANES": "4", "WGS_READS_PER_LANE": "1",
              "GPU_CHUNK_SIZE_READS": "10",
              "MPT_RESULTS_DIR": str(tmp_path / "br")}
    (tmp_path / ".env").write_text("".join(f"{k}={v}\n"
                                           for k, v in values.items()))
    # a .env never overrides the environment, which earlier CLI runs in
    # this process may have filled: set it, and have it restored after
    for k, v in values.items():
        monkeypatch.setenv(k, v)
    assert cli.main(["--full-wgs", "--mode", "kadane", "--allow-cpu"],
                    echo=lambda s: None) == 0
    (ckpt,) = [p for p in os.listdir(tmp_path) if p.startswith("checkpoint_")]
    return str(tmp_path / ckpt)


def test_soak_recovers_one_injected_failure(tmp_path, monkeypatch):
    ckpt = _soak_set(tmp_path, monkeypatch)
    real = fastq.iter_flat_chunks
    out = []
    assert soak_resilience.main([ckpt, "--allow-cpu"], echo=out.append) == 0
    assert fastq.iter_flat_chunks is real  # the wrapper is taken out
    verdict = json.loads(out[-1])
    assert verdict["injection_fired"] is True
    assert verdict["retried_from_chunk"] == 50
    assert verdict["bit_exact_vs_clean"] is True
    assert sum(ln.endswith(" OK") for ln in out) == 4
    assert sum("attempt 1 failed (injected transient failure (soak))" in ln
               for ln in out) == 1
    clean = json.load(open(ckpt))["files"]
    assert all(f["score"] == 140 and f["total_reads"] == 700 for f in clean)


@pytest.mark.parametrize("argv, env", [
    (["--fail-at-chunk", "70"], {}),  # past the last chunk (0-69)
    (["--lane", "L009"], {}),  # no such lane
    ([], {"MPT_SOAK_CKPT_DIR": "."}),  # the clean run's checkpoint: all skipped
])
def test_soak_fails_when_the_injection_never_fires(tmp_path, monkeypatch,
                                                   argv, env):
    ckpt = _soak_set(tmp_path, monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    assert soak_resilience.main([ckpt, "--allow-cpu", *argv],
                                echo=out.append) == 1
    verdict = json.loads(out[-2])
    assert verdict["bit_exact_vs_clean"] is True  # every total matches...
    assert verdict["injection_fired"] is False  # ...and still it fails
    assert out[-1].startswith("FAIL: the injection never fired")


def test_jax_soak_injection_never_fires_on_full_wgs(tmp_path, monkeypatch):
    """Pins the reference fault the port's soak does not carry over: the
    JAX soak wraps fastq.iter_read_chunks, which the JAX --full-wgs path
    never calls, so its injection does not fire and nothing is retried."""
    from mini_parallel_tpu.io import fastq as jfastq

    _soak_set(tmp_path, monkeypatch)
    calls = []
    real = jfastq.iter_read_chunks

    def dying_iter(path, chunk_size, progress=None):  # the JAX soak's wrapper
        calls.append(path)
        yield from real(path, chunk_size, progress=progress)

    monkeypatch.setattr(jfastq, "iter_read_chunks", dying_iter)
    cfg = JaxConfig(wgs_data_dir="data", sample_id="SCALE", lanes=4,
                    reads_per_lane=1, chunk_size_reads=10)
    out = []
    results = jax_process_full_wgs_dataset(
        JaxEngine(cfg, mode="kadane"), cfg, checkpoint_dir="jax_resil",
        retries=1, echo=out.append)
    assert calls == [] and len(results) == 4
    assert not any("failed" in ln for ln in out)


def test_autotune_one_candidate_sweep_on_the_cpu():
    out = []
    assert autotune.main(["--allow-cpu", "--reads", "6", "--ref-len", "2500",
                          "--segments", "512", "--long-m", "400",
                          "--long-n", "600", "--strip-widths", "128",
                          "--sizes", "256", "--repeats", "1"],
                         echo=out.append) == 0
    winners = [ln for ln in out if ln.startswith("winner")]
    assert winners == [
        next(ln for ln in winners if "segment=512)" in ln),
        next(ln for ln in winners if "sw_score_long(a, b, device, "
             "strip_width=128)" in ln),
        next(ln for ln in winners if "sw_affine_score_long(a, b, device, "
             "strip_width=128)" in ln),
        next(ln for ln in winners if ln.startswith("winner at 256 x 256: ")),
    ]
    assert not any("WRONG" in ln or "FAILED" in ln or "disagree" in ln
                   for ln in out)


def test_autotune_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA card")
    out = []
    assert autotune.main([], echo=out.append) == 1
    assert out[-1].startswith("FAIL:")


@pytest.mark.cuda
def test_kernel_check_gate_on_the_card(small_long, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert kernel_check.main(["--reads", "40"]) == 0
    assert capsys.readouterr().out.count("  PASS  ") == 15
