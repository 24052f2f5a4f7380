"""The port's measurement harness (mini_parallel_tpu_torch/bench/) on the
CPU, held to the JAX package's root bench scripts and engines on the same
seeded inputs.

- headline: one line with bench.py's keys; its batch == bench.py's, its
  scores == the JAX ``sw_score_batch_best`` (the XLA scan on the CPU);
- workloads: fixtures byte-identical (decompressed) to
  ``bench_workloads._make_fixtures``, the ten row names in the order of
  bench_workloads.py's ``_emit`` calls, and at 300 reads x a 5 kb
  reference the counting results == the JAX engines';
- scaling: on [cpu] x 8 every size == one shard, and the one-shard
  statistics == JAX ``make_wgs_step`` on its 8-device mesh; the row-band
  bytes == the rows a band really hands the next;
- multiprocess: its fixture == bench_multiprocess.py's, and 1 and 2 gloo
  processes give identical merged totals;
- every module exits non-zero with one error line without CUDA, and the
  watchdog prints a null row and exits 3.
"""

import gzip
import hashlib
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_multiprocess
import bench_workloads
from mini_parallel_tpu.models.alignment import AlignmentEngine as JAlignment
from mini_parallel_tpu.models.complementarity import (
    ComplementarityEngine as JComplementarity,
)
from mini_parallel_tpu.models.kmer_model import KmerEngine as JKmer
from mini_parallel_tpu.models.variant_prep import VariantPrepEngine as JVariant
from mini_parallel_tpu.ops import sw_pallas
from mini_parallel_tpu.parallel import pipeline as jpipeline
from mini_parallel_tpu.utils.config import Config as JConfig
from mini_parallel_tpu_torch.bench import (
    _common,
    headline,
    multiprocess,
    scaling,
    workloads,
)
from mini_parallel_tpu_torch.ops import sw_cuda, sw_long
from mini_parallel_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MODULES = ("headline", "workloads", "scaling", "multiprocess")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in the subprocesses: the harness's CPU
    runs are many small torch ops, and with a thread per core in each of
    the suite's workers every op waits for threads the other workers hold
    (the battery's setup then runs about 20x slower)."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _rows(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def _gunzip(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


# ----------------------------------------------------------------------
# headline
# ----------------------------------------------------------------------


def test_headline_line_and_scores_match_jax(tmp_path):
    """--reads 64 on the CPU: one line with bench.py's keys, correct; the
    port's scores on the batch == JAX sw_score_batch_best's."""
    out = tmp_path / "h.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mini_parallel_tpu_torch.bench.headline",
         "--reads", "64", "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row == _rows(out)[0]
    assert {"metric", "value", "unit", "vs_baseline", "extra"} <= row.keys()
    assert {"batch_latency_ms", "reads_per_s", "device"} <= row["extra"].keys()
    assert row["metric"] == "batched_sw_10k_reads_150bp"
    assert row["unit"] == "GCUPS" and row["correct"] is True
    assert row["device"] == {"name": "cpu", "power_limit_w": None,
                             "nvidia_smi": None}
    assert row["bound_share"] is None and row["bound_by"] == "operations"
    # 64 x 150 x 150 cells x 6 instructions over 16.73 T/s
    assert row["bound_ms"] == pytest.approx(
        64 * 150 * 150 * 6 / (132 * 64 * 1.98e9) * 1e3)
    assert headline.bound_ms(10_000)[0] == pytest.approx(0.0807, abs=1e-4)

    a, b = headline.make_batch(64)
    want = np.asarray(sw_pallas.sw_score_batch_best(jnp.asarray(a),
                                                    jnp.asarray(b)))
    got = sw_cuda.sw_score_batch_best(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert row["extra"]["score_sum"] == int(want.sum())
    assert row["extra"]["score_max"] == int(want.max())


def test_headline_batch_is_bench_py_batch():
    """make_batch draws exactly as bench.py's main does (read from its
    source: rng 0, two (READS, 150) choices, PAD 152)."""
    src = open(os.path.join(REPO, "bench.py")).read()
    assert "rng = np.random.default_rng(0)" in src
    assert re.search(r"^PAD = 152\b", src, re.M)
    a, b = headline.make_batch(16)
    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    np.testing.assert_array_equal(a[:, :150], rng.choice(base, (16, 150)))
    np.testing.assert_array_equal(b[:, :150], rng.choice(base, (16, 150)))
    assert a.shape == b.shape == (16, 152)
    assert (a[:, 150:] != b[:, 150:]).all()  # PAD_A vs PAD_B


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------


def _jax_emit_names() -> list[str]:
    """The metric names of bench_workloads.py's ``_emit`` calls, in source
    order, the ``f"self_align_{mode}"`` call expanded over its loop."""
    src = open(os.path.join(REPO, "bench_workloads.py")).read()
    body = src[src.index("def main"):]
    names = []
    for m in re.finditer(r'_emit\(\s*(f?)"([^"]+)"', body):
        if m.group(1):
            loop = re.findall(r"for (\w+) in \(([^)]*)\):", body[:m.start()])
            var, values = loop[-1]
            names += [m.group(2).replace("{%s}" % var, v)
                      for v in re.findall(r'"(\w+)"', values)]
        else:
            names.append(m.group(2))
    return names


@pytest.mark.parametrize("n_reads,ref_len", [(40, 1000), (7, 300)])
def test_workload_fixtures_byte_identical(tmp_path, n_reads, ref_len):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    ref, lane, mapped = workloads.make_fixtures(str(mine), n_reads, ref_len)
    jref, jlane, jmapped = bench_workloads._make_fixtures(str(theirs),
                                                          n_reads, ref_len)
    assert ref == jref and len(ref) == ref_len
    assert _gunzip(lane) == _gunzip(jlane)
    assert _gunzip(mapped) == _gunzip(jmapped)
    assert _gunzip(lane).count(b"\n") == 4 * n_reads


def test_workload_row_names_follow_jax_source():
    assert list(workloads.ROWS) == _jax_emit_names()
    assert len(workloads.ROWS) == 10


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    """The battery at --reads 300 --ref 5000 on the CPU (one timed run a
    row, 300 Pair-HMM lanes), and the JAX engines on the same fixture."""
    tmp = tmp_path_factory.mktemp("battery")
    out = tmp / "rows.json"
    rc = workloads.main(["--reads", "300", "--ref", "5000", "--repeats", "1",
                         "--device", "cpu",
                         "--out", str(out)])
    rows = {r["metric"]: r for r in _rows(out)}
    ref, lane, mapped = bench_workloads._make_fixtures(str(tmp), 300, 5000)
    cfg = JConfig(chunk_size_reads=10_000)
    gcfg = JConfig(chunk_size_reads=2_000)
    want = {}
    for mode in ("kadane", "sw"):
        r = JAlignment(cfg, mode=mode).self_align_file(lane)
        want[f"self_align_{mode}"] = {"reads": r.total_reads,
                                      "bases": r.total_bases,
                                      "score": r.score}
    r = JComplementarity(cfg).analyze_lane_pair(lane, lane)
    want["complementarity_pairs"] = {"pairs": r.pairs,
                                     "perfect_pairs": r.perfect_pairs}
    for name, mode in (("kmer_k21_worst_case", "summary"),
                       ("kmer_k21_full_drain", "full")):
        r = JKmer(cfg).count_file(lane, result_mode=mode)
        want[name] = {"distinct": r.distinct_kmers}
    for name, c, kw in (("variant_prep_ungapped", cfg, {}),
                        ("variant_prep_gapped", gcfg, {"gapped": True}),
                        ("variant_prep_gapped_affine", gcfg,
                         {"gapped": True, "gap_model": "affine"})):
        r = JVariant(ref, c, **kw).process_file(mapped)
        want[name] = {"mapping_rate": r.mapping_rate,
                      "mapped_reads": r.mapped_reads,
                      "candidates": len(r.candidates)}
    return rc, rows, want


def test_battery_rows_in_order_and_correct(battery):
    rc, rows, _ = battery
    assert rc == 0
    assert list(rows) == list(workloads.ROWS)
    for name, row in rows.items():
        assert row["correct"] is True, name
        assert row["unit"] == "reads_per_s" and row["value"] > 0, name
        assert row["min"] <= row["value"] <= row["max"], name
        assert row["device"]["name"] == "cpu", name
    assert rows["self_align_sw"]["extra"]["score"] == 2 * 300 * 150
    assert rows["pairhmm_forward_pairs"]["extra"]["max_abs_dlog10"] == 0.0
    assert rows["genotype_sites"]["extra"]["sites"] == 40


@pytest.mark.parametrize("name", ["self_align_kadane", "self_align_sw",
                                  "complementarity_pairs",
                                  "kmer_k21_worst_case", "kmer_k21_full_drain",
                                  "variant_prep_ungapped",
                                  "variant_prep_gapped",
                                  "variant_prep_gapped_affine"])
def test_battery_counts_match_jax_engines(battery, name):
    _, rows, want = battery
    extra = rows[name]["extra"]
    assert {k: extra[k] for k in want[name]} == want[name]


# ----------------------------------------------------------------------
# scaling
# ----------------------------------------------------------------------


def test_scaling_cpu_mesh_matches_one_shard_and_jax(tmp_path, mesh8):
    out = tmp_path / "s.json"
    assert scaling.main(["--cpu", "--reads", "256", "--out", str(out)]) == 0
    rows = _rows(out)
    step_row = rows[0]
    assert step_row["metric"] == "wgs_step_scaling"
    assert [r["devices"] for r in step_row["rows"]] == [1, 2, 4, 8]
    assert all(r["stats_bit_exact_vs_local"] for r in step_row["rows"])
    assert step_row["performance_representative"] is False
    assert step_row["correct"] is True
    assert [r["metric"] for r in rows[1:]] == ["long_pair_row_bands"] * 2

    arr_a, arr_b, lens = scaling.make_batch(256, 150)
    want = jax.device_get(jpipeline.make_wgs_step(mesh8)(
        *jpipeline.shard_batch(mesh8, tuple(
            jnp.asarray(x) for x in (arr_a, arr_b, lens, lens)))))
    want = scaling.stats_summary({k: np.asarray(v) for k, v in want.items()})
    assert step_row["local_stats"] == want


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("bands", [2, 4])
def test_band_bytes_equal_rows_handed_on(monkeypatch, affine, bands):
    """Run the row-band host loop on the CPU and sum the bytes of the top
    rows each band below the first receives: == the geometry's bytes."""
    M, N, W, per_group = 300, 700, 64, 3
    received: dict = {}  # band rows (by their a) -> top-row bytes
    order: list = []
    plain = sw_long.strip_best

    def counting(affine_, device):
        fn = plain(affine_, device)

        def wrapped(a, *args, **kw):
            if a.data_ptr() not in received:
                order.append(a.data_ptr())
                received[a.data_ptr()] = 0
            received[a.data_ptr()] += sum(
                kw[k].numel() * kw[k].element_size()
                for k in ("top_h", "top_e") if k in kw)
            return fn(a, *args, **kw)
        return wrapped

    monkeypatch.setattr(sw_long, "strip_best", counting)
    rng = np.random.default_rng(bands)
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), M)
    b = rng.choice(np.frombuffer(b"ACGT", np.uint8), N)
    mesh = make_mesh((1, bands), devices=[CPU] * bands)
    fn = (sw_long.sw_affine_score_long_sharded if affine
          else sw_long.sw_score_long_sharded)
    fn(a, b, mesh, strip_width=W, strips_per_group=per_group)
    geo = scaling.band_geometry(M, N, bands, affine, strip_width=W,
                                strips_per_group=per_group)
    handed = [received[p] for p in order[1:]]  # band 0's top is the edge
    assert len(handed) == bands - 1
    assert handed == [geo["handoff_bytes_per_boundary"]] * (bands - 1)
    assert sum(handed) == geo["handoff_bytes_total"]
    assert geo["groups"] == 4 and geo["stages"] == 4 + bands - 1
    assert geo["strips"] == 11 and geo["band_rows"] == [
        r1 - r0 for r0, r1 in sw_long.band_bounds(M, bands)]


# ----------------------------------------------------------------------
# multiprocess
# ----------------------------------------------------------------------


def test_multiprocess_fixture_byte_identical(tmp_path):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    multiprocess.make_fixture(str(mine), 0.002)
    bench_multiprocess._make_fixture(str(theirs), 0.002)
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names and len(names) == 8
    for name in names:
        assert _gunzip(mine / name) == _gunzip(theirs / name), name


def test_multiprocess_totals_identical_at_1_and_2(tmp_path):
    out = tmp_path / "mp.json"
    rc = multiprocess.main(["--sizes", "1,2", "--reads-scale", "0.02",
                            "--device", "cpu", "--out", str(out)])
    rows = _rows(out)
    assert rc == 0
    by_n = {r["nproc"]: r for r in rows if "nproc" in r}
    assert list(by_n) == [1, 2]
    reads = sum(int(n * 0.02) for n in multiprocess.LANE_READS)
    assert by_n[1]["merged"] == by_n[2]["merged"]
    assert by_n[1]["merged"]["reads"] == reads
    assert by_n[1]["merged"]["files"] == 8
    assert by_n[1]["merged"]["bases"] == 150 * reads
    for r in by_n.values():
        assert r["correct"] and r["bit_exact_vs_1proc"]
        assert r["performance_representative"] is False
        assert sum(r["reads_per_local_shard"]) == reads
    # one process gathers nothing; two merge their totals over gloo
    assert by_n[1]["allgather_calls"] == 0
    assert by_n[2]["allgather_calls"] > 0
    assert by_n[2]["allgather_bytes_out"] == 2 * by_n[2]["allgather_bytes_in"]
    assert by_n[1]["work_inflation"] == 1.0
    assert rows[-1]["metric"] == "multiprocess_work_inflation_4proc"
    assert rows[-1]["value"] is None and rows[-1]["correct"] is True


# ----------------------------------------------------------------------
# refusals and the watchdog
# ----------------------------------------------------------------------


def test_each_module_refuses_without_cuda():
    """No CUDA and no --device cpu / --cpu: exit 2, nothing on stdout, one
    error line (the four modules started together)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", f"mini_parallel_tpu_torch.bench.{m}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for m in MODULES}
    for m, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode == 2, (m, err)
        assert out == "", m
        lines = err.strip().splitlines()
        assert len(lines) == 1 and "CUDA is not available" in lines[0], m


def test_watchdog_prints_null_row_and_exits_3(tmp_path):
    env = dict(os.environ, MPT_BENCH_TIMEOUT="0")
    proc = subprocess.run(
        [sys.executable, "-m", "mini_parallel_tpu_torch.bench.headline",
         "--reads", "2000", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["metric"] == "batched_sw_10k_reads_150bp"
    assert row["value"] is None and row["correct"] is False
    assert "no measurement after 0 s" in row["error"]


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 PCIe, 350.00 W", "NVIDIA H100 PCIe", 350.0),
    ("Some Card, [N/A]", "Some Card", None),
])
def test_card_fields_parse_nvidia_smi(monkeypatch, line, name, watts):
    monkeypatch.setattr(_common, "nvidia_smi_line", lambda: line)
    fields = _common.card_fields(torch.device("cuda", 0))
    assert fields == {"name": name, "power_limit_w": watts,
                      "nvidia_smi": line}
    assert _common.card_fields(CPU)["name"] == "cpu"


def test_emitter_exit_code_and_out_file(tmp_path, capsys):
    out = tmp_path / "rows.json"
    em = _common.Emitter({"name": "cpu", "power_limit_w": None}, str(out))
    row = {"metric": "m", "value": 1.0, "correct": 1}
    printed = em.emit(row)
    assert "device" not in row  # the caller's row is left as it was
    assert list(printed) == ["metric", "value", "device", "correct"]
    assert em.finish() == 0
    em.emit({"metric": "n", "value": None, "correct": False})
    assert em.finish() == 1
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] \
        == _rows(out)


def test_no_module_imports_jax_or_the_jax_package():
    """The harness imports torch and its own package only: no jax, no
    mini_parallel_tpu, no root bench script (read from the sources and in a
    fresh interpreter)."""
    bench_dir = os.path.join(REPO, "mini_parallel_tpu_torch", "bench")
    pat = re.compile(r"^\s*(from|import)\s+(jax\b|mini_parallel_tpu\b(?!_)"
                     r"|bench(_\w+)?\b)", re.M)
    for name in os.listdir(bench_dir):
        if name.endswith(".py"):
            src = open(os.path.join(bench_dir, name)).read()
            assert not pat.search(src), name
    code = ("import sys; import " + ", ".join(
        f"mini_parallel_tpu_torch.bench.{m}" for m in MODULES)
        + "; bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'mini_parallel_tpu.')) or m == 'mini_parallel_tpu' or "
        "m.startswith('bench')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_card_timer_on_cpu_reports_median_min_max():
    calls = []
    t = _common.card_times(lambda: calls.append(1), CPU, launches=3,
                           repeats=5)
    assert len(calls) == 1 + 5 * 3  # a warm-up, then 5 runs of 3
    assert t["samples"] == 5 and t["launches"] == 3
    assert t["min_ms"] <= t["ms"] <= t["max_ms"]
    assert t["timer"] == "host_clock"
    digest = hashlib.sha256(np.arange(3, dtype=np.int32).tobytes())
    assert scaling.stats_summary({"h": np.arange(3), "s": np.int32(7)}) == {
        "h": digest.hexdigest(), "s": 7}
