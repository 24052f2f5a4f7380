"""The port's pair paths on the CPU against the JAX package on the same
FASTQ/FASTA fixtures: ``pair_align_files`` in all four modes, mate-pair
complementarity, ``self_align_file`` in ``sw-affine`` and ``contiguous``,
FASTA I/O, and the CLI's ``--files``, ``--complementarity``,
``--long-align`` and direct-pair outputs (mirroring
tests/test_cli_matrix.py). Exact equality throughout."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from mini_parallel_tpu import cli as jcli
from mini_parallel_tpu.io import fasta as jfasta
from mini_parallel_tpu.models.alignment import AlignmentEngine as JaxEngine
from mini_parallel_tpu.models.complementarity import (
    ComplementarityEngine as JaxComplementarity,
)
from mini_parallel_tpu.utils.config import Config as JaxConfig
from mini_parallel_tpu_torch import cli
from mini_parallel_tpu_torch.io import fasta, fastq
from mini_parallel_tpu_torch.models import alignment
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.models.complementarity import (
    ComplementarityEngine,
)
from mini_parallel_tpu_torch.ops import sw_long
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
MODES = ("kadane", "sw", "sw-affine", "contiguous")
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _jax_cfg(cfg, **jax_only):
    """The JAX package's Config of ``cfg``, with ``jax_only`` fields the
    port does not have (its ``packed_transfer`` route switch)."""
    return JaxConfig(**dataclasses.asdict(cfg), **jax_only)


def _reads(rng, n, lo, hi, alphabet=b"ACGTN"):
    return [random_dna(rng, int(rng.integers(lo, hi + 1)), alphabet)
            for _ in range(n)]


@pytest.fixture
def lanes(tmp_path, rng):
    """R1 of 23 reads; R2 of 19 (unequal lanes): 14 mates are the reverse
    complement of R1 (2 of them with one substitution), the rest random;
    ragged 40-150 bp with N bases."""
    r1 = _reads(rng, 23, 40, 150)
    r2 = [r.translate(_RC)[::-1] for r in r1[:14]] + _reads(rng, 5, 40, 150)
    for k in (3, 9):
        r2[k] = (b"A" if r2[k][:1] != b"A" else b"C") + r2[k][1:]
    paths = [str(tmp_path / f"lane_R{i}.fastq.gz") for i in (1, 2)]
    for path, reads in zip(paths, (r1, r2)):
        fastq.write_fastq(path, reads)
    return paths


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("jax_packed", [True, False])
def test_pair_align_files_matches_jax(lanes, mode, jax_packed):
    """The port's one (packed) route against the JAX package's packed and
    raw routes; with the raw one, a read_pad the port rounds up to 64."""
    cfg = Config(chunk_size_reads=5, read_pad=152 if jax_packed else 62,
                 gap_open=-3, gap_extend=-1)
    got = AlignmentEngine(cfg, mode=mode, device=CPU).pair_align_files(*lanes)
    want = JaxEngine(_jax_cfg(cfg, packed_transfer=jax_packed),
                     mode=mode).pair_align_files(*lanes)
    assert (got.score, got.bases1, got.bases2) == \
        (want.score, want.bases1, want.bases2)
    assert got.device == "cpu" and got.processing_time_ms > 0


def test_pair_mode_zip_stops_at_shorter_file_and_joins(lanes):
    """The mate zip ends with the shorter file; both prefetch threads are
    stopped and joined when the loop ends, on an exception too."""
    eng = AlignmentEngine(Config(chunk_size_reads=4), mode="sw", device=CPU)
    res = eng.pair_align_files(*lanes)
    swapped = eng.pair_align_files(lanes[1], lanes[0])
    assert res.score == swapped.score and res.bases1 == swapped.bases2
    assert not [t for t in threading.enumerate() if t.name == "mptt-prefetch"]

    def boom(*args, **kwargs):
        raise RuntimeError("device failure")

    eng._score_flat_pairs = boom
    with pytest.raises(RuntimeError, match="device failure"):
        eng.pair_align_files(*lanes)
    assert not [t for t in threading.enumerate() if t.name == "mptt-prefetch"]


@pytest.mark.parametrize("mode", ["sw", "kadane"])
@pytest.mark.parametrize("jax_packed", [True, False])
def test_complementarity_matches_jax(lanes, mode, jax_packed):
    """The port's one (packed) route against the JAX package's packed and
    raw routes."""
    cfg = Config(chunk_size_reads=4)
    logs = []
    got = ComplementarityEngine(cfg, mode=mode, device=CPU).analyze_lane_pair(
        *lanes, progress=logs.append)
    jlogs = []
    want = JaxComplementarity(_jax_cfg(cfg, packed_transfer=jax_packed),
                              mode=mode).analyze_lane_pair(
        *lanes, progress=jlogs.append)
    fields = ("pairs", "direct_score_sum", "comp_score_sum", "perfect_pairs",
              "unpaired_reads")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert (got.pairs, got.unpaired_reads, got.perfect_pairs) == (19, 4, 12)
    assert got.pct_non_complementary == want.pct_non_complementary
    assert logs == jlogs
    # lanes swapped: the longer lane is now R2
    swapped = ComplementarityEngine(cfg, mode=mode, device=CPU) \
        .analyze_lane_pair(lanes[1], lanes[0])
    assert (swapped.pairs, swapped.unpaired_reads) == (19, 4)


def test_complementarity_pad_rule():
    eng = ComplementarityEngine(Config(chunk_size_reads=4, read_pad=150),
                                device=CPU)
    assert [eng._pad_for_len(n) for n in (1, 151, 153, 160, 161)] == \
        [152, 152, 160, 160, 168]


@pytest.mark.parametrize("mode", ["sw-affine", "contiguous"])
@pytest.mark.parametrize("jax_packed", [True, False])
def test_self_align_file_new_modes_match_jax(tmp_path, rng, mode, jax_packed):
    reads = _reads(rng, 23, 150, 280)
    reads[7] = reads[7][:3]
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    # the port's one (packed) route against the JAX package's packed and
    # raw routes; with the raw one, a read_pad the port rounds up to 64
    cfg = Config(chunk_size_reads=5, read_pad=64 if jax_packed else 62,
                 gap_open=-4, gap_extend=-1)
    got = AlignmentEngine(cfg, mode=mode, device=CPU).self_align_file(path)
    want = JaxEngine(_jax_cfg(cfg, packed_transfer=jax_packed),
                     mode=mode).self_align_file(path)
    assert (got.score, got.total_bases, got.total_reads, got.chunks) == \
        (want.score, want.total_bases, want.total_reads, want.chunks)
    assert got.failed_chunks == 0
    if mode == "sw-affine":
        assert got.score == 2 * sum(map(len, reads))


def test_score_strings_all_modes_match_jax(rng):
    cfg = Config(chunk_size_reads=5, gap_open=-3, gap_extend=-2)
    pairs = [("ACGT", "ACGA"), ("AAAATTTCCCC", "AAAACCCC"), ("", "ACGT"),
             (random_dna(rng, 90, b"ACGTN"), random_dna(rng, 70, b"ACGTN"))]
    for mode in MODES:
        eng = AlignmentEngine(cfg, mode=mode, device=CPU)
        jeng = JaxEngine(_jax_cfg(cfg), mode=mode)
        for a, b in pairs:
            assert eng.score_strings(a, b) == jeng.score_strings(a, b), mode


def test_fasta_round_trip_matches_jax(tmp_path, rng):
    recs = {"chr1": random_dna(rng, 150), "chr2 extra words": b"acgtn" * 3}
    for name in ("r.fa", "r.fa.gz"):
        path = str(tmp_path / name)
        fasta.write_fasta(path, recs)
        assert fasta.read_fasta(path) == jfasta.read_fasta(path)
        assert fasta.read_first_sequence(path) == recs["chr1"]
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    with pytest.raises(ValueError, match="no FASTA records"):
        fasta.read_first_sequence(str(empty))


# ----------------------------------------------------------------------
# The CLI against the JAX package's CLI
# ----------------------------------------------------------------------

# lines that name the device or a time differ between the packages
_VARIABLE = ("Device:", "Processing time:", "Time:")


def _both(argv, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "5")
    out, jout = [], []
    rc = cli.main(argv + ["--allow-cpu"], echo=out.append)
    jrc = jcli.main(argv + ["--allow-cpu"], echo=jout.append)
    keep = lambda lines: [ln for ln in lines  # noqa: E731
                          if not ln.startswith(_VARIABLE)]
    return rc, jrc, keep(out), keep(jout)


@pytest.mark.parametrize("mode", MODES)
def test_cli_files_matches_jax(lanes, monkeypatch, tmp_path, mode):
    rc, jrc, out, jout = _both(["--files", "-1", lanes[0], "-2", lanes[1],
                                "--mode", mode], monkeypatch, tmp_path)
    assert rc == jrc == 0
    assert out == jout
    assert any(ln.startswith("Alignment score:") for ln in out)


@pytest.mark.parametrize("mode_args", [[], ["--mode", "kadane"]])
def test_cli_complementarity_matches_jax(lanes, monkeypatch, tmp_path,
                                         mode_args):
    rc, jrc, out, jout = _both(["--complementarity", "-1", lanes[0], "-2",
                                lanes[1]] + mode_args, monkeypatch, tmp_path)
    assert rc == jrc == 0
    assert out == jout
    assert "Non-complementary: 36.84 %" in out  # 12 of 19 perfect


@pytest.mark.parametrize("mode_args", [[], ["--mode", "sw-affine"]])
def test_cli_long_align_matches_jax(rng, monkeypatch, tmp_path, mode_args):
    a, b = random_dna(rng, 900), random_dna(rng, 700)
    fa, fb = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    fasta.write_fasta(fa, {"a": a})
    fasta.write_fasta(fb, {"b": b})
    rc, jrc, out, jout = _both(["--long-align", "-1", fb, "-2", fa]
                               + mode_args, monkeypatch, tmp_path)
    assert rc == jrc == 0
    pick = lambda lines: [ln for ln in lines  # noqa: E731
                          if ln.startswith(("Sequences:", "Alignment score:"))]
    assert pick(out) == pick(jout)
    golden = (sw_long.sw_affine_numpy_blocked(a, b) if mode_args
              else sw_long.sw_score_numpy_blocked(a, b))
    assert f"Alignment score: {golden}" in out


def test_cli_long_align_refuses_other_modes(monkeypatch, tmp_path):
    monkeypatch.setenv("MPT_MODE", "kadane")  # env default falls back to sw
    for mode in ("kadane", "contiguous"):
        out = []
        assert cli.main(["--long-align", "-1", "a.fa", "-2", "b.fa", "--mode",
                         mode, "--allow-cpu"], echo=out.append) == 2
        assert out[-1] == "ERROR: --long-align supports --mode sw or sw-affine"
    fa = str(tmp_path / "s.fa")
    fasta.write_fasta(fa, {"s": b"ACGTACGT"})
    out = []
    assert cli.main(["--long-align", "-1", fa, "-2", fa, "--allow-cpu"],
                    echo=out.append) == 0
    assert "Alignment score: 16" in out and "(0.00 Gcells, sw)" in out[-4]
    out = []
    assert cli.main(["--long-align", "-1", "missing.fa", "-2", fa,
                     "--allow-cpu"], echo=out.append) == 1


def test_cli_direct_pairs_match_jax(rng, monkeypatch, tmp_path):
    long_a, b = random_dna(rng, 2100).decode(), random_dna(rng, 300).decode()
    for mode in MODES:
        for pair in (["ACGTACGT", "ACGAACGT"], [b, long_a]):
            rc, jrc, out, jout = _both(["-1", pair[0], "-2", pair[1],
                                        "--mode", mode], monkeypatch, tmp_path)
            assert rc == jrc == 0
            assert out[-1] == jout[-1] and out[-1].startswith("Alignment score:")


def test_cli_pair_flags_need_both_sides(monkeypatch):
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "5")
    for flag, msg in (("--files", "--files requires"),
                      ("--complementarity", "--complementarity requires"),
                      ("--long-align", "--long-align requires")):
        out = []
        assert cli.main([flag, "-1", "a", "--allow-cpu"], echo=out.append) == 2
        assert msg in out[-1]
    monkeypatch.delenv("GPU_CHUNK_SIZE_READS")
    monkeypatch.delenv("CHUNK_SIZE_READS", raising=False)
    with pytest.raises(Exception, match="GPU_CHUNK_SIZE_READS"):
        cli.main(["--files", "-1", "a", "-2", "b", "--allow-cpu", "--env",
                  "none.env"])


def test_pair_paths_leave_kernel_counters_untouched(lanes, monkeypatch):
    from mini_parallel_tpu_torch.ops import sw_cuda

    for fn in (sw_cuda.sw_score_batch_cuda, sw_cuda.sw_affine_batch_cuda,
               sw_long.sw_strip_cuda, sw_long.sw_affine_strip_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    cfg = Config(chunk_size_reads=5)
    for mode in ("sw", "sw-affine"):
        AlignmentEngine(cfg, mode=mode, device=CPU).pair_align_files(*lanes)
    ComplementarityEngine(cfg, device=CPU).analyze_lane_pair(*lanes)
    assert sw_long.sw_score_long(b"ACGT" * 600, b"ACGT", CPU) == 8
    assert alignment.MODES == MODES
    assert [fn.launches for fn in (
        sw_cuda.sw_score_batch_cuda, sw_cuda.sw_affine_batch_cuda,
        sw_long.sw_strip_cuda, sw_long.sw_affine_strip_cuda)] == [0, 0, 0, 0]
