"""The port's long-pair column-strip engine (ops/sw_long.py) on the CPU,
where each strip runs the plain PyTorch per-strip function: the host loop
against the JAX package's ``sw_score_long`` / ``sw_affine_score_long``
(interpret mode, sb=8, blk=512: 1024-column strips, as
tests/test_sw_long.py runs them) and the blocked NumPy goldens, at narrow
strip widths that force many strips. Exact equality throughout. The CUDA
strip kernel is held against the plain per-strip functions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from mini_parallel_tpu.ops import sw as jsw
from mini_parallel_tpu.ops import sw_long as jsw_long
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.ops import sw, sw_long
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
SB, BLK = 8, 512  # the JAX tests' strip geometry: 1024 columns


def _jax_long(a, b, affine=False, **gaps):
    fn = jsw_long.sw_affine_score_long if affine else jsw_long.sw_score_long
    return fn(a, b, sb=SB, blk=BLK, interpret=True, **gaps)


def _planted(rng, m, n, seg_len, a_at, b_at, insert=0, split=0):
    """Random a, b sharing a segment; b's copy optionally split by an
    ``insert``-base insertion after ``split`` bases."""
    a = np.frombuffer(random_dna(rng, m), np.uint8).copy()
    b = np.frombuffer(random_dna(rng, n), np.uint8).copy()
    seg = np.frombuffer(random_dna(rng, seg_len), np.uint8)
    a[a_at:a_at + seg_len] = seg
    if insert:
        ins = np.frombuffer(random_dna(rng, insert), np.uint8)
        seg = np.concatenate([seg[:split], ins, seg[split:]])
    b[b_at:b_at + seg.size] = seg
    return bytes(a), bytes(b)


def test_goldens_match_jax(rng):
    for m, n in [(1, 1), (7, 13), (80, 64)]:
        a, b = random_dna(rng, m), random_dna(rng, n)
        assert sw_long.sw_score_numpy_blocked(a, b) == \
            jsw.sw_score_numpy(a, b) == jsw_long.sw_score_numpy_blocked(a, b)
        assert sw_long.sw_affine_numpy_blocked(a, b, -3, -2) == \
            jsw.sw_affine_numpy(a, b, gap_open=-3, gap_extend=-2) == \
            jsw_long.sw_affine_numpy_blocked(a, b, -3, -2)


@pytest.mark.parametrize("m,n", [
    (30, 20),      # tiny: one strip narrower than its width
    (200, 150),    # one strip
    (600, 1500),   # two strips of 1024
    (1100, 2100),  # three strips, ragged last
    (513, 1024),   # exact strip-width edge
    (512, 1025),   # one column past the strip edge
])
def test_exact_vs_jax_and_golden(rng, m, n):
    a, b = random_dna(rng, m), random_dna(rng, n)
    got = sw_long.sw_score_long(a, b, CPU, strip_width=1024)
    assert got == _jax_long(a, b) == sw_long.sw_score_numpy_blocked(a, b)
    got = sw_long.sw_affine_score_long(a, b, CPU, strip_width=1024)
    assert got == _jax_long(a, b, affine=True) == \
        sw_long.sw_affine_numpy_blocked(a, b)


def test_geometry_invariance(rng):
    a, b = random_dna(rng, 400, b"ACGTN"), random_dna(rng, 700, b"ACGTN")
    lin, aff = (sw_long.sw_score_numpy_blocked(a, b),
                sw_long.sw_affine_numpy_blocked(a, b, -5, -1))
    for width in (16, 48, 112, 704, 8192):
        assert sw_long.sw_score_long(a, b, CPU, strip_width=width) == lin
        assert sw_long.sw_affine_score_long(a, b, CPU, -5, -1,
                                            strip_width=width) == aff


def test_identical_strings_score_2n(rng):
    a = random_dna(rng, 3000)
    assert sw_long.sw_score_long(a, a, CPU, strip_width=1024) == 6000
    assert sw_long.sw_affine_score_long(a, a, CPU, strip_width=1024) == 6000


def test_common_segment_crossing_strips(rng):
    a, b = _planted(rng, 1500, 1400, 300, 500, 400)  # crosses column 512
    got = sw_long.sw_score_long(a, b, CPU, strip_width=256)
    assert got == sw_long.sw_score_numpy_blocked(a, b) == _jax_long(a, b)
    assert got >= 2 * 300 - 50


def test_gap_state_carries_across_strips(rng):
    """A long insertion whose F state (the gap along j) must survive strip
    boundaries: b's copy of the segment is split by 40 bases at column
    1020, across the 1024 edge and several 32-wide strips."""
    a, b = _planted(rng, 1300, 1300, 400, 300, 800, insert=40, split=220)
    want = sw_long.sw_affine_numpy_blocked(a, b)
    assert want > sw_long.sw_score_numpy_blocked(a, b)  # affine pays less
    assert _jax_long(a, b, affine=True) == want
    for width in (32, 1024):
        assert sw_long.sw_affine_score_long(a, b, CPU,
                                            strip_width=width) == want


def _strip_golden(a, b, left_h, left_f, go, ge):
    """Quadratic DP of one strip with a carried left column."""
    M, W = len(a), len(b)
    neg = -(10**9)
    H = np.zeros((M + 1, W + 1), np.int64)
    E = np.full((M + 1, W + 1), neg, np.int64)
    F = np.full((M + 1, W + 1), neg, np.int64)
    H[1:, 0], F[1:, 0] = left_h, left_f
    for i in range(1, M + 1):
        for j in range(1, W + 1):
            E[i, j] = max(E[i - 1, j], H[i - 1, j] + go) + ge
            F[i, j] = max(F[i, j - 1], H[i, j - 1] + go) + ge
            s = 2 if a[i - 1] == b[j - 1] else -1
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
    return int(H[1:, 1:].max(initial=0)), H[1:, W], F[1:, W]


@pytest.mark.parametrize("M,W", [(1, 1), (37, 16), (60, 5)])
def test_plain_strip_contract(rng, M, W):
    """The per-strip functions against a quadratic DP with the same
    carried-in column(s): best score and carried-out column(s)."""
    a = np.frombuffer(random_dna(rng, M), np.uint8)
    b = np.frombuffer(random_dna(rng, W), np.uint8)
    lh = rng.integers(0, 30, M).astype(np.int32)
    lf = rng.integers(-40, 25, M).astype(np.int32)
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    for go, ge in ((0, -2), (-2, -1)):
        best, rh, rf = _strip_golden(a, b, lh, lf, go, ge)
        got = sw_long.sw_affine_strip(ta, tb, torch.from_numpy(lh),
                                      torch.from_numpy(lf), go, ge)
        assert (int(got[0]), got[1].tolist(), got[2].tolist()) == \
            (best, rh.tolist(), rf.tolist())
    best, rh, _ = _strip_golden(a, b, lh, np.full(M, -(10**9)), 0, -2)
    got = sw_long.sw_strip(ta, tb, torch.from_numpy(lh))
    assert (int(got[0]), got[1].tolist()) == (best, rh.tolist())


def test_empty_inputs_and_bad_width():
    for fn in (sw_long.sw_score_long, sw_long.sw_affine_score_long):
        assert fn(b"", b"ACGT", CPU) == 0
        assert fn(b"ACGT", b"", CPU) == 0
        for width in (0, 24, 8208):
            with pytest.raises(ValueError, match="strip_width"):
                fn(b"ACGT", b"ACGT", CPU, strip_width=width)
    with pytest.raises(ValueError, match="gap costs"):
        sw_long.sw_affine_score_long(b"AC", b"AC", CPU, gap_open=1)


def test_cuda_wrappers_refuse_cpu_tensors():
    a = torch.zeros(8, dtype=torch.uint8)
    col = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sw_long.sw_strip_cuda(a, a[:0], col)
    with pytest.raises(ValueError, match="CUDA"):
        sw_long.sw_affine_strip_cuda(a, a[:0], col, col)
    assert sw_long.strip_best(False, CPU) is sw_long.sw_strip_group
    assert sw_long.strip_best(True, CPU) is sw_long.sw_affine_strip_group


@pytest.mark.parametrize("mode", ["sw", "sw-affine"])
def test_score_strings_routes_long_pairs(rng, monkeypatch, mode):
    """Pairs past LONG_PAIR_THRESHOLD take the strip engine with the
    longer side as rows; shorter pairs stay on the batched kernel path."""
    eng = AlignmentEngine(Config(chunk_size_reads=10, gap_open=-3,
                                 gap_extend=-2), mode=mode, device=CPU)
    golden = (sw_long.sw_score_numpy_blocked if mode == "sw" else
              lambda x, y: sw_long.sw_affine_numpy_blocked(x, y, -3, -2))
    calls = []
    real = sw_long._sweep
    monkeypatch.setattr(sw_long, "_sweep",
                        lambda *a, **k: calls.append(a[1:3]) or real(*a, **k))
    short_a, short_b = random_dna(rng, 300), random_dna(rng, 280)
    assert eng.score_strings(short_a, short_b) == golden(short_a, short_b)
    assert calls == []
    a, b = random_dna(rng, 700), random_dna(rng, 2100)
    assert eng.score_strings(a, b) == golden(a, b)
    assert calls == [(b, a)]  # the longer side became the rows
    monkeypatch.setattr(eng, "LONG_PAIR_THRESHOLD", 250)
    assert eng.score_strings(short_a, short_b) == golden(short_a, short_b)
    assert len(calls) == 2
