"""The two kernels' work splits on the CPU, through their plain mirrors:

- ``ops.sw.sweep_segments``, the plain mirror of csrc/sw_vs_ref.cu's
  segment decomposition (each segment's DP from a zero edge 2M columns
  early, reports of its own columns only, the 64-bit key reduction and its
  decode), against ``sw_vs_ref_batch`` and the JAX Pallas kernel
  ``sw_vs_ref_batch_pallas`` in interpret mode, with exact equality, at
  segment widths of 16-64 columns (many segments), with ties and best
  paths across segment edges, all-pad and all-N reads, rows past one
  stripe (M > 256) and N not a multiple of the segment width;
- the long-pair host loop's plain group path (csrc/sw_long.cu sweeps one
  group of strips per launch) at several group sizes and narrow strip
  widths, against the blocked NumPy goldens and the JAX package's
  ``sw_score_long`` / ``sw_affine_score_long`` in interpret mode.

The kernels themselves are held to the same cases on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu.ops import sw_long as jsw_long
from mini_parallel_tpu.ops.sw_pallas import sw_vs_ref_batch_pallas
from mini_parallel_tpu_torch.ops import encode, sw, sw_long
from tests.conftest import random_dna

CPU = torch.device("cpu")
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _three_ways(reads: np.ndarray, ref: np.ndarray, segment: int):
    """(mirror, plain, JAX interpret) results as numpy pairs."""
    tr, tf = torch.from_numpy(reads), torch.from_numpy(ref)
    mirror = [t.numpy() for t in sw.sweep_segments(tr, tf, segment)]
    plain = [t.numpy() for t in sw.sw_vs_ref_batch(tr, tf)]
    jax = [np.asarray(t) for t in sw_vs_ref_batch_pallas(
        jnp.asarray(reads), jnp.asarray(ref), interpret=True)]
    return mirror, plain, jax


def _assert_same(reads, ref, segment):
    mirror, plain, jax = _three_ways(reads, ref, segment)
    for m, p, j in zip(mirror, plain, jax):
        assert m.dtype == np.int32
        np.testing.assert_array_equal(m, p)
        np.testing.assert_array_equal(m, j)
    return mirror


def _case(rng, B: int, M: int, N: int):
    """A reference with a repeat and an N run; reads cut from it (with
    substitutions), reads inside the repeat, all-pad, all-N and unrelated
    reads."""
    ref = rng.choice(_ACGT, N)
    seg = min(40, N // 5)
    ref[N // 2:N // 2 + seg] = ref[10:10 + seg]  # a repeat: equal ends
    ref[N // 3:N // 3 + 12] = ord("N")
    rows = []
    for k in range(B):
        la = int(rng.integers(1, M + 1))
        s = int(rng.integers(0, max(1, N - la)))
        cut = ref[s:s + la].copy()
        cut[rng.random(cut.size) < 0.05] = ord("A")
        rows.append([b"", ref[10:10 + min(la, seg)].tobytes(), cut.tobytes(),
                     b"N" * la, rng.choice(_ACGT, la).tobytes()][k % 5])
    reads, _ = encode.pad_batch(rows, pad_to=M, pad_value=int(encode.PAD_A))
    return reads, ref


@pytest.mark.parametrize("B,M,N,segment", [
    (15, 40, 400, 16),   # 25 segments, each behind an 80-column warm-up
    (11, 37, 133, 24),   # N not a multiple of the segment width
    (10, 13, 300, 64),
    (12, 24, 250, 48),
    (6, 8, 97, 1),       # one column a segment
])
def test_segments_match_plain_and_pallas(B, M, N, segment):
    rng = np.random.default_rng(B * 1000 + M + N + segment)
    reads, ref = _case(rng, B, M, N)
    scores, ends = _assert_same(reads, ref, segment)
    assert scores[0] == 0 and ends[0] == -1  # the all-pad row
    assert (ends[scores == 0] == -1).all() and (ends[scores > 0] >= 0).all()


@pytest.mark.parametrize("segment", [16, 32, 40, 64])
def test_equal_best_in_two_segments_keeps_the_smaller_end(segment):
    """The read occurs twice, exactly, in different segments: both reach
    the same best, and the smaller end must win whatever order the
    segments meet in."""
    rng = np.random.default_rng(segment)
    ref = rng.choice(_ACGT, 600)
    read = rng.choice(_ACGT, 20)
    ref[100:120] = read
    ref[400:420] = read
    reads, _ = encode.pad_batch([read.tobytes(), b"", read[:7].tobytes()],
                                pad_to=24, pad_value=int(encode.PAD_A))
    scores, ends = _assert_same(reads, ref, segment)
    assert scores[0] == 40 and ends[0] == 119
    assert 119 // segment != 419 // segment  # two segments
    assert scores[2] == 14 and ends[2] <= 106


@pytest.mark.parametrize("segment", [16, 32, 48])
def test_best_path_across_a_segment_edge(segment):
    """The read's copy straddles a segment edge, with a gap: its best cell
    lies in the later segment, its path starts in the earlier one, so only
    the warm-up columns make the later segment exact."""
    rng = np.random.default_rng(7 + segment)
    ref = rng.choice(_ACGT, 500)
    edge = 4 * segment
    copy = ref[edge - 30:edge + 30].copy()
    read = np.concatenate([copy[:25], copy[28:]])  # a 3-base deletion
    reads, _ = encode.pad_batch([read.tobytes(), copy[20:50].tobytes()],
                                pad_to=64, pad_value=int(encode.PAD_A))
    scores, ends = _assert_same(reads, ref, segment)
    assert ends[0] == edge + 29 and scores[0] >= 2 * 57 - 6  # the gap: -6
    assert ends[1] == edge + 19 and scores[1] == 60
    # a segment's own cells alone (no warm-up) would miss the path
    tr = torch.from_numpy(reads)
    own, _ = sw._vs_ref_rows(tr, torch.from_numpy(ref[edge:]))
    assert int(own[0]) < scores[0]


def test_all_pad_and_all_n_reads():
    rng = np.random.default_rng(5)
    ref = rng.choice(_ACGT, 200)
    ref[60:90] = ord("N")
    reads, _ = encode.pad_batch([b"", b"N" * 20, b"", b"N" * 5 + b"ACGT"],
                                pad_to=20, pad_value=int(encode.PAD_A))
    scores, ends = _assert_same(reads, ref, 16)
    assert (scores[[0, 2]] == 0).all() and (ends[[0, 2]] == -1).all()
    assert scores[1] == 40 and ends[1] == 79  # the N run matches N


def test_rows_past_one_stripe():
    """M = 300 > 256 rows: the kernel's stripes, with a scratch row of
    segment + 2M values per warp."""
    rng = np.random.default_rng(300)
    reads, ref = _case(rng, 6, 300, 260)
    scores, _ = _assert_same(reads, ref, 32)
    assert scores.max() > 0


def test_key_decode_round_trip():
    scores = torch.tensor([0, 1, 300, 5, 2**20], dtype=torch.int64)
    ends = torch.tensor([0, 0, 17, 2**31 - 2, 123_456_789], dtype=torch.int64)
    keys = torch.where(scores > 0, (scores << 32) | (sw.INT32_MAX - ends), 0)
    got_s, got_e = sw.decode_vs_ref_keys(keys)
    assert got_s.tolist() == scores.tolist()
    assert got_e.tolist() == [-1, 0, 17, 2**31 - 2, 123_456_789]
    # the max key is the max score, then the smaller end
    two = torch.tensor([(7 << 32) | (sw.INT32_MAX - 40),
                        (7 << 32) | (sw.INT32_MAX - 12)])
    assert sw.decode_vs_ref_keys(two.max().reshape(1))[1].tolist() == [12]


def test_sweep_segments_refuses_bad_width():
    reads = torch.zeros((1, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="segment"):
        sw.sweep_segments(reads, torch.zeros(8, dtype=torch.uint8), 0)


# ----------------------------------------------------------------------
# the long-pair host loop's plain group path
# ----------------------------------------------------------------------


def _planted_pair(rng, m, n):
    """a, b sharing a 200-base segment whose copy in b is split by a
    15-base insertion, across many narrow strips."""
    a = np.frombuffer(random_dna(rng, m), np.uint8).copy()
    b = np.frombuffer(random_dna(rng, n), np.uint8).copy()
    seg = np.frombuffer(random_dna(rng, 200), np.uint8)
    a[m // 4:m // 4 + 200] = seg
    copy = np.concatenate([seg[:90], np.frombuffer(random_dna(rng, 15),
                                                   np.uint8), seg[90:]])
    b[n // 3:n // 3 + copy.size] = copy
    return bytes(a), bytes(b)


@pytest.mark.parametrize("width,per_group", [
    (16, 1), (16, 5), (32, 3), (48, 2), (64, 100), (512, 1)])
def test_long_group_path_matches_goldens_and_jax(rng, width, per_group):
    a, b = _planted_pair(rng, 500, 610)  # 610: a ragged last strip
    lin = sw_long.sw_score_long(a, b, CPU, strip_width=width,
                                strips_per_group=per_group)
    aff = sw_long.sw_affine_score_long(a, b, CPU, strip_width=width,
                                       strips_per_group=per_group)
    assert lin == sw_long.sw_score_numpy_blocked(a, b) == \
        jsw_long.sw_score_long(a, b, sb=8, blk=512, interpret=True)
    assert aff == sw_long.sw_affine_numpy_blocked(a, b) == \
        jsw_long.sw_affine_score_long(a, b, sb=8, blk=512, interpret=True)


@pytest.mark.parametrize("W,Wtot", [(16, 80), (32, 112), (48, 48), (64, 16)])
def test_plain_group_is_its_strips_in_turn(rng, W, Wtot):
    """A group of strips, ragged last strip included, carries exactly what
    one strip over all its columns carries: best and last column(s)."""
    M = 70
    a = torch.from_numpy(np.frombuffer(random_dna(rng, M), np.uint8).copy())
    b = torch.from_numpy(np.frombuffer(random_dna(rng, Wtot), np.uint8).copy())
    lh = torch.from_numpy(rng.integers(0, 40, M).astype(np.int32))
    lf = torch.from_numpy(rng.integers(-50, 30, M).astype(np.int32))
    got = sw_long.sw_strip_group(a, b, lh, strip_width=W)
    want = sw_long.sw_strip(a, b, lh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    got = sw_long.sw_affine_strip_group(a, b, lh, lf, -3, -1, strip_width=W)
    want = sw_long.sw_affine_strip(a, b, lh, lf, -3, -1)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_group_size_bounds_the_boundary_buffers():
    for M in (1, 20_000, 200_000, 500_000, 3_000_000):
        for affine in (False, True):
            S = sw_long.group_strips(M, affine)
            assert S >= 1
            assert (S - 1) * 4 * M * (2 if affine else 1) <= \
                sw_long.GROUP_BYTES < 10**9
    # the timed 200 kbp x 150 kbp pair is one group at the default width
    assert sw_long.group_strips(200_000, True) >= -(-150_000 // 512)


def test_group_path_refuses_bad_group_size():
    with pytest.raises(ValueError, match="strips_per_group"):
        sw_long.sw_score_long(b"ACGT", b"ACGT", CPU, strips_per_group=0)


# ----------------------------------------------------------------------
# csrc/sw_moves.cu: the moves layout (plain index math of moves_to_cells)
# ----------------------------------------------------------------------


def _kernel_moves_words(cells: np.ndarray, affine: bool, rng) -> np.ndarray:
    """The words csrc/sw_moves.cu stores for these per-cell codes, step by
    step as its lanes do: lane l of stripe s computes row s * 32R + l * R + r
    at column t - l on step t, shifts the code into the top of its row's
    word, and stores the word every ``codes`` steps (and a last, partial
    word shifted down); cells off the matrix store random codes."""
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    B, M, N = cells.shape
    R, P, codes, W = tbc.moves_layout(M, N, affine)
    bits = 32 // codes
    stripes = -(-M // (32 * R))
    words = np.zeros((B, stripes, W, 32 * P), np.uint64)
    for s in range(stripes):
        for lane in range(32):
            for r in range(R):
                i = s * 32 * R + lane * R + r
                acc = np.zeros(B, np.uint64)
                for t in range(N + 31):
                    j = t - lane
                    code = (cells[:, i, j] if i < M and 0 <= j < N else
                            rng.integers(0, 1 << bits, B)).astype(np.uint64)
                    acc = (acc >> np.uint64(bits)) | (code << np.uint64(32 - bits))
                    if t % codes == codes - 1:
                        words[:, s, t // codes, lane * P + r] = acc
                tail = (N + 31) % codes
                if tail:
                    words[:, s, (N + 31) // codes, lane * P + r] = \
                        acc >> np.uint64(bits * (codes - tail))
    return words.reshape(B, -1).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("B,M,N", [(3, 37, 50), (2, 152, 184), (2, 300, 40),
                                   (2, 1, 9), (1, 64, 1)])
@pytest.mark.parametrize("affine", [False, True])
def test_moves_words_round_trip_to_cells(B, M, N, affine):
    """Plain codes -> the kernel's words (stored as the kernel stores them)
    -> moves_to_cells gives every cell's code back, at one and two
    stripes, a partial last word and one row; the words a pair takes are
    moves_words_per_pair."""
    from mini_parallel_tpu_torch.ops import sw_traceback as tb
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    rng = np.random.default_rng(B * M + N)
    a, _ = encode.pad_batch([random_dna(rng, int(rng.integers(1, M + 1)))
                             for _ in range(B)], pad_to=M,
                            pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch([random_dna(rng, N) for _ in range(B)], pad_to=N,
                            pad_value=int(encode.PAD_B))
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    moves = (tb.sw_affine_moves_batch(ta, tb_, -3, -1) if affine
             else tb.sw_moves_batch(ta, tb_))[3]
    cells = tb.plain_moves_to_cells(moves, N)
    words = _kernel_moves_words(cells.numpy(), affine, rng)
    assert words.shape == (B, tbc.moves_words_per_pair(M, N, affine))
    got = tbc.moves_to_cells(torch.from_numpy(words), M, N, affine)
    assert torch.equal(got, cells)
