"""The port's traceback and reads-vs-reference functions on the CPU against
the JAX package on the same seeded inputs, with exact equality:

- ``sw_vs_ref_batch`` (the plain version of csrc/sw_vs_ref.cu) against the
  JAX Pallas kernel ``sw_vs_ref_batch_pallas`` in interpret mode;
- the plain moves scans (the plain versions of csrc/sw_moves.cu) against
  the JAX scans on best, bd, bi and every move, and against the JAX Pallas
  moves kernels in interpret mode, whose packed moves are unpacked;
- the plain walks against the JAX walks, and against ``positions_to_cigar``
  of the host goldens, which are held against the JAX goldens.

The inputs plant the three tie-breaks the kernels must keep: repeats in
the reference and in the windows (equal-score ends and alignments), reads
of all N and all pad, M that is not a multiple of 8 or 32, and M > 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu.ops import sw_traceback as jtb
from mini_parallel_tpu.ops.sw_pallas import sw_vs_ref_batch_pallas
from mini_parallel_tpu_torch.models import variant_prep as vp
from mini_parallel_tpu_torch.ops import encode, sw
from mini_parallel_tpu_torch.ops import sw_traceback as tb
from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

_ACGT = np.frombuffer(b"ACGT", np.uint8)
GAPS = [(-2, -1), (-3, 0)]


def _mutate(rng, seq: bytes, n_sub: int, n_indel: int) -> bytes:
    """seq with substitutions and 1-4 base insertions/deletions."""
    s = bytearray(seq)
    for _ in range(n_sub):
        if s:
            p = int(rng.integers(0, len(s)))
            s[p] = int(rng.choice([c for c in _ACGT if c != s[p]]))
    for _ in range(n_indel):
        if len(s) > 8:
            p = int(rng.integers(2, len(s) - 2))
            k = int(rng.integers(1, 5))
            if rng.random() < 0.5:
                del s[p:p + k]
            else:
                s[p:p] = rng.choice(_ACGT, k).tobytes()
    return bytes(s)


def _pairs(rng, B: int, M: int, N: int):
    """(B, M) PAD_A x (B, N) PAD_B uint8 pairs: reads cut from their window
    with substitutions and indels, windows holding the read twice (equal
    alignments), unrelated pairs, a read of all N, an empty read, a read of
    a short repeat unit."""
    rows_a, rows_b = [], []
    for k in range(B):
        win = rng.choice(_ACGT, N).tobytes()
        kind = k % 6
        la = int(rng.integers(max(1, M - 12), M + 1))
        if kind == 0:
            s = int(rng.integers(0, max(1, N - la)))
            read = _mutate(rng, win[s:s + la], 2, 2)[:M]
        elif kind == 1 and 2 * la + 2 <= N:  # the read twice: a tie
            read = win[3:3 + la]
            win = win[:3] + read + read + win[3 + 2 * la:]
            win = win[:N]
        elif kind == 2:
            read = b"N" * la
        elif kind == 3:
            read = b""
        elif kind == 4:
            unit = rng.choice(_ACGT, 3).tobytes()
            read = (unit * M)[:la]
            win = (unit * N)[:N // 2] + win[N // 2:]
        else:
            read = rng.choice(_ACGT, la).tobytes()
        rows_a.append(read)
        rows_b.append(win[:int(rng.integers(max(1, N - 8), N + 1))])
    a, _ = encode.pad_batch(rows_a, pad_to=M, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(rows_b, pad_to=N, pad_value=int(encode.PAD_B))
    return a, b, rows_a, rows_b


def _np(x):
    return np.asarray(x)


# ----------------------------------------------------------------------
# reads vs one shared reference (the --rescue mapper)
# ----------------------------------------------------------------------


def _vs_ref_case(rng, B: int, M: int, N: int):
    """A reference with a repeated segment and an N run; reads cut from it
    (some twice-placeable), all-pad rows, all-N rows, unrelated reads."""
    ref = rng.choice(_ACGT, N)
    seg = min(40, N // 5)
    ref[N // 2:N // 2 + seg] = ref[10:10 + seg]  # a repeat: equal ends
    ref[N // 3:N // 3 + 12] = ord("N")
    rows = []
    for k in range(B):
        la = int(rng.integers(1, M + 1))
        if k % 5 == 0:
            rows.append(b"")  # all pad: score 0, end -1
        elif k % 5 == 1:
            rows.append(ref[10:10 + min(la, seg)].tobytes())  # in the repeat
        elif k % 5 == 2:
            s = int(rng.integers(0, N - la))
            rows.append(_mutate(rng, ref[s:s + la].tobytes(), 2, 1)[:M])
        elif k % 5 == 3:
            rows.append(b"N" * la)
        else:
            rows.append(rng.choice(_ACGT, la).tobytes())
    reads, _ = encode.pad_batch(rows, pad_to=M, pad_value=int(encode.PAD_A))
    return reads, ref


@pytest.mark.parametrize("B,M,N", [(16, 40, 400), (11, 37, 133), (5, 13, 64)])
def test_sw_vs_ref_plain_matches_pallas(B, M, N):
    rng = np.random.default_rng(B * 1000 + M + N)
    reads, ref = _vs_ref_case(rng, B, M, N)
    got = sw.sw_vs_ref_batch(torch.from_numpy(reads), torch.from_numpy(ref))
    want = sw_vs_ref_batch_pallas(jnp.asarray(reads), jnp.asarray(ref),
                                  interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))
    scores, ends = (t.numpy() for t in got)
    assert scores[0] == 0 and ends[0] == -1  # the all-pad row
    assert (ends[scores == 0] == -1).all() and (ends[scores > 0] >= 0).all()
    # the read inside the repeat ends at its FIRST copy
    assert ends[1] == 10 + min(int((reads[1] != encode.PAD_A).sum()), 40) - 1


def test_sw_vs_ref_plain_blocks_do_not_show(monkeypatch):
    """Sweeping the reads in blocks of 1-2 rows gives the one-block
    result, and the per-read scores equal the host golden."""
    rng = np.random.default_rng(3)
    reads, ref = _vs_ref_case(rng, 12, 24, 200)
    tr, tref = torch.from_numpy(reads), torch.from_numpy(ref)
    whole = sw.sw_vs_ref_batch(tr, tref)
    monkeypatch.setattr(sw, "VS_REF_BLOCK_CELLS", 399)
    blocked = sw.sw_vs_ref_batch(tr, tref)
    assert all(torch.equal(x, y) for x, y in zip(whole, blocked))
    golden = [sw.sw_score_numpy(bytes(r[r != encode.PAD_A]), ref.tobytes())
              for r in reads]
    assert whole[0].tolist() == golden


# ----------------------------------------------------------------------
# moves scans
# ----------------------------------------------------------------------

SHAPES = [(12, 37, 45), (7, 13, 64), (3, 300, 40)]


@pytest.mark.parametrize("B,M,N", SHAPES)
@pytest.mark.parametrize("gaps", [None] + GAPS)
def test_moves_plain_match_jax_scan(B, M, N, gaps):
    """best, bd, bi and every move of the (Dp, B, M) tensor, linear
    (gaps None) and affine at two gap settings."""
    rng = np.random.default_rng(M * 100 + N)
    a, b, _, _ = _pairs(rng, B, M, N)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if gaps is None:
        got = tb.sw_moves_batch(ta, tb_)
        want = jtb.sw_moves_batch(ja, jb)
    else:
        got = tb.sw_affine_moves_batch(ta, tb_, *gaps)
        want = jtb.sw_affine_moves_batch(ja, jb, *gaps)
    assert got[3].shape == want[3].shape and got[3].dtype == torch.uint8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert int(got[0].max()) > 20


def _unpack_pallas(packed, bits: int, M: int, N: int, B: int) -> np.ndarray:
    """The Pallas kernels' packed moves -> (B, M, N): cell (i, j) lies on
    diagonal i + j, in word (i + j) // per of row i, at bits * ((i + j) %
    per)."""
    per = 32 // bits
    d = np.arange(M)[:, None] + np.arange(N)[None, :]
    words = np.asarray(packed).astype(np.uint32)[d // per,
                                                 np.arange(M)[:, None], :B]
    cells = (words >> (bits * (d % per))[:, :, None].astype(np.uint32)) \
        & ((1 << bits) - 1)
    return cells.transpose(2, 0, 1).astype(np.uint8)


@pytest.mark.parametrize("gaps", [None] + GAPS)
def test_moves_plain_match_pallas_interpret(gaps):
    """The JAX Pallas moves kernels (interpret mode, M and N padded to 8)
    on best, bd, bi and the move of every cell of the unpadded matrix."""
    rng = np.random.default_rng(41)
    B, M, N = 9, 21, 37
    a, b, _, _ = _pairs(rng, B, M, N)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if gaps is None:
        got = tb.sw_moves_batch(ta, tb_)
        want = jtb.sw_moves_batch_pallas(ja, jb, interpret=True)
        bits = 2
    else:
        got = tb.sw_affine_moves_batch(ta, tb_, *gaps)
        want = jtb.sw_affine_moves_batch_pallas(
            ja, jb, gap_open=gaps[0], gap_extend=gaps[1], interpret=True)
        bits = 4
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_array_equal(
        tb.plain_moves_to_cells(got[3], N).numpy(),
        _unpack_pallas(want[3], bits, M, N, B))


def test_plain_moves_to_cells_layout():
    """plain_moves_to_cells puts cell (i, j) = moves[i + j, p, i]."""
    rng = np.random.default_rng(8)
    moves = torch.from_numpy(rng.integers(0, 16, (12, 2, 5)).astype(np.uint8))
    cells = tb.plain_moves_to_cells(moves, 6)
    for p, i, j in ((0, 0, 0), (1, 4, 5), (0, 2, 3), (1, 3, 1)):
        assert cells[p, i, j] == moves[i + j, p, i]


# ----------------------------------------------------------------------
# walks and goldens
# ----------------------------------------------------------------------


@pytest.mark.parametrize("B,M,N", SHAPES)
@pytest.mark.parametrize("gaps", [None] + GAPS)
def test_positions_match_jax(B, M, N, gaps):
    rng = np.random.default_rng(M * 7 + N)
    a, b, _, _ = _pairs(rng, B, M, N)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if gaps is None:
        got = tb.sw_positions_batch(ta, tb_)
        want = jtb.sw_positions_batch(ja, jb)
        routed = tb.sw_positions_batch_best(ta, tb_)
    else:
        got = tb.sw_affine_positions_batch(ta, tb_, *gaps)
        want = jtb.sw_affine_positions_batch(ja, jb, *gaps)
        routed = tb.sw_affine_positions_batch_best(ta, tb_, *gaps)
    for g, w, r in zip(got, want, routed):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))
        assert torch.equal(g, r)  # a CPU tensor routes to the plain version


def _golden_cigar(aln, length: int) -> tuple[str, int]:
    """The golden alignment as positions_to_cigar writes it: soft clips
    around the aligned span."""
    if aln.score <= 0:
        return "", -1
    clip_l = f"{aln.query_start}S" if aln.query_start else ""
    clip_r = f"{length - aln.query_end}S" if aln.query_end < length else ""
    return clip_l + aln.cigar + clip_r, aln.ref_start


@pytest.mark.parametrize("gaps", [None] + GAPS)
def test_positions_give_the_golden_cigars(gaps):
    """positions_to_cigar of the plain walk == the host golden's CIGAR and
    start for every pair; the port's goldens == the JAX package's."""
    rng = np.random.default_rng(97)
    B, M, N = 24, 45, 70
    a, b, rows_a, rows_b = _pairs(rng, B, M, N)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    if gaps is None:
        score, pos = tb.sw_positions_batch(ta, tb_)
        goldens = [tb.sw_align_numpy(x, y) for x, y in zip(rows_a, rows_b)]
        jgold = [jtb.sw_align_numpy(x, y) for x, y in zip(rows_a, rows_b)]
    else:
        score, pos = tb.sw_affine_positions_batch(ta, tb_, *gaps)
        goldens = [tb.sw_affine_align_numpy(x, y, *gaps)
                   for x, y in zip(rows_a, rows_b)]
        jgold = [jtb.sw_affine_align_numpy(x, y, *gaps)
                 for x, y in zip(rows_a, rows_b)]
    assert [vars(g) for g in goldens] == [vars(g) for g in jgold]
    n_gapped = 0
    for k, (aln, read) in enumerate(zip(goldens, rows_a)):
        assert int(score[k]) == aln.score
        got = vp.positions_to_cigar(pos[k].numpy(), len(read))
        assert got == _golden_cigar(aln, len(read)), k
        n_gapped += any(op in "ID" for _, op in aln.cigar_ops())
    assert n_gapped >= 2


def test_golden_tie_breaks():
    """Equal-score alignments: the argmax takes the first diagonal, then
    the smallest row; linear moves prefer diag > up > left."""
    aln = tb.sw_align_numpy(b"ACGT", b"ACGTTTACGT")
    assert (aln.score, aln.ref_start, aln.ref_end, aln.cigar) == (8, 0, 4, "4M")
    aln = tb.sw_affine_align_numpy(b"ACGT", b"GGACGTACGT", -3, -1)
    assert (aln.score, aln.ref_start, aln.cigar) == (8, 2, "4M")
    assert tb.sw_align_numpy(b"NNNN", b"ACGT").score == 0
    assert tb._rle("MMMIDDM") == "3M1I2D1M" and tb._rle("") == ""
    assert tb.Alignment(1, 0, 3, 0, 4, "2M1D1M").cigar_ops() == \
        [(2, "M"), (1, "D"), (1, "M")]


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("B,M,N", [(0, 8, 8), (2, 0, 5), (2, 5, 0)])
def test_moves_wrapper_counts_only_launches(monkeypatch, affine, B, M, N):
    """An empty batch returns (0, 0, 0, all -1) without building or
    launching the kernel, and leaves both launch counts where they were."""
    monkeypatch.setattr(tbc, "check_operands", lambda a, b: None)

    def no_build():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(tbc, "_kernel_lib", no_build)
    wrappers = (tbc.sw_moves_batch_cuda, tbc.sw_affine_moves_batch_cuda)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    a = torch.zeros((B, M), dtype=torch.uint8)
    b = torch.zeros((B, N), dtype=torch.uint8)
    best, bd, bi, pos, moves = wrappers[affine](a, b, return_moves=True)
    assert [fn.launches for fn in wrappers] == [0, 0]
    assert all(t.shape == (B,) and not t.any() for t in (best, bd, bi))
    assert pos.shape == (B, M) and (pos == -1).all() and moves.numel() == 0
