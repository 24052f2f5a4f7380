"""The port's affine-gap SW, contiguous Kadane and reverse-complement ops
against the JAX package on the same seeded inputs: the plain PyTorch
``sw_affine_batch`` vs the JAX Pallas kernel in interpret mode (as
tests/test_sw_affine.py runs it), the JAX scan and the NumPy golden; the
affine router; ``kadane_contiguous_batch`` and its monoid; the encode ops.
Exact integer equality throughout. The CUDA kernel itself is tested on the
card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu.ops import encode as jencode
from mini_parallel_tpu.ops import kadane as jkadane
from mini_parallel_tpu.ops import sw as jsw
from mini_parallel_tpu.ops.sw_pallas import sw_affine_batch_pallas
from mini_parallel_tpu_torch.ops import encode, kadane, sw, sw_cuda
from tests.conftest import random_dna


def _batch(rng, B, max_a, max_b, pad_a, pad_b, alphabet=b"ACGT"):
    ra = [random_dna(rng, int(rng.integers(0, max_a + 1)), alphabet)
          for _ in range(B)]
    rb = [random_dna(rng, int(rng.integers(0, max_b + 1)), alphabet)
          for _ in range(B)]
    a, _ = encode.pad_batch(ra, pad_to=pad_a, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(rb, pad_to=pad_b, pad_value=int(encode.PAD_B))
    return ra, rb, a, b


def _plain(a, b, *gaps):
    return sw.sw_affine_batch(torch.from_numpy(a), torch.from_numpy(b), *gaps)


def test_plain_matches_pallas_interpret_and_golden(rng):
    ra, rb, a, b = _batch(rng, 24, 60, 60, 64, 64)
    want = np.asarray(sw_affine_batch_pallas(jnp.asarray(a), jnp.asarray(b),
                                             interpret=True))
    got = _plain(a, b)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()
    assert got.tolist() == [jsw.sw_affine_numpy(x, y) for x, y in zip(ra, rb)]
    assert got.tolist() == [sw.sw_affine_numpy(x, y) for x, y in zip(ra, rb)]


def test_golden_hand_cases():
    assert sw.sw_affine_numpy("ACGT", "ACGT") == 8
    # one 3-base gap: affine (open -2, extend -1) costs -5; linear -6
    assert sw.sw_affine_numpy("AAAATTTCCCC", "AAAACCCC") == 16 - 5
    assert (sw.GAP_OPEN, sw.GAP_EXTEND) == (jsw.GAP_OPEN, jsw.GAP_EXTEND)


def test_linear_equivalence(rng):
    """gap_open = 0, gap_extend = -2 is the linear-gap DP exactly."""
    _, _, a, b = _batch(rng, 16, 60, 60, 64, 64, alphabet=b"ACGTN")
    lin = sw.sw_score_batch(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(_plain(a, b, 0, -2), lin)


@pytest.mark.parametrize("gap_open,gap_extend", [(-5, -1), (-3, -2),
                                                 (-1, -1), (0, 0)])
def test_custom_gap_params(rng, gap_open, gap_extend):
    ra, rb, a, b = _batch(rng, 8, 50, 50, 56, 56)
    got = _plain(a, b, gap_open, gap_extend).tolist()
    assert got == [jsw.sw_affine_numpy(x, y, gap_open=gap_open,
                                       gap_extend=gap_extend)
                   for x, y in zip(ra, rb)]
    want = sw_affine_batch_pallas(jnp.asarray(a), jnp.asarray(b),
                                  gap_open=gap_open, gap_extend=gap_extend,
                                  interpret=True)
    assert got == np.asarray(want).tolist()


@pytest.mark.parametrize("B,max_a,max_b,pad_a,pad_b", [
    (11, 40, 64, 40, 64),    # ragged, M != N
    (3, 80, 60, 96, 64),     # B not a multiple of any block
    (5, 70, 20, 72, 24),     # M >> N
    (1, 9, 160, 12, 160),    # B = 1, N >> M
])
def test_geometries_with_n_bases(rng, B, max_a, max_b, pad_a, pad_b):
    ra, rb, a, b = _batch(rng, B, max_a, max_b, pad_a, pad_b,
                          alphabet=b"ACGTN")
    got = _plain(a, b).tolist()
    assert got == [jsw.sw_affine_numpy(x, y) for x, y in zip(ra, rb)]
    assert got == np.asarray(jsw.sw_affine_batch(jnp.asarray(a),
                                                 jnp.asarray(b))).tolist()


def test_empty_rows_and_identical():
    a, _ = encode.pad_batch([b"", b"AAAA", b"ACGT" * 20, b"", b"NNNN"],
                            pad_to=96, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch([b"ACGT", b"TTTT", b"ACGT" * 20, b"", b"NNNN"],
                            pad_to=96, pad_value=int(encode.PAD_B))
    assert _plain(a, b).tolist() == [0, 0, 160, 0, 8]
    empty = torch.zeros((0, 8), dtype=torch.uint8)
    assert sw.sw_affine_batch(empty, empty).shape == (0,)


def test_router_sends_cpu_tensors_to_plain(rng, monkeypatch):
    _, _, a, b = _batch(rng, 6, 30, 30, 32, 32)
    monkeypatch.setattr(sw_cuda.sw_affine_batch_cuda, "launches", 0)
    got = sw_cuda.sw_affine_batch_best(torch.from_numpy(a),
                                       torch.from_numpy(b), -5, -1)
    assert torch.equal(got, _plain(a, b, -5, -1))
    assert sw_cuda.sw_affine_batch_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_affine_batch_cuda(torch.from_numpy(a), torch.from_numpy(b))


def _kadane_inputs(rng, B, L, same_pad):
    ra = [random_dna(rng, int(rng.integers(0, L + 1)), b"ACGTN")
          for _ in range(B)]
    rb = [random_dna(rng, int(rng.integers(0, L + 1)), b"ACGTN")
          for _ in range(B)]
    a, la = encode.pad_batch(ra, pad_to=L, pad_value=int(encode.PAD_A))
    pad_b = encode.PAD_A if same_pad else encode.PAD_B
    b, lb = encode.pad_batch(rb, pad_to=L, pad_value=int(pad_b))
    return a, b, la, lb


@pytest.mark.parametrize("B,L,same_pad", [(17, 64, False), (9, 300, True),
                                          (4, 1, False)])
def test_kadane_contiguous_matches_jax(rng, B, L, same_pad):
    a, b, la, lb = _kadane_inputs(rng, B, L, same_pad)
    # self-alignment rows (a == b) score the whole valid run
    a[0], la[0] = b[0], lb[0]
    got = kadane.kadane_contiguous_batch(*map(torch.from_numpy,
                                              (a, b, la, lb)))
    want = jkadane.kadane_contiguous_batch(*map(jnp.asarray, (a, b, la, lb)))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()


def test_kadane_summary_and_combine_match_jax(rng):
    s = np.where(rng.random((6, 41)) < 0.45, 2, -1).astype(np.int32)
    valid = rng.random((6, 41)) < 0.9
    got = kadane.kadane_summary(torch.from_numpy(s), torch.from_numpy(valid))
    want = jkadane.kadane_summary(jnp.asarray(s), jnp.asarray(valid))
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()
    # the monoid: any split of a segment combines to the whole's summary
    for cut in (0, 1, 20, 41):
        left = kadane.kadane_summary(torch.from_numpy(s[:, :cut]),
                                     torch.from_numpy(valid[:, :cut]))
        right = kadane.kadane_summary(torch.from_numpy(s[:, cut:]),
                                      torch.from_numpy(valid[:, cut:]))
        merged = kadane.kadane_combine(left, right)
        assert all(torch.equal(m, g) for m, g in zip(merged, got)), cut


def test_encode_ops_match_jax(rng):
    reads = [random_dna(rng, int(rng.integers(0, 40)), b"ACGTNacgtRY")
             for _ in range(12)]
    for pad in (encode.PAD_A, encode.PAD_B):
        arr, lens = encode.pad_batch(reads, pad_to=40, pad_value=int(pad))
        t, tl = torch.from_numpy(arr), torch.from_numpy(lens)
        got = encode.revcomp_padded(t, tl, int(pad))
        want = jencode.revcomp_padded(jnp.asarray(arr), jnp.asarray(lens),
                                      int(pad))
        assert np.array_equal(got.numpy(), np.asarray(want))
        table = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
        assert [bytes(r[:n]) for r, n in zip(got.numpy(), lens)] == \
            [r.translate(table)[::-1] for r in reads]
        for mine, theirs in ((encode.ascii_to_code, jencode.ascii_to_code),
                             (encode.complement_ascii, jencode.complement_ascii),
                             (encode.reverse_complement_ascii,
                              jencode.reverse_complement_ascii)):
            assert np.array_equal(mine(t).numpy(),
                                  np.asarray(theirs(jnp.asarray(arr))))
        codes = encode.ascii_to_code(t)
        assert np.array_equal(
            encode.complement_code(codes).numpy(),
            np.asarray(jencode.complement_code(jnp.asarray(codes.numpy()))))
