"""The port's Pair-HMM (ops/pairhmm.py) and roofline chain on the CPU
against the JAX package: the plain batched forward against the
interpret-mode Pallas kernel (float32) and the float64 oracle, the host API
against JAX's, the genotype model bit for bit, and the router and wrappers'
contracts. Each test states its tolerance."""

import numpy as np
import pytest
import torch

from mini_parallel_tpu.ops import pairhmm as jph
from mini_parallel_tpu.ops.pairhmm_pallas import (
    pairhmm_batch_pallas,
)
from mini_parallel_tpu.ops.pairhmm_pallas import (
    pairhmm_log10_batch as jax_log10_batch,
)
from mini_parallel_tpu_torch.ops import encode, pairhmm, pairhmm_cuda
from mini_parallel_tpu_torch.tools import roofline

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
# float32 forward vs float32 forward: both sum the same cells in the same
# order; XLA may contract a multiply-add where torch rounds twice
F32_TOL = 1e-4
F64_TOL = 1e-9  # float64 forward vs the float64 oracle
FLOOR = pairhmm.FP32_FLOOR_LOG10  # ~ -74.06


def _lanes(rng, n_win: int = 3, step: int = 6):
    """150 bp Q25-Q40 reads slid across 101-base haplotype windows (the
    genotyper's shape: the overhang becomes insertions, so lanes run from
    about -60 down past the float32 floor), plus ragged short lanes with
    substitutions and empty lanes."""
    reads, quals, haps = [], [], []
    for _ in range(n_win):
        src = rng.choice(ACGT, 400)
        hap = src[150:251].tobytes()
        for o in range(0, 150, step):
            reads.append(src[25 + o:175 + o].tobytes())
            quals.append(rng.integers(25, 41, 150).astype(np.float64))
            haps.append(hap)
    for _ in range(12):
        hap = rng.choice(ACGT, int(rng.integers(8, 90))).tobytes()
        m = int(rng.integers(1, 70))
        read = bytearray(rng.choice(ACGT, m).tobytes())
        if m < len(hap):
            s = int(rng.integers(0, len(hap) - m + 1))
            read = bytearray(hap[s:s + m])
        for k in rng.integers(0, m, int(rng.integers(0, 4))):
            read[k] = int(rng.choice(ACGT))
        reads.append(bytes(read))
        quals.append(rng.integers(5, 41, m).astype(np.float64))
        haps.append(hap)
    reads += [b"", b"ACGT"]
    quals += [np.zeros(0), np.full(4, 30.0)]
    haps += [b"ACGTACGT", b""]
    return reads, quals, haps


def _padded(reads, quals, haps):
    arr_r, la = encode.pad_batch(reads, pad_value=int(encode.PAD_A))
    arr_h, lb = encode.pad_batch(haps, pad_value=int(encode.PAD_B))
    err = np.zeros(arr_r.shape, np.float64)
    for i, q in enumerate(quals):
        err[i, :len(q)] = 10.0 ** (-np.asarray(q) / 10.0)
    return arr_r, err, arr_h, la, lb


def _torch(arr_r, err, arr_h, la, lb, dtype):
    return (torch.from_numpy(arr_r), torch.from_numpy(err).to(dtype),
            torch.from_numpy(arr_h), torch.from_numpy(la),
            torch.from_numpy(lb))


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(7)
    reads, quals, haps = _lanes(rng)
    padded = _padded(reads, quals, haps)
    f64 = pairhmm.pairhmm_batch(*_torch(*padded, torch.float64),
                                dtype=torch.float64).numpy()
    return reads, quals, haps, padded, f64


def test_plain_f32_matches_pallas_kernel(lanes):
    """Plain float32 pairhmm_batch vs pairhmm_batch_pallas: |Δlog10| <=
    F32_TOL where both are finite and the lane is >= 4 above the floor; the
    same -inf lanes except within 0.5 of the floor. Nearer the floor the TPU
    kernel flushes denormal cells to zero and drifts (0.14 at 0.6 above it)
    while the port keeps them: there the port is held to the float64 value
    instead (F32_TOL)."""
    import jax.numpy as jnp

    reads, quals, haps, (arr_r, err, arr_h, la, lb), f64 = lanes
    want = np.asarray(pairhmm_batch_pallas(
        jnp.asarray(arr_r), jnp.asarray(err.astype(np.float32)),
        jnp.asarray(arr_h), jnp.asarray(la), jnp.asarray(lb)), np.float64)
    got = pairhmm.pairhmm_batch(*_torch(arr_r, err, arr_h, la, lb,
                                        torch.float32)).numpy()
    assert got.dtype == np.float32
    far = np.abs(f64 - FLOOR) > 0.5
    np.testing.assert_array_equal(np.isinf(got)[far], np.isinf(want)[far])
    both = np.isfinite(got) & np.isfinite(want)
    clear = both & (f64 > FLOOR + 4)
    assert np.abs(got[clear] - want[clear]).max() <= F32_TOL
    assert np.abs(got[both] - f64[both]).max() <= F32_TOL
    # the fixture spans the floor: lanes on both sides and within 4 of it
    assert np.isinf(got[:-2]).sum() >= 5 and clear.sum() >= 20
    assert (both & (f64 < FLOOR + 4)).sum() >= 2
    assert np.isinf(got[-2:]).all() and np.isinf(want[-2:]).all()


def test_plain_f64_matches_oracle(lanes):
    """Plain float64 pairhmm_batch (unscaled) vs pairhmm_forward_numpy,
    |Δlog10| <= F64_TOL, on lanes of every kind (the oracle is a Python
    double loop: every third lane)."""
    reads, quals, haps, _, f64 = lanes
    for i in range(0, len(reads), 3):
        want = jph.pairhmm_forward_numpy(reads[i], quals[i], haps[i])
        if np.isinf(want):
            assert np.isinf(f64[i])
        else:
            assert abs(f64[i] - want) <= F64_TOL, i
    assert f64[:25].min() < FLOOR - 20  # float64 reaches far below float32


def test_log10_batch_matches_jax(rng):
    """pairhmm_log10_batch vs the JAX package's (float32 then the float64
    recompute of underflowed lanes), <= F32_TOL (near the floor, vs the
    float64 oracle): numeric and Phred+33
    qualities, the JAX underflow test's all-mismatch lane, empty lanes, an
    empty batch."""
    r2, q2, h2 = _lanes(rng, n_win=1, step=15)
    hap = bytes(rng.choice(ACGT, 140))
    read = bytes({65: 67, 67: 65, 71: 84, 84: 71}[b] for b in hap[:120])
    reads = r2 + [read, hap[10:60]]
    quals = q2 + [np.full(120, 40.0), bytes([33 + 25] * 50)]
    haps = h2 + [hap, hap]
    got = pairhmm.pairhmm_log10_batch(reads, quals, haps, device=CPU)
    want = jax_log10_batch(reads, quals, haps)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    # within 4 of the float32 floor the TPU kernel's flushed denormals
    # show (see test_plain_f32_matches_pallas_kernel): the oracle there
    near = np.isfinite(got) & (got > FLOOR - 0.5) & (got < FLOOR + 4)
    clear = np.isfinite(got) & ~near
    assert np.abs(got[clear] - want[clear]).max() <= F32_TOL
    for i in np.flatnonzero(near):
        assert abs(got[i] - jph.pairhmm_forward_numpy(
            reads[i], quals[i], haps[i])) <= F32_TOL
    assert got[-2] < -100  # the all-mismatch lane came back in float64
    assert pairhmm.pairhmm_log10_batch([], [], [], device=CPU).size == 0
    assert jax_log10_batch([], [], []).size == 0


def test_log10_padded_recomputes_only_underflowed_lanes(lanes):
    """The float64 recompute covers exactly the float32 lanes at -inf that
    have a read and a haplotype, and gives them the float64 value."""
    _, _, _, (arr_r, err, arr_h, la, lb), f64 = lanes
    args = _torch(arr_r, err, arr_h, la, lb, torch.float64)
    f32 = pairhmm.pairhmm_batch(*_torch(arr_r, err, arr_h, la, lb,
                                        torch.float32)).numpy()
    got, n = pairhmm.pairhmm_log10_padded(*args)
    redo = np.isinf(f32) & (la > 0) & (lb > 0)
    assert n == redo.sum() > 0
    np.testing.assert_array_equal(got.numpy()[redo], f64[redo])
    np.testing.assert_array_equal(got.numpy()[~redo],
                                  f32[~redo].astype(np.float64))


def test_genotype_model_and_constants_copied():
    """genotype_likelihoods equals the JAX package's bit for bit (finite,
    floored and -inf reads); the constants and transitions are the same."""
    rng = np.random.default_rng(3)
    for n in (1, 5, 40):
        ref = -rng.random(n) * 400
        alt = -rng.random(n) * 400
        ref[0], alt[-1] = -np.inf, -np.inf
        assert pairhmm.genotype_likelihoods(ref, alt) == \
            jph.genotype_likelihoods(ref, alt)
    for name in ("DEFAULT_GAP_OPEN_PHRED", "DEFAULT_GAP_EXT_PHRED",
                 "SCALE_LOG2", "LOG10_2", "LL_FLOOR"):
        assert getattr(pairhmm, name) == getattr(jph, name)
    assert pairhmm.transition_probs(40, 8) == jph.transition_probs(40, 8)


def test_oracle_copied_bit_for_bit(lanes):
    """The port's float64 oracle equals the JAX package's exactly (every
    fourth lane, empty lanes included), and so the plain float64 forward
    is within F64_TOL of it."""
    reads, quals, haps, _, f64 = lanes
    for i in [*range(0, len(reads), 4), len(reads) - 2, len(reads) - 1]:
        got = pairhmm.pairhmm_forward_numpy(reads[i], quals[i], haps[i])
        assert got == jph.pairhmm_forward_numpy(reads[i], quals[i], haps[i])
        assert np.isinf(got) == np.isinf(f64[i])
        if np.isfinite(got):
            assert abs(f64[i] - got) <= F64_TOL, i


def test_router_takes_the_plain_version_on_cpu(lanes, monkeypatch):
    """CPU tensors go to the plain version in their error's precision; the
    kernels' counts stay at 0."""
    _, _, _, padded, f64 = lanes
    monkeypatch.setattr(pairhmm_cuda.pairhmm_batch_cuda, "launches", 0)
    monkeypatch.setattr(pairhmm_cuda.pairhmm_f64_batch_cuda, "launches", 0)
    got = pairhmm.pairhmm_batch_best(*_torch(*padded, torch.float64))
    np.testing.assert_array_equal(got.numpy(), f64)
    assert pairhmm.pairhmm_batch_best(
        *_torch(*padded, torch.float32)).dtype == torch.float32
    assert pairhmm_cuda.pairhmm_batch_cuda.launches == 0
    assert pairhmm_cuda.pairhmm_f64_batch_cuda.launches == 0


def test_wrappers_refuse_cpu_tensors(lanes):
    """A wrapper launches on CUDA tensors or raises; it never computes on
    the CPU."""
    _, _, _, padded, _ = lanes
    for fn, dtype in ((pairhmm_cuda.pairhmm_batch_cuda, torch.float32),
                      (pairhmm_cuda.pairhmm_f64_batch_cuda, torch.float64)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*_torch(*padded, dtype))
    a = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        roofline.roofline_chain_cuda(a, a, 8)


def test_roofline_chain_plain_matches_numpy_loop():
    """The plain chain at CHAIN = 8 on a (64, 64) tile equals a numpy loop
    exactly."""
    rng = np.random.default_rng(1)
    a = rng.integers(-3, 3, (64, 64), np.int32)
    b = rng.integers(-100, 100, (64, 64), np.int32)
    y = a.copy()
    for _ in range(8):
        y = np.maximum(y + a, b)
    got = roofline.roofline_chain(torch.from_numpy(a), torch.from_numpy(b), 8)
    np.testing.assert_array_equal(got.numpy(), y)


def test_roofline_refuses_without_a_card():
    """The roofline measures the card: without one it exits 1."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    out = []
    assert roofline.main(echo=out.append) == 1
    assert "the roofline measures the card" in out[-1]
