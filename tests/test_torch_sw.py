"""The port's Smith-Waterman scores: the plain PyTorch version vs the JAX
package's Pallas kernels (interpret mode, as tests/test_sw_pallas.py runs
them) and the NumPy golden; the device router; and the kernel loader.
Exact integer equality throughout. The kernel itself is tested on the
card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_parallel_tpu.ops import sw as jsw
from mini_parallel_tpu.ops.sw_pallas import (
    sw_score_batch_chained,
    sw_score_batch_pallas,
)
from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch.ops import encode, sw, sw_cuda
from tests.conftest import random_dna


def _batch(rng, B, max_a, max_b, pad_a, pad_b, alphabet=b"ACGT"):
    ra = [random_dna(rng, int(rng.integers(0, max_a + 1)), alphabet)
          for _ in range(B)]
    rb = [random_dna(rng, int(rng.integers(0, max_b + 1)), alphabet)
          for _ in range(B)]
    a, _ = encode.pad_batch(ra, pad_to=pad_a, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(rb, pad_to=pad_b, pad_value=int(encode.PAD_B))
    return ra, rb, a, b


def _plain(a, b):
    return sw.sw_score_batch(torch.from_numpy(a), torch.from_numpy(b))


def test_plain_matches_pallas_interpret(rng):
    _, _, a, b = _batch(rng, 32, 150, 150, 160, 160)
    want = sw_score_batch_pallas(jnp.asarray(a), jnp.asarray(b),
                                 interpret=True)
    got = _plain(a, b)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_matches_chained_k2(rng):
    _, _, a, b = _batch(rng, 48, 150, 150, 152, 152, alphabet=b"ACGTN")
    want = sw_score_batch_chained(jnp.asarray(a), jnp.asarray(b), k_chain=2,
                                  interpret=True)
    assert np.array_equal(_plain(a, b).numpy(), np.asarray(want))


@pytest.mark.parametrize("B,max_a,max_b,pad_a,pad_b", [
    (11, 40, 64, 40, 64),    # ragged, M != N
    (3, 80, 60, 96, 64),     # B not a multiple of any block
    (5, 70, 20, 72, 24),     # M >> N
    (1, 9, 160, 12, 160),    # B = 1, N >> M
])
def test_plain_matches_golden_geometries(rng, B, max_a, max_b, pad_a, pad_b):
    ra, rb, a, b = _batch(rng, B, max_a, max_b, pad_a, pad_b,
                          alphabet=b"ACGTN")
    got = _plain(a, b).tolist()
    assert got == [sw.sw_score_numpy(x, y) for x, y in zip(ra, rb)]
    assert got == [jsw.sw_score_numpy(x, y) for x, y in zip(ra, rb)]
    assert np.array_equal(np.asarray(jsw.sw_score_batch(jnp.asarray(a),
                                                        jnp.asarray(b))), got)


def test_plain_empty_and_identical():
    a, _ = encode.pad_batch([b"", b"AAAA", b"ACGT" * 20, b""], pad_to=96,
                            pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch([b"ACGT", b"TTTT", b"ACGT" * 20, b""], pad_to=96,
                            pad_value=int(encode.PAD_B))
    assert _plain(a, b).tolist() == [0, 0, 160, 0]
    empty = torch.zeros((0, 8), dtype=torch.uint8)
    assert sw.sw_score_batch(empty, empty).shape == (0,)


def test_router_sends_cpu_tensors_to_plain(rng, monkeypatch):
    _, _, a, b = _batch(rng, 6, 30, 30, 32, 32)
    monkeypatch.setattr(sw_cuda.sw_score_batch_cuda, "launches", 0)
    got = sw_cuda.sw_score_batch_best(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got, _plain(a, b))
    assert sw_cuda.sw_score_batch_cuda.launches == 0
    assert sw.sw_score_pair("ACGTT", "ACGAT", torch.device("cpu")) == \
        jsw.sw_score_numpy("ACGTT", "ACGAT")


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.full((2, 8), int(encode.PAD_A), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_score_batch_cuda(a, a)  # no silent CPU fallback


def test_loader_raises_without_nvcc(tmp_path, monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.build(sw_cuda.KERNEL_NAME, sw_cuda.KERNEL_SOURCES)
    assert list(tmp_path.iterdir()) == []


def test_build_key_follows_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    p1 = _build.library_path("k", ("k.cu",))
    src.write_text("// v2\n")
    p2 = _build.library_path("k", ("k.cu",))
    assert p1 != p2 and p1.name.startswith("k-") and p1.suffix == ".so"
