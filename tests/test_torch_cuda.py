"""The port's CUDA kernel on the card: the kernel vs its plain PyTorch
version (exact integer equality), the wrapper's refusals, and the sw
engine's launches. Every test needs a CUDA card and skips without one.

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed; there, skip the repo's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.ops import encode, sw, sw_cuda
from mini_parallel_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(rng, B, max_len):
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    return [rng.choice(alphabet, size=int(rng.integers(0, max_len + 1))).tobytes()
            for _ in range(B)]


@pytest.mark.parametrize("B,M,N", [(1000, 152, 152), (37, 96, 64),
                                   (3, 600, 120), (1, 2048, 2048),
                                   (5, 1, 7)])
def test_kernel_matches_plain(cuda_device, B, M, N):
    rng = np.random.default_rng(B + M + N)
    a, _ = encode.pad_batch(_rows(rng, B, M), pad_to=M, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(_rows(rng, B, N), pad_to=N, pad_value=int(encode.PAD_B))
    ta, tb = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    launches = sw_cuda.sw_score_batch_cuda.launches
    got = sw_cuda.sw_score_batch_best(ta, tb)
    torch.cuda.synchronize()
    assert sw_cuda.sw_score_batch_cuda.launches == launches + 1
    assert torch.equal(got, sw.sw_score_batch(ta, tb))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    a = torch.zeros((4, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        sw_cuda.sw_score_batch_cuda(a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError, match="uint8"):
        sw_cuda.sw_score_batch_cuda(a.int(), a.int())
    with pytest.raises(ValueError, match="batch sizes"):
        sw_cuda.sw_score_batch_cuda(a, a[:3])
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_score_batch_cuda(a.cpu(), a)
    assert sw_cuda.sw_score_batch_cuda(a[:0], a[:0]).shape == (0,)


@pytest.mark.parametrize("packed", [True, False])
def test_engine_sw_launches_once_per_chunk(tmp_path, cuda_device, packed):
    rng = np.random.default_rng(1)
    reads = _rows(rng, 23, 151)
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=5, packed_transfer=packed)
    launches = sw_cuda.sw_score_batch_cuda.launches
    res = AlignmentEngine(cfg, mode="sw", device=cuda_device).self_align_file(path)
    assert sw_cuda.sw_score_batch_cuda.launches == launches + res.chunks == launches + 5
    assert res.failed_chunks == 0
    assert res.score == 2 * sum(map(len, reads))
    cpu = AlignmentEngine(cfg, mode="sw", device=torch.device("cpu")).self_align_file(path)
    assert (res.score, res.total_bases, res.total_reads) == \
        (cpu.score, cpu.total_bases, cpu.total_reads)
