"""Batched Smith-Waterman scores on the card: the wrapper of the
hand-written CUDA kernel ``csrc/sw_score.cu`` and the router. The
counterpart of mini_parallel_tpu/ops/sw_pallas.py for its main-path
kernels (``sw_score_batch_pallas`` and ``sw_score_batch_chained``).

- :func:`sw_score_batch_cuda` launches the kernel on CUDA tensors and
  raises on anything the kernel does not take. It counts its launches in
  ``sw_score_batch_cuda.launches``.
- :func:`sw_score_batch_best` routes by the tensors' device: CPU tensors
  go to the plain version (ops/sw.py:sw_score_batch), CUDA tensors to the
  kernel. Nothing falls back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch.ops.sw import sw_score_batch

KERNEL_NAME = "sw_score"
KERNEL_SOURCES = ("sw_score.cu",)
# Longest side the kernel takes. int32 state is exact far beyond it
# (|H| <= 2 * min(M, N)); the bound keeps scratch and run time sane.
MAX_LEN = 1 << 16


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    lib.sw_score_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sw_score_launch.restype = ctypes.c_int
    lib.sw_score_scratch_per_pair.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sw_score_scratch_per_pair.restype = ctypes.c_int
    return lib


def _check_operands(seq_a: torch.Tensor, seq_b: torch.Tensor) -> None:
    for name, t in (("seq_a", seq_a), ("seq_b", seq_b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(
                f"{name} must be a 2-D uint8 tensor, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[1] > MAX_LEN:
            raise ValueError(
                f"{name} rows of {t.shape[1]} exceed the kernel's limit of "
                f"{MAX_LEN}")
    if seq_a.device != seq_b.device:
        raise ValueError(f"operands on {seq_a.device} and {seq_b.device}")
    if seq_a.shape[0] != seq_b.shape[0]:
        raise ValueError(
            f"batch sizes differ: {seq_a.shape[0]} vs {seq_b.shape[0]}")


def sw_score_batch_cuda(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    """(B, M) uint8 PAD_A-padded x (B, N) uint8 PAD_B-padded CUDA tensors ->
    (B,) int32 scores, by the CUDA kernel, on the current stream."""
    _check_operands(seq_a, seq_b)
    B, M = seq_a.shape
    N = seq_b.shape[1]
    dev = seq_a.device
    if B == 0 or M == 0 or N == 0:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    per_pair = lib.sw_score_scratch_per_pair(M, N)
    scratch = (torch.empty((B, per_pair), dtype=torch.int32, device=dev)
               if per_pair else None)
    with torch.cuda.device(dev):
        rc = lib.sw_score_launch(
            seq_a.data_ptr(), seq_b.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, M, N, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_score kernel launch failed: CUDA error {rc}")
    sw_score_batch_cuda.launches += 1
    return out


sw_score_batch_cuda.launches = 0


def sw_score_batch_best(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    """SW scores on the operands' device: the plain version for CPU
    tensors, the CUDA kernel (or an error) for anything else."""
    if seq_a.device.type == "cpu" and seq_b.device.type == "cpu":
        return sw_score_batch(seq_a, seq_b)
    return sw_score_batch_cuda(seq_a, seq_b)
