"""Batched Smith-Waterman scores on the card: the wrappers of the
hand-written CUDA kernels ``csrc/sw_score.cu`` (linear gaps),
``csrc/sw_affine_score.cu`` (affine gaps) and ``csrc/sw_vs_ref.cu``
(reads against one shared reference), and their routers. The counterpart
of mini_parallel_tpu/ops/sw_pallas.py for its batched score kernels
(``sw_score_batch_pallas``/``sw_score_batch_chained``,
``sw_affine_batch_pallas``/``sw_affine_batch_chained`` and
``sw_vs_ref_batch_pallas``).

- :func:`sw_score_batch_cuda`, :func:`sw_affine_batch_cuda` and
  :func:`sw_vs_ref_batch_cuda` launch their kernel on CUDA tensors and
  raise on anything the kernel does not take. Each counts its launches in
  its ``launches`` attribute.
- :func:`sw_score_batch_best`, :func:`sw_affine_batch_best` and
  :func:`sw_vs_ref_batch_best` route by the tensors' device: CPU tensors
  go to the plain version (ops/sw.py), CUDA tensors to the kernel.
  Nothing falls back from a kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch.ops.encode import PAD_A
from mini_parallel_tpu_torch.ops.sw import (
    GAP_EXTEND,
    GAP_OPEN,
    sw_affine_batch,
    sw_score_batch,
    sw_vs_ref_batch,
)

KERNEL_NAME = "sw_score"
KERNEL_SOURCES = ("sw_score.cu",)
AFFINE_KERNEL_NAME = "sw_affine_score"
AFFINE_KERNEL_SOURCES = ("sw_affine_score.cu",)
VS_REF_KERNEL_NAME = "sw_vs_ref"
VS_REF_KERNEL_SOURCES = ("sw_vs_ref.cu",)
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


@functools.lru_cache(maxsize=None)
def _affine_kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(AFFINE_KERNEL_NAME, AFFINE_KERNEL_SOURCES)
    lib.sw_affine_score_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sw_affine_score_launch.restype = ctypes.c_int
    lib.sw_affine_score_scratch_per_pair.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sw_affine_score_scratch_per_pair.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _vs_ref_kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(VS_REF_KERNEL_NAME, VS_REF_KERNEL_SOURCES)
    lib.sw_vs_ref_launch.argtypes = [
        *(ctypes.c_void_p,) * 8, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sw_vs_ref_launch.restype = ctypes.c_int
    lib.sw_vs_ref_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int]
    lib.sw_vs_ref_scratch.restype = ctypes.c_longlong
    lib.sw_vs_ref_default_segment.argtypes = [ctypes.c_int]
    lib.sw_vs_ref_default_segment.restype = ctypes.c_int
    return lib


def check_operands(seq_a: torch.Tensor, seq_b: torch.Tensor) -> None:
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
    check_operands(seq_a, seq_b)
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


def sw_affine_batch_cuda(seq_a: torch.Tensor, seq_b: torch.Tensor,
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND) -> torch.Tensor:
    """(B, M) uint8 PAD_A-padded x (B, N) uint8 PAD_B-padded CUDA tensors ->
    (B,) int32 affine-gap scores, by the CUDA kernel, on the current
    stream. Gap costs are runtime arguments and must be <= 0."""
    check_operands(seq_a, seq_b)
    if gap_open > 0 or gap_extend > 0:
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    B, M = seq_a.shape
    N = seq_b.shape[1]
    dev = seq_a.device
    if B == 0 or M == 0 or N == 0:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    lib = _affine_kernel_lib()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    per_pair = lib.sw_affine_score_scratch_per_pair(M, N)
    scratch = (torch.empty((B, per_pair), dtype=torch.int32, device=dev)
               if per_pair else None)
    with torch.cuda.device(dev):
        rc = lib.sw_affine_score_launch(
            seq_a.data_ptr(), seq_b.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, M, N, int(gap_open), int(gap_extend),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"sw_affine_score kernel launch failed: CUDA error {rc}")
    sw_affine_batch_cuda.launches += 1
    return out


sw_affine_batch_cuda.launches = 0


def sw_affine_batch_best(seq_a: torch.Tensor, seq_b: torch.Tensor,
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND) -> torch.Tensor:
    """Affine-gap SW scores on the operands' device: the plain version for
    CPU tensors, the CUDA kernel (or an error) for anything else."""
    if seq_a.device.type == "cpu" and seq_b.device.type == "cpu":
        return sw_affine_batch(seq_a, seq_b, gap_open, gap_extend)
    return sw_affine_batch_cuda(seq_a, seq_b, gap_open, gap_extend)


def sw_vs_ref_batch_cuda(reads: torch.Tensor, ref: torch.Tensor,
                         segment: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, M) uint8 PAD_A-padded reads x one (N,) uint8 reference, CUDA
    tensors -> (scores (B,) int32, ends (B,) int32), by the CUDA kernel,
    on the current stream: each read's best SW score against the
    reference and the smallest reference index of a cell at that score
    (-1 when the score is 0). Reads that are all pad are not swept: they
    are sorted behind the others on the card and the kernel reads their
    count there, so the launch needs no host sync.

    The kernel splits the reference into segments of ``segment`` columns
    (0: its default, at least 20 warm-ups of 2M columns wide), each swept
    by one warp from 2M columns early; :func:`ops.sw.sweep_segments` is
    its plain mirror. Rows past one stripe (M > 256) need a scratch row of
    min(segment + 2M, N) values per warp of the kernel's persistent grid;
    the library sizes that grid from the card, B and a 256 MB cap, so the
    count of swept reads is never read back to the host."""
    for name, t, dim in (("reads", reads, 2), ("ref", ref, 1)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.uint8 or t.dim() != dim:
            raise ValueError(f"{name} must be a {dim}-D uint8 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if reads.device != ref.device:
        raise ValueError(f"operands on {reads.device} and {ref.device}")
    B, M = reads.shape
    N = ref.shape[0]
    if N >= 1 << 31:
        raise ValueError(f"reference of {N} bases exceeds 2^31 - 1")
    if segment < 0:
        raise ValueError(f"segment width {segment} must be >= 0")
    dev = reads.device
    if B == 0 or M == 0 or N == 0:
        return (torch.zeros(B, dtype=torch.int32, device=dev),
                torch.full((B,), -1, dtype=torch.int32, device=dev))
    lib = _vs_ref_kernel_lib()
    pad_only = (reads == int(PAD_A)).all(dim=1)
    rows = torch.argsort(pad_only.to(torch.uint8), stable=True).to(torch.int32)
    n_rows = (~pad_only).sum(dtype=torch.int32).reshape(1)
    keys = torch.zeros(B, dtype=torch.int64, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    ends = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        n_scratch = lib.sw_vs_ref_scratch(B, M, N, segment)
        if n_scratch < 0:
            raise RuntimeError("sw_vs_ref: cannot size the kernel's grid")
        scratch = (torch.empty(n_scratch, dtype=torch.int32, device=dev)
                   if n_scratch else None)
        rc = lib.sw_vs_ref_launch(
            reads.data_ptr(), ref.data_ptr(), rows.data_ptr(),
            n_rows.data_ptr(), keys.data_ptr(), scores.data_ptr(),
            ends.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, M, N, segment, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_vs_ref kernel launch failed: CUDA error {rc}")
    sw_vs_ref_batch_cuda.launches += 1
    return scores, ends


sw_vs_ref_batch_cuda.launches = 0


def sw_vs_ref_batch_best(reads: torch.Tensor, ref: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reads-vs-reference SW on the operands' device: the plain version
    for CPU tensors, the CUDA kernel (or an error) for anything else."""
    if reads.device.type == "cpu" and ref.device.type == "cpu":
        return sw_vs_ref_batch(reads, ref)
    return sw_vs_ref_batch_cuda(reads, ref)
