"""Batched Pair-HMM forward on the card: the wrappers of the hand-written
CUDA kernel in ``csrc/pairhmm.cu``, one template in two precisions. The
counterpart of the JAX package's ``pairhmm_batch_pallas`` (float32, scaled
by 2^120) and of its host recompute of underflowed lanes (float64).

- :func:`pairhmm_batch_cuda` (float32) and :func:`pairhmm_f64_batch_cuda`
  (float64) launch the kernel on CUDA tensors and raise on anything it does
  not take. Each counts its launches in its ``launches`` attribute, after a
  launch that returned no error.
- The router by device is ``pairhmm_batch_best`` in ops/pairhmm.py, whose
  plain version :func:`~mini_parallel_tpu_torch.ops.pairhmm.pairhmm_batch`
  the kernel is held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch.ops.pairhmm import (
    DEFAULT_GAP_EXT_PHRED,
    DEFAULT_GAP_OPEN_PHRED,
    LOG10_2,
    scale_log2_of,
    transition_probs,
)
from mini_parallel_tpu_torch.ops.sw_cuda import check_operands

KERNEL_NAME = "pairhmm"
KERNEL_SOURCES = ("pairhmm.cu",)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    lib.pairhmm_launch.argtypes = [
        *(ctypes.c_void_p,) * 7, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *(ctypes.c_double,) * 6, ctypes.c_void_p,
    ]
    lib.pairhmm_launch.restype = ctypes.c_int
    lib.pairhmm_scratch_per_pair.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pairhmm_scratch_per_pair.restype = ctypes.c_int
    return lib


def _launch(reads, err, haps, read_lens, hap_lens, gap_open_phred,
            gap_ext_phred, dtype: torch.dtype) -> torch.Tensor:
    check_operands(reads, haps)
    B, M = reads.shape
    N = haps.shape[1]
    if err.dtype != dtype or tuple(err.shape) != (B, M):
        raise ValueError(f"err must be a {dtype} ({B}, {M}) tensor, got "
                         f"{err.dtype} {tuple(err.shape)}")
    for name, t in (("err", err), ("read_lens", read_lens),
                    ("hap_lens", hap_lens)):
        if t.device != reads.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {reads.device}")
    for name, t in (("read_lens", read_lens), ("hap_lens", hap_lens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be a ({B},) int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    dev = reads.device
    out = torch.full((B,), float("-inf"), dtype=dtype, device=dev)
    if B == 0 or M == 0 or N == 0:
        return out
    lib = _kernel_lib()
    per_pair = lib.pairhmm_scratch_per_pair(M, N)
    scratch = (torch.empty((B, per_pair), dtype=dtype, device=dev)
               if per_pair else None)
    f64 = dtype == torch.float64
    scale_log2 = scale_log2_of(dtype)
    with torch.cuda.device(dev):
        rc = lib.pairhmm_launch(
            reads.data_ptr(), err.data_ptr(), haps.data_ptr(),
            read_lens.data_ptr(), hap_lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, M, N, int(f64),
            *transition_probs(gap_open_phred, gap_ext_phred),
            2.0 ** scale_log2, scale_log2 * LOG10_2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"pairhmm kernel launch failed: CUDA error {rc}")
    (pairhmm_f64_batch_cuda if f64 else pairhmm_batch_cuda).launches += 1
    return out


def pairhmm_batch_cuda(reads: torch.Tensor, err: torch.Tensor,
                       haps: torch.Tensor, read_lens: torch.Tensor,
                       hap_lens: torch.Tensor,
                       gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                       gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED
                       ) -> torch.Tensor:
    """(B, M) uint8 PAD_A-padded reads, (B, M) float32 errors, (B, N)
    uint8 PAD_B-padded haplotypes and (B,) int32 lengths, CUDA tensors ->
    (B,) float32 log10 P(read | hap) by the kernel in float32 with the 2^120
    scale, on the current stream; -inf on empty lanes and where the scaled
    total is below FLT_MIN."""
    return _launch(reads, err, haps, read_lens, hap_lens, gap_open_phred,
                   gap_ext_phred, torch.float32)


pairhmm_batch_cuda.launches = 0


def pairhmm_f64_batch_cuda(reads: torch.Tensor, err: torch.Tensor,
                           haps: torch.Tensor, read_lens: torch.Tensor,
                           hap_lens: torch.Tensor,
                           gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                           gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED
                           ) -> torch.Tensor:
    """:func:`pairhmm_batch_cuda` in float64, unscaled: ``err`` and the
    result are float64."""
    return _launch(reads, err, haps, read_lens, hap_lens, gap_open_phred,
                   gap_ext_phred, torch.float64)


pairhmm_f64_batch_cuda.launches = 0
