"""Batched Smith-Waterman traceback on the card: the wrappers of the
hand-written CUDA kernels in ``csrc/sw_moves.cu`` (linear and affine
gaps). The counterpart of the JAX package's ``sw_moves_batch_pallas`` and
``sw_affine_moves_batch_pallas`` together with the walks that follow them
(``_positions_walk_packed``, ``_affine_walk_packed``), which the kernel
fuses.

- :func:`sw_moves_batch_cuda` and :func:`sw_affine_moves_batch_cuda` launch
  the kernel on CUDA tensors and raise on anything it does not take. They
  return (best, bd, bi, positions) and, on request, the kernel's moves
  words; :func:`moves_to_cells` turns those into one code per cell, the
  layout of ``sw_traceback.plain_moves_to_cells``. Each counts its
  launches in its ``launches`` attribute.
- The routers by device are ``sw_positions_batch_best`` and
  ``sw_affine_positions_batch_best`` in ops/sw_traceback.py.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch.ops.sw import GAP_EXTEND, GAP_OPEN
from mini_parallel_tpu_torch.ops.sw_cuda import check_operands

KERNEL_NAME = "sw_moves"
KERNEL_SOURCES = ("sw_moves.cu",)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    lib.sw_moves_launch.argtypes = [
        *(ctypes.c_void_p,) * 8, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.sw_moves_launch.restype = ctypes.c_int
    lib.sw_moves_words_per_pair.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sw_moves_words_per_pair.restype = ctypes.c_longlong
    lib.sw_moves_bound_per_pair.argtypes = [ctypes.c_int] * 3
    lib.sw_moves_bound_per_pair.restype = ctypes.c_int
    lib.sw_moves_rows_per_lane.argtypes = [ctypes.c_int]
    lib.sw_moves_rows_per_lane.restype = ctypes.c_int
    return lib


def _launch(seq_a, seq_b, affine: bool, gap_open: int, gap_extend: int,
            return_moves: bool):
    check_operands(seq_a, seq_b)
    if affine and (gap_open > 0 or gap_extend > 0):
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    B, M = seq_a.shape
    N = seq_b.shape[1]
    dev = seq_a.device
    best, bd, bi = (torch.zeros(B, dtype=torch.int32, device=dev)
                    for _ in range(3))
    positions = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    if B == 0 or M == 0 or N == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return (best, bd, bi, positions) + ((empty,) if return_moves else ())
    lib = _kernel_lib()
    words = lib.sw_moves_words_per_pair(M, N)
    moves = torch.empty((B, words), device=dev,
                        dtype=torch.int32 if affine else torch.int16)
    per_pair = lib.sw_moves_bound_per_pair(M, N, int(affine))
    bound = (torch.empty((B, per_pair), dtype=torch.int32, device=dev)
             if per_pair else None)
    with torch.cuda.device(dev):
        rc = lib.sw_moves_launch(
            seq_a.data_ptr(), seq_b.data_ptr(), best.data_ptr(),
            bd.data_ptr(), bi.data_ptr(), positions.data_ptr(),
            moves.data_ptr(), bound.data_ptr() if bound is not None else None,
            B, M, N, int(affine), int(gap_open), int(gap_extend),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_moves kernel launch failed: CUDA error {rc}")
    (sw_affine_moves_batch_cuda if affine else sw_moves_batch_cuda
     ).launches += 1
    return (best, bd, bi, positions) + ((moves,) if return_moves else ())


def sw_moves_batch_cuda(seq_a: torch.Tensor, seq_b: torch.Tensor,
                        return_moves: bool = False):
    """(B, M) uint8 PAD_A-padded x (B, N) uint8 PAD_B-padded CUDA tensors ->
    (best, bd, bi, positions) of linear-gap SW, by the CUDA kernel, on the
    current stream: best/bd/bi (B,) int32 (the argmax cell is row bi,
    column bd - bi), positions (B, M) int32. With ``return_moves`` the
    kernel's (B, words) int16 moves words come last."""
    return _launch(seq_a, seq_b, False, 0, 0, return_moves)


sw_moves_batch_cuda.launches = 0


def sw_affine_moves_batch_cuda(seq_a: torch.Tensor, seq_b: torch.Tensor,
                               gap_open: int = GAP_OPEN,
                               gap_extend: int = GAP_EXTEND,
                               return_moves: bool = False):
    """Affine-gap (Gotoh) :func:`sw_moves_batch_cuda`; gap costs are
    runtime arguments and must be <= 0. Moves words are int32."""
    return _launch(seq_a, seq_b, True, gap_open, gap_extend, return_moves)


sw_affine_moves_batch_cuda.launches = 0


def moves_to_cells(words: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """The kernel's moves words (B, words) -> (B, M, N) uint8, the move
    code of every cell (i, j). Word [stripe][j + l][l] of a pair holds the
    codes of rows stripe * 32R + l * R + r at bits ``bits * r``, with 2
    bits a code in int16 words (linear) and 4 in int32 words (affine)."""
    B = words.shape[0]
    R = _kernel_lib().sw_moves_rows_per_lane(M)
    bits = 2 if words.dtype == torch.int16 else 4
    steps = N + 31
    dev = words.device
    i = torch.arange(M, device=dev)
    stripe, rem = i // (32 * R), i % (32 * R)
    lane, r = rem // R, rem % R
    j = torch.arange(N, device=dev)
    idx = ((stripe[:, None] * steps + j[None, :] + lane[:, None]) * 32
           + lane[:, None])  # (M, N)
    # int16 words sign-extend, but every code sits in bits 0-15
    cells = words.to(torch.int32)[:, idx.reshape(-1)].reshape(B, M, N)
    return ((cells >> (bits * r)[None, :, None]) & ((1 << bits) - 1)).to(
        torch.uint8)

