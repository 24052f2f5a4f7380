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
- The kernel keeps a pair's moves in shared memory where they fit (one
  stripe, M <= 256, and up to 48 KB: at M = 152, windows of up to 1,185
  columns linear, 577 affine) and writes them out only when
  ``return_moves`` asks for them; past that they go to a device-memory
  buffer the wrapper allocates. :func:`moves_layout` gives the layout in
  plain Python.
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
    for fn in (lib.sw_moves_on_chip, lib.sw_moves_bound_per_pair):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    return lib


def moves_layout(M: int, N: int, affine: bool) -> tuple[int, int, int, int]:
    """(R, P, codes, W) of the kernel's moves words for M x N pairs: lane l
    of a warp owns rows l * R .. l * R + R - 1 of each 32R-row stripe
    (R = ceil(M / 32), at most 8) and computes column j of them at step
    j + l; word w of a row holds the move codes of steps w * codes + k at
    bits k * bits (codes = 16 words of 2-bit codes linear, 8 of 4-bit codes
    affine); a stripe is W = ceil((N + 31) / codes) rows of 32 * P words,
    lane l's row r at word l * P + r with P = R | 1."""
    R = min(-(-M // 32), 8)
    codes = 8 if affine else 16
    return R, R | 1, codes, -(-(N + 31) // codes)


def moves_words_per_pair(M: int, N: int, affine: bool) -> int:
    """uint32 moves words of one pair: every stripe's W * 32 * P."""
    R, P, _, W = moves_layout(M, N, affine)
    return -(-M // (32 * R)) * W * 32 * P


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
    if B == 0 or M == 0 or N == 0:
        positions = torch.full((B, M), -1, dtype=torch.int32, device=dev)
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return (best, bd, bi, positions) + ((empty,) if return_moves else ())
    positions = torch.empty((B, M), dtype=torch.int32, device=dev)  # kernel-set
    lib = _kernel_lib()
    moves = (torch.empty((B, moves_words_per_pair(M, N, affine)),
                         dtype=torch.int32, device=dev)
             if return_moves or not lib.sw_moves_on_chip(M, N, int(affine))
             else None)
    per_pair = lib.sw_moves_bound_per_pair(M, N, int(affine))
    bound = (torch.empty((B, per_pair), dtype=torch.int32, device=dev)
             if per_pair else None)
    with torch.cuda.device(dev):
        rc = lib.sw_moves_launch(
            seq_a.data_ptr(), seq_b.data_ptr(), best.data_ptr(),
            bd.data_ptr(), bi.data_ptr(), positions.data_ptr(),
            moves.data_ptr() if moves is not None else None,
            bound.data_ptr() if bound is not None else None,
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
    kernel's (B, words) int32 moves words (:func:`moves_layout`) come
    last."""
    return _launch(seq_a, seq_b, False, 0, 0, return_moves)


sw_moves_batch_cuda.launches = 0


def sw_affine_moves_batch_cuda(seq_a: torch.Tensor, seq_b: torch.Tensor,
                               gap_open: int = GAP_OPEN,
                               gap_extend: int = GAP_EXTEND,
                               return_moves: bool = False):
    """Affine-gap (Gotoh) :func:`sw_moves_batch_cuda`; gap costs are
    runtime arguments and must be <= 0."""
    return _launch(seq_a, seq_b, True, gap_open, gap_extend, return_moves)


sw_affine_moves_batch_cuda.launches = 0


def moves_to_cells(words: torch.Tensor, M: int, N: int,
                   affine: bool) -> torch.Tensor:
    """The kernel's moves words (B, words) -> (B, M, N) uint8, the move
    code of every cell (i, j), by the layout of :func:`moves_layout`."""
    B = words.shape[0]
    R, P, codes, W = moves_layout(M, N, affine)
    bits = 32 // codes
    dev = words.device
    i = torch.arange(M, device=dev)
    stripe, rem = i // (32 * R), i % (32 * R)
    lane = rem // R
    t = torch.arange(N, device=dev)[None, :] + lane[:, None]  # (M, N) steps
    idx = ((stripe * (W * 32 * P) + lane * P + rem - lane * R)[:, None]
           + t // codes * (32 * P))
    cells = words[:, idx.reshape(-1)].reshape(B, M, N)
    # int32 words shift in their sign, but the mask keeps each code's bits
    return ((cells >> (bits * (t % codes))[None]) & ((1 << bits) - 1)).to(
        torch.uint8)
