"""The variant-prep pileup on the card: the wrapper of the hand-written CUDA
kernel in ``csrc/pileup.cu``. It replaces no TPU kernel: the JAX package
piles up with ``jax.ops.segment_sum``.

:func:`pileup_positions_cuda` adds one chunk's base counts and deletion and
insertion events into the flat ``(G * 7 + 1,)`` int32 accumulator of
``models/variant_prep.py`` in one launch, with the predicates of the plain
route ``variant_prep._pileup_positions_plain``. Only counts that are real
reach an atomic; the accumulator's last slot, the plain route's trash slot,
is never written. It raises on anything the kernel does not take and
counts its launches in its ``launches`` attribute. The router by device is
``variant_prep._pileup_positions``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mini_parallel_tpu_torch import _build

KERNEL_NAME = "pileup"
KERNEL_SOURCES = ("pileup.cu",)
PILEUP_COLS = 7  # the kernel's columns: A C G T N, deletion, insertion
_POSITION_TYPES = (torch.int32, torch.int64)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    lib.pileup_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.pileup_launch.restype = ctypes.c_int
    return lib


def _check(codes, positions, G, qual_ok, acc) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be a 2-D uint8 tensor, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if positions.dtype not in _POSITION_TYPES:
        raise ValueError(
            f"positions must be int32 or int64, got {positions.dtype}")
    if positions.shape != codes.shape:
        raise ValueError(f"positions {tuple(positions.shape)} and codes "
                         f"{tuple(codes.shape)} differ in shape")
    if qual_ok is not None and (qual_ok.dtype != torch.bool
                                or qual_ok.shape != codes.shape):
        raise ValueError(f"qual_ok must be a bool tensor of codes' shape, "
                         f"got {qual_ok.dtype} {tuple(qual_ok.shape)}")
    if G <= 0:
        raise ValueError(f"G must be positive, got {G}")
    if acc.dtype != torch.int32 or acc.shape != (G * PILEUP_COLS + 1,):
        raise ValueError(
            f"acc must be a ({G * PILEUP_COLS + 1},) int32 tensor, got "
            f"{acc.dtype} {tuple(acc.shape)}")
    named = [("codes", codes), ("positions", positions), ("acc", acc)]
    if qual_ok is not None:
        named.append(("qual_ok", qual_ok))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named:
        if t.device != acc.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on acc's device, "
                             f"got {t.device} (acc on {acc.device})")


def pileup_positions_cuda(codes: torch.Tensor, positions: torch.Tensor,
                          G: int, qual_ok: torch.Tensor | None,
                          acc: torch.Tensor) -> torch.Tensor:
    """Add (B, L) uint8 ``codes`` at their (B, L) int32 or int64 reference
    ``positions`` (< 0: not aligned), gated by the (B, L) bool ``qual_ok``
    (None: every base passes), into ``acc``, a flat (G * 7 + 1,) int32 CUDA
    tensor, in place, by the CUDA kernel on the current stream. Returns
    ``acc``."""
    _check(codes, positions, G, qual_ok, acc)
    B, L = codes.shape
    if B == 0 or L == 0:
        return acc
    lib = _kernel_lib()
    dev = acc.device
    with torch.cuda.device(dev):
        rc = lib.pileup_launch(
            codes.data_ptr(), positions.data_ptr(), positions.element_size(),
            qual_ok.data_ptr() if qual_ok is not None else None,
            acc.data_ptr(), B, L, G,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"pileup kernel launch failed: CUDA error {rc}")
    pileup_positions_cuda.launches += 1
    return acc


pileup_positions_cuda.launches = 0
