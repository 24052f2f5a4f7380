"""Measured int32 roofline of the card: how close the SW kernel runs to the
rate a chain of the same operation reaches. The counterpart of
mini_parallel_tpu/tools/roofline.py.

    python -m mini_parallel_tpu_torch.tools.roofline

A "share of peak" claim needs a ceiling measured the same way as the kernel
(same card, same timing), not only a data-sheet number. Two rates:

1. ``peak``: ``csrc/roofline.cu``, a serial chain of CHAIN ``y = max(y + a,
   b)`` steps over a (2048, 512) int32 tile, each step the DPX instruction
   the SW kernels' cells use (``__viaddmax_s32``). It reads the tile's two
   operands once and writes it once while doing 2 x CHAIN operations per
   element (an add and a max a step, as the TPU tool counts them): bound
   by operations by construction. On Hopper a step is ONE instruction, so
   the card's int32 instruction rate is half that peak; the SW kernels'
   counts in OPS_PER_CELL are instructions, and the printed ``value``,
   sw_score's share, is one instruction rate over the other.
2. ``sw``: the port's ``sw_score`` kernel (``csrc/sw_score.cu``) at 10,000
   pairs of 150 bp (padded to 152), at OPS_PER_CELL["sw_score"] int32
   operations per cell of the 10,000 x 150 x 150 it needs.

Both are timed with CUDA events by the TPU tool's slope discipline: the
time of HI calls less that of LO calls over HI - LO, the median of REPS.
Prints one JSON line with the TPU tool's keys. Needs a CUDA card: a
measurement that finds none fails.

The module also holds the estimates every kernel's bound in ``chip_smoke.py``
rests on: the card's int32 and float rates and OPS_PER_CELL, the operations
per DP cell counted from each kernel's source (not read from SASS).
"""

from __future__ import annotations

import ctypes
import functools
import json
import statistics
import sys

import numpy as np
import torch

from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch.device import NoAcceleratorError, require_cuda
from mini_parallel_tpu_torch.ops import encode
from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_cuda

CHAIN = 2048  # serial add+max steps per element per call
TILE = (2048, 512)  # int32: a 4 MB operand
READS, READ_LEN, PAD = 10_000, 150, 152
KERNEL_NAME = "roofline"
KERNEL_SOURCES = ("roofline.cu",)

# Estimated peaks of one H100 SXM at its 1,980 MHz boost clock: 132 SMs x 64
# int32 lanes, x 128 float32 lanes, x 64 float64 lanes; HBM3 at 3.35 TB/s.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9
FP64_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# int32 or float instructions per DP cell, counted from each kernel's source
# (a DPX instruction counts as one)
OPS_PER_CELL = {"sw_score": 6, "sw_affine_score": 10, "sw_long": 7,
                "sw_long_affine": 11, "sw_vs_ref": 7, "sw_moves": 15,
                "sw_affine_moves": 24,
                # the float instructions the recurrence needs, an FMA as one:
                # M is mul, fma, fma, then mul by the prior; I and D a mul
                # and an fma each (csrc/pairhmm.cu issues 12: it rounds each
                # mul and add apart to track the plain version)
                "pairhmm": 8, "pairhmm_f64": 8,
                # a chain step is one __viaddmax_s32
                "roofline_chain": 1}
# the TPU tool counts a chain step as 2 ops (an add and a max); the peak it
# reports, and this tool's peak_chain_int32_ops_per_s, count so
CHAIN_OPS_PER_STEP = 2


def roofline_chain(a: torch.Tensor, b: torch.Tensor, chain: int
                   ) -> torch.Tensor:
    """Plain version: y = a, then ``chain`` times y = max(y + a, b)."""
    y = a.clone()
    for _ in range(chain):
        y = torch.maximum(y + a, b)
    return y


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    lib.roofline_chain_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.roofline_chain_launch.restype = ctypes.c_int
    return lib


def roofline_chain_cuda(a: torch.Tensor, b: torch.Tensor, chain: int
                        ) -> torch.Tensor:
    """:func:`roofline_chain` by the kernel on CUDA int32 tensors of one
    shape, on the current stream."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a CUDA int32 tensor, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"operands {tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device}")
    if chain < 0:
        raise ValueError(f"chain must be >= 0, got {chain}")
    y = torch.empty_like(a)
    if a.numel() == 0:
        return y
    with torch.cuda.device(a.device):
        rc = _kernel_lib().roofline_chain_launch(
            a.data_ptr(), b.data_ptr(), y.data_ptr(), a.numel(), chain,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"roofline kernel launch failed: CUDA error {rc}")
    roofline_chain_cuda.launches += 1
    return y


roofline_chain_cuda.launches = 0


def _slope(fn, lo: int = 2, hi: int = 12, reps: int = 5) -> float:
    """Seconds per call net of fixed costs: (t(hi calls) - t(lo calls)) /
    (hi - lo) by CUDA events, the median of ``reps`` (the TPU tool's
    discipline)."""

    def timed(iters: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    fn()  # warm-up (and the build, on a first call)
    torch.cuda.synchronize()
    return statistics.median(max((timed(hi) - timed(lo)) / (hi - lo), 1e-12)
                             for _ in range(reps))


def chain_operands(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The seeded (2048, 512) int32 tile operands of the TPU tool."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-3, 3, TILE, np.int32)).to(device)
    b = torch.from_numpy(rng.integers(-100, 100, TILE, np.int32)).to(device)
    return a, b


def measure_peak_chain(device=None) -> float:
    """Attainable int32 ops/s of the card: the chain kernel over the tile,
    CHAIN_OPS_PER_STEP operations a step."""
    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("the roofline measures the card: a CUDA device")
    a, b = chain_operands(dev)
    dt = _slope(lambda: roofline_chain_cuda(a, b, CHAIN))
    return TILE[0] * TILE[1] * CHAIN * CHAIN_OPS_PER_STEP / dt


def sw_operands(device) -> tuple[torch.Tensor, torch.Tensor]:
    """10,000 seeded pairs of random 150 bp reads, padded to 152."""
    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    arr_a = np.full((READS, PAD), encode.PAD_A, np.uint8)
    arr_b = np.full((READS, PAD), encode.PAD_B, np.uint8)
    arr_a[:, :READ_LEN] = rng.choice(base, size=(READS, READ_LEN))
    arr_b[:, :READ_LEN] = rng.choice(base, size=(READS, READ_LEN))
    return (torch.from_numpy(arr_a).to(device),
            torch.from_numpy(arr_b).to(device))


def measure_sw(device=None) -> tuple[float, float, float]:
    """-> (useful GCUPS, int32 ops/s at OPS_PER_CELL["sw_score"], seconds
    per batch) of the port's sw_score kernel."""
    a, b = sw_operands(require_cuda(device))
    dt = _slope(lambda: sw_score_batch_cuda(a, b))
    cells = READS * READ_LEN * READ_LEN / dt
    return cells / 1e9, cells * OPS_PER_CELL["sw_score"], dt


def main(echo=print) -> int:
    try:
        peak = measure_peak_chain()
        gcups, sw_ops, dt = measure_sw()
    except NoAcceleratorError as e:
        echo(f"ERROR: {e}; the roofline measures the card")
        return 1
    # both sides in instructions: sw_ops counts them, a chain step is one
    peak_instr = peak / CHAIN_OPS_PER_STEP * OPS_PER_CELL["roofline_chain"]
    echo(json.dumps({
        "metric": "sw_int32_efficiency",
        "value": round(sw_ops / peak_instr, 4),
        "unit": "fraction_of_measured_int32_instruction_rate",
        "extra": {
            "peak_chain_int32_ops_per_s": round(peak / 1e9, 1),
            "peak_chain_int32_instructions_per_s": round(peak_instr / 1e9, 1),
            "sw_vector_ops_per_s_gops": round(sw_ops / 1e9, 1),
            "sw_useful_gcups": round(gcups, 1),
            # the TPU kernel's wavefront positions do not describe a
            # warp-per-pair kernel: the ops count cells instead
            "sw_wavefront_positions_per_s_g": None,
            "ops_per_position": OPS_PER_CELL["sw_score"],
            "batch_latency_ms": round(dt * 1e3, 3),
            "device": torch.cuda.get_device_name(0),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
