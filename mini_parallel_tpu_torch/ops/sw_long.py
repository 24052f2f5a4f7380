"""Exact Smith-Waterman for LONG sequence pairs by full-height column
strips: the counterpart of mini_parallel_tpu/ops/sw_long.py on one device
(its ``_sharded`` functions wait for the port of ``parallel/``).

The DP grid (M rows = seq_a, N columns = seq_b) is cut into strips of W
columns that span every row. The top boundary of a strip is the true DP
edge, so only the strip's right boundary column is carried to the next
strip: H, and for affine gaps also F, the gap state along j, which crosses
strip boundaries. Memory is O(M + N) on the device.

The split is the JAX package's:

- a Python host loop (:func:`sw_score_long`, :func:`sw_affine_score_long`)
  walks the strips and carries the boundary column(s); the best score stays
  on the device until the end;
- the per-strip sweep is the kernel (``csrc/sw_long.cu``, replacing the TPU
  ``_strip_kernel``/``_strip_kernel_affine``). Each kernel has a plain
  PyTorch version with the same contract, :func:`sw_strip` and
  :func:`sw_affine_strip`: inputs are all of a (M,), the strip's columns of
  b (W,) and the carried-in column(s) (M,); outputs are the strip's best
  score (a 0-d int32 tensor) and the column(s) to carry on.
- :func:`strip_best` routes by device: CPU tensors to the plain version,
  CUDA tensors to the kernel or an error.

Affine names follow the JAX long engine: E is the gap along i (it stays in
its column), F the gap along j (it is carried). A gap of length L costs
gap_open + L * gap_extend; both must be <= 0.

The strip width is a parameter of both host loops, so that tests can force
many strips. It is a multiple of ``WIDTH_MULTIPLE``; the host pads b with
PAD_B up to that multiple, which never changes the score (pads mismatch
and gaps only cost).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch.ops.encode import PAD_B
from mini_parallel_tpu_torch.ops.sw import (
    GAP_EXTEND,
    GAP_OPEN,
    GAP_PENALTY,
    MATCH_SCORE,
    MISMATCH_PENALTY,
    NEG,
)

KERNEL_NAME = "sw_long"
KERNEL_SOURCES = ("sw_long.cu",)
# csrc/sw_long.cu's geometry: 16 columns per thread, at most 512 threads
# (one block per strip); it refuses other widths with an error code
WIDTH_MULTIPLE = 16
MAX_STRIP_WIDTH = 8192
DEFAULT_STRIP_WIDTH = MAX_STRIP_WIDTH


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), np.uint8)
    return np.asarray(seq, np.uint8)


# ---------------------------------------------------------------------------
# NumPy goldens (tests)
# ---------------------------------------------------------------------------


def sw_score_numpy_blocked(seq_a, seq_b) -> int:
    """Vectorized NumPy anti-diagonal golden for sizes where the quadratic
    Python-loop oracle (ops/sw.py:sw_score_numpy) is too slow. O(M+N)
    memory, NumPy vector ops per diagonal."""
    a = _as_u8(seq_a).astype(np.int64)
    b = _as_u8(seq_b).astype(np.int64)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    prev = np.zeros(M + 1, np.int64)   # H on diagonal d-1, indexed by i+1
    prev2 = np.zeros(M + 1, np.int64)  # H on diagonal d-2
    best = 0
    for d in range(M + N - 1):
        lo = max(0, d - N + 1)
        hi = min(d, M - 1)
        i = np.arange(lo, hi + 1)
        j = d - i
        s = np.where(a[i] == b[j], MATCH_SCORE, MISMATCH_PENALTY)
        diag = prev2[i] + s          # H[i-1][j-1]
        up = prev[i]                 # H[i-1][j]
        left = prev[i + 1]           # H[i][j-1]
        h = np.maximum(
            np.maximum(diag, np.maximum(up, left) + GAP_PENALTY), 0)
        best = max(best, int(h.max()))
        prev2 = prev
        cur = np.zeros(M + 1, np.int64)
        cur[i + 1] = h
        prev = cur
    return best


def sw_affine_numpy_blocked(seq_a, seq_b, gap_open: int = GAP_OPEN,
                            gap_extend: int = GAP_EXTEND) -> int:
    """Vectorized NumPy anti-diagonal Gotoh golden, O(M+N) memory."""
    a = _as_u8(seq_a).astype(np.int64)
    b = _as_u8(seq_b).astype(np.int64)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    neg = np.int64(-(2**40))
    ph = np.zeros(M + 1, np.int64)   # H on diagonal d-1, index i+1
    ph2 = np.zeros(M + 1, np.int64)  # H on diagonal d-2
    pe = np.full(M + 1, neg)         # E on diagonal d-1
    pf = np.full(M + 1, neg)         # F on diagonal d-1
    best = 0
    for d in range(M + N - 1):
        lo = max(0, d - N + 1)
        hi = min(d, M - 1)
        i = np.arange(lo, hi + 1)
        s = np.where(a[i] == b[d - i], MATCH_SCORE, MISMATCH_PENALTY)
        e = np.maximum(pe[i], ph[i] + gap_open) + gap_extend       # (i-1, j)
        f = np.maximum(pf[i + 1], ph[i + 1] + gap_open) + gap_extend  # (i, j-1)
        h = np.maximum(np.maximum(ph2[i] + s, np.maximum(e, f)), 0)
        best = max(best, int(h.max()))
        ph2 = ph
        ph = np.zeros(M + 1, np.int64)
        ph[i + 1] = h
        ne = np.full(M + 1, neg)
        ne[i + 1] = e
        nf = np.full(M + 1, neg)
        nf[i + 1] = f
        pe, pf = ne, nf
    return best


# ---------------------------------------------------------------------------
# Plain per-strip versions (PyTorch)
# ---------------------------------------------------------------------------
# Both sweep the strip column by column over all M rows at once. Within a
# column the only sequential dependency is the gap along i, and it unrolls
# into a running maximum: with X[i] the best of the other moves,
#   H[i] = max(X[i], H[i-1] + g)          = g*i + cummax(X[k] - g*k)[i]
# (linear gap g), and for the affine E (gap costs <= 0, top row H = 0)
#   E[i] = max_{-1 <= k < i} (X[k] + go + ge*(i-k)),  X[-1] = 0.
# So each column is a handful of elementwise ops and one cummax.


def _column_scores(a: torch.Tensor, bj: torch.Tensor) -> torch.Tensor:
    return torch.where(a == bj, MATCH_SCORE, MISMATCH_PENALTY).to(torch.int32)


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x[i] -> x[i-1], ``fill`` at i = 0."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def sw_strip(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One strip, linear gaps, plain PyTorch: a (M,) uint8, b (W,) uint8,
    left_h (M,) int32 = H of the column before the strip ->
    (best 0-d int32, right_h (M,) int32 = H of the strip's last column)."""
    M = a.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    h = left_h
    if M == 0:
        return best, h
    ramp = GAP_PENALTY * torch.arange(M, dtype=torch.int32, device=a.device)
    for j in range(b.shape[0]):
        x = torch.maximum(_shift_down(h, 0) + _column_scores(a, b[j]),
                          h + GAP_PENALTY).clamp_min_(0)
        h = torch.cummax(x - ramp, 0).values + ramp
        best = torch.maximum(best, h.max())
    return best, h


def sw_affine_strip(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor,
                    left_f: torch.Tensor, gap_open: int = GAP_OPEN,
                    gap_extend: int = GAP_EXTEND
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One strip, affine gaps, plain PyTorch: as :func:`sw_strip`, plus
    left_f (M,) int32 = F (gap along j) of the column before the strip ->
    (best, right_h, right_f)."""
    M = a.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    h, f = left_h, left_f
    if M == 0:
        return best, h, f
    ramp = gap_extend * torch.arange(M, dtype=torch.int32, device=a.device)
    for j in range(b.shape[0]):
        f = torch.maximum(f, h + gap_open) + gap_extend
        x = torch.maximum(_shift_down(h, 0) + _column_scores(a, b[j]),
                          f).clamp_min_(0)
        # E[i] = go + ge*i + max(ge, max_{k<i} (X[k] - ge*k))
        run = _shift_down(torch.cummax(x - ramp, 0).values, NEG)
        e = torch.clamp_min(run, gap_extend) + ramp + gap_open
        h = torch.maximum(x, e)
        best = torch.maximum(best, h.max())
    return best, h, f


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sw_long_strip_launch.argtypes = [p, i, p, i, p, p, p, p]
    lib.sw_long_strip_launch.restype = i
    lib.sw_affine_long_strip_launch.argtypes = [p, i, p, i, p, p, p, p, p,
                                                i, i, p]
    lib.sw_affine_long_strip_launch.restype = i
    return lib


def _check_strip(a: torch.Tensor, b: torch.Tensor,
                 cols: tuple[torch.Tensor, ...]) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"a must be a CUDA tensor, got {a.device}")
    for name, t, dtype in (("a", a, torch.uint8), ("b", b, torch.uint8),
                           *((f"column {k}", c, torch.int32)
                             for k, c in enumerate(cols))):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    M, W = a.shape[0], b.shape[0]
    for c in cols:
        if c.shape[0] != M:
            raise ValueError(f"a carried column has {c.shape[0]} rows, a {M}")
    if W % WIDTH_MULTIPLE or W > MAX_STRIP_WIDTH:
        raise ValueError(f"strip width {W} must be a multiple of "
                         f"{WIDTH_MULTIPLE} and at most {MAX_STRIP_WIDTH}")


def _launch(fn, name: str, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def sw_strip_cuda(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sw_strip` by the CUDA kernel, on the current stream."""
    _check_strip(a, b, (left_h,))
    M, W = a.shape[0], b.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    if M == 0 or W == 0:
        return best, left_h.clone()
    right_h = torch.empty_like(left_h)
    with torch.cuda.device(a.device):
        _launch(_kernel_lib().sw_long_strip_launch, "sw_long",
                a.data_ptr(), M, b.data_ptr(), W, left_h.data_ptr(),
                right_h.data_ptr(), best.data_ptr(),
                torch.cuda.current_stream(a.device).cuda_stream)
    sw_strip_cuda.launches += 1
    return best, right_h


sw_strip_cuda.launches = 0


def sw_affine_strip_cuda(a: torch.Tensor, b: torch.Tensor,
                         left_h: torch.Tensor, left_f: torch.Tensor,
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sw_affine_strip` by the CUDA kernel, on the current stream."""
    _check_strip(a, b, (left_h, left_f))
    if gap_open > 0 or gap_extend > 0:
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    M, W = a.shape[0], b.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    if M == 0 or W == 0:
        return best, left_h.clone(), left_f.clone()
    right_h = torch.empty_like(left_h)
    right_f = torch.empty_like(left_f)
    with torch.cuda.device(a.device):
        _launch(_kernel_lib().sw_affine_long_strip_launch, "sw_long affine",
                a.data_ptr(), M, b.data_ptr(), W, left_h.data_ptr(),
                left_f.data_ptr(), right_h.data_ptr(), right_f.data_ptr(),
                best.data_ptr(), int(gap_open), int(gap_extend),
                torch.cuda.current_stream(a.device).cuda_stream)
    sw_affine_strip_cuda.launches += 1
    return best, right_h, right_f


sw_affine_strip_cuda.launches = 0


def strip_best(affine: bool, device: torch.device):
    """The per-strip function for ``device``: the plain version on the
    CPU, the CUDA kernel's wrapper on anything else."""
    if device.type == "cpu":
        return sw_affine_strip if affine else sw_strip
    return sw_affine_strip_cuda if affine else sw_strip_cuda


# ---------------------------------------------------------------------------
# Host loops
# ---------------------------------------------------------------------------


def _sweep(affine: bool, seq_a, seq_b, device: torch.device,
           strip_width: int, progress, gap_args: tuple = ()) -> int:
    """The host loop: a and b go to ``device`` once (b padded with PAD_B
    to a multiple of WIDTH_MULTIPLE); each strip of W columns takes the
    carried column(s) and hands on its right column(s); the best score
    stays on the device until the one read at the end."""
    if strip_width <= 0 or strip_width % WIDTH_MULTIPLE \
            or strip_width > MAX_STRIP_WIDTH:
        raise ValueError(f"strip_width {strip_width} must be a positive "
                         f"multiple of {WIDTH_MULTIPLE} up to "
                         f"{MAX_STRIP_WIDTH}")
    a_np, b_np = _as_u8(seq_a), _as_u8(seq_b)
    M, N = a_np.size, b_np.size
    if M == 0 or N == 0:
        return 0
    bp = np.full(-(-N // WIDTH_MULTIPLE) * WIDTH_MULTIPLE, PAD_B, np.uint8)
    bp[:N] = b_np
    a = torch.from_numpy(a_np.copy()).to(device)
    b = torch.from_numpy(bp).to(device)
    W = min(strip_width, bp.size)
    cols = [torch.zeros(M, dtype=torch.int32, device=device)]
    if affine:
        cols.append(torch.full((M,), NEG, dtype=torch.int32, device=device))
    fn = strip_best(affine, device)
    best = torch.zeros((), dtype=torch.int32, device=device)
    n_strips = -(-bp.size // W)
    for si in range(n_strips):
        j0 = si * W
        strip_max, *cols = fn(a, b[j0:j0 + W], *cols, *gap_args)
        best = torch.maximum(best, strip_max)
        if progress:
            progress(f"  sw-affine-long strip {si + 1}/{n_strips}" if affine
                     else f"  sw-long strip {si + 1}/{n_strips} "
                     f"(cols {j0}-{min(j0 + W, N)})")
    return int(best)


def sw_score_long(seq_a, seq_b, device: torch.device,
                  strip_width: int = DEFAULT_STRIP_WIDTH,
                  progress=None) -> int:
    """Exact linear-gap SW score of ONE pair of any length by column
    strips on ``device``. seq_a/seq_b: ASCII bytes, str or uint8 arrays;
    rows run along seq_a (pass the longer side as seq_a for fewer, fuller
    strips)."""
    return _sweep(False, seq_a, seq_b, device, strip_width, progress)


def sw_affine_score_long(seq_a, seq_b, device: torch.device,
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND,
                         strip_width: int = DEFAULT_STRIP_WIDTH,
                         progress=None) -> int:
    """Exact affine-gap (Gotoh) SW score of ONE pair of any length by
    column strips on ``device``: carries BOTH the H and F boundary
    columns between strips."""
    if gap_open > 0 or gap_extend > 0:
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    return _sweep(True, seq_a, seq_b, device, strip_width, progress,
                  (gap_open, gap_extend))
