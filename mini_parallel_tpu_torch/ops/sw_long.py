"""Exact Smith-Waterman for LONG sequence pairs by full-height column
strips: the counterpart of mini_parallel_tpu/ops/sw_long.py on one device
(its ``_sharded`` functions wait for the port of ``parallel/``).

The DP grid (M rows = seq_a, N columns = seq_b) is cut into strips of W
columns that span every row. The top boundary of a strip is the true DP
edge, so only the strip's right boundary column is carried to the next
strip: H, and for affine gaps also F, the gap state along j, which crosses
strip boundaries. Memory is O(M + N) on the device.

The split follows the JAX package's:

- a Python host loop (:func:`sw_score_long`, :func:`sw_affine_score_long`)
  walks GROUPS of consecutive strips and carries the boundary column(s)
  from one group to the next; the best score stays on the device until
  the end;
- one group is one launch of the kernel (``csrc/sw_long.cu``, replacing the
  TPU ``_strip_kernel``/``_strip_kernel_affine``), whose blocks sweep the
  group's strips at once, pipelined down the rows. Its wrappers,
  :func:`sw_strip_cuda` and :func:`sw_affine_strip_cuda`, take all of a
  (M,), the group's columns of b and the carried-in column(s) (M,), and
  return the group's best score (a 0-d int32 tensor) and the column(s) to
  carry on; with one strip (the default ``strip_width``) that is one
  strip's contract. The plain group functions, :func:`sw_strip_group` and
  :func:`sw_affine_strip_group`, apply the plain per-strip functions
  :func:`sw_strip` and :func:`sw_affine_strip` strip by strip.
- :func:`strip_best` routes groups by device: CPU tensors to the plain
  group, CUDA tensors to the kernel or an error.

Affine names follow the JAX long engine: E is the gap along i (it stays in
its column), F the gap along j (it is carried). A gap of length L costs
gap_open + L * gap_extend; both must be <= 0.

The strip width and the strips per group are parameters of both host
loops, so that tests can force many strips and groups. The width is a
multiple of ``WIDTH_MULTIPLE``; the host pads b with PAD_B up to that
multiple, which never changes the score (pads mismatch and gaps only
cost), and a ragged last strip is narrower.
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
# one warp per strip: a 150 kbp side gives 293 strips, two or more for each
# of the card's 132 SMs, each sweeping at its one warp's pace
DEFAULT_STRIP_WIDTH = 512
# the boundary columns between the strips of one group stay within this
GROUP_BYTES = 1 << 29


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


def _strips(b: torch.Tensor, strip_width: int | None):
    """b's strips of ``strip_width`` columns (None: one strip), the last
    one narrower when b is ragged."""
    W = strip_width or max(b.shape[0], 1)
    return (b[j0:j0 + W] for j0 in range(0, b.shape[0], W))


def sw_strip_group(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor,
                   *, strip_width: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """A group of strips, linear gaps, plain PyTorch: :func:`sw_strip`
    on each strip of ``strip_width`` columns of b in turn, carrying the
    column -> (the group's best, its last column)."""
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    h = left_h
    for strip in _strips(b, strip_width):
        m, h = sw_strip(a, strip, h)
        best = torch.maximum(best, m)
    return best, h


def sw_affine_strip_group(a: torch.Tensor, b: torch.Tensor,
                          left_h: torch.Tensor, left_f: torch.Tensor,
                          gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND, *,
                          strip_width: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sw_strip_group` for affine gaps, with
    :func:`sw_affine_strip` -> (best, last H column, last F column)."""
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    h, f = left_h, left_f
    for strip in _strips(b, strip_width):
        m, h, f = sw_affine_strip(a, strip, h, f, gap_open, gap_extend)
        best = torch.maximum(best, m)
    return best, h, f


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sw_long_group_launch.argtypes = [p, i, p, i, i, p, p, p, p, p, p]
    lib.sw_long_group_launch.restype = i
    lib.sw_affine_long_group_launch.argtypes = [p, i, p, i, i, p, p, p, p, p,
                                                p, p, p, i, i, p]
    lib.sw_affine_long_group_launch.restype = i
    lib.sw_long_resident_blocks.argtypes = [i, i]
    lib.sw_long_resident_blocks.restype = ctypes.c_longlong
    return lib


def resident_blocks(strip_width: int, affine: bool,
                    device: torch.device) -> int:
    """How many strips of ``strip_width`` columns the card holds at once:
    the kernel's grid, beyond which a group's strips wait for a ticket."""
    with torch.cuda.device(device):
        n = _kernel_lib().sw_long_resident_blocks(strip_width, int(affine))
    if n <= 0:
        raise ValueError(f"sw_long: no resident blocks for strip width "
                         f"{strip_width}")
    return n


def _check_group(a: torch.Tensor, b: torch.Tensor,
                 cols: tuple[torch.Tensor, ...],
                 strip_width: int | None) -> int:
    """Raise on what the kernel does not take; return the strip width."""
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
    M, Wtot = a.shape[0], b.shape[0]
    for c in cols:
        if c.shape[0] != M:
            raise ValueError(f"a carried column has {c.shape[0]} rows, a {M}")
    W = Wtot if strip_width is None else strip_width
    if Wtot % WIDTH_MULTIPLE or W % WIDTH_MULTIPLE or W > MAX_STRIP_WIDTH \
            or (Wtot and W <= 0):
        raise ValueError(f"strip width {W} (group of {Wtot} columns) must be "
                         f"a multiple of {WIDTH_MULTIPLE} and at most "
                         f"{MAX_STRIP_WIDTH}")
    if M >= 1 << 31 or Wtot >= 1 << 31:
        raise ValueError(f"a group of {M} x {Wtot} exceeds the kernel's int32")
    return W


def _launch(fn, name: str, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _group_scratch(M: int, W: int, Wtot: int, n_cols: int, device
                   ) -> tuple[list, torch.Tensor]:
    """The kernel's per-launch scratch: n_cols boundary buffers of
    (S - 1) x M int32 between the group's S strips (None when S = 1), and
    S int32 of row counts and the ticket counter."""
    S = -(-Wtot // W)
    bufs = [torch.empty((S - 1) * M, dtype=torch.int32, device=device)
            if S > 1 else None for _ in range(n_cols)]
    return bufs, torch.empty(S, dtype=torch.int32, device=device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def sw_strip_cuda(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor,
                  *, strip_width: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sw_strip_group` by the CUDA kernel, on the current stream:
    b's columns in strips of ``strip_width`` (None: one strip), all swept
    by one launch."""
    W = _check_group(a, b, (left_h,), strip_width)
    M, Wtot = a.shape[0], b.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    if M == 0 or Wtot == 0:
        return best, left_h.clone()
    right_h = torch.empty_like(left_h)
    (buf_h,), flags = _group_scratch(M, W, Wtot, 1, a.device)
    with torch.cuda.device(a.device):
        _launch(_kernel_lib().sw_long_group_launch, "sw_long",
                a.data_ptr(), M, b.data_ptr(), W, Wtot, left_h.data_ptr(),
                right_h.data_ptr(), _ptr(buf_h), flags.data_ptr(),
                best.data_ptr(),
                torch.cuda.current_stream(a.device).cuda_stream)
    sw_strip_cuda.launches += 1
    return best, right_h


sw_strip_cuda.launches = 0


def sw_affine_strip_cuda(a: torch.Tensor, b: torch.Tensor,
                         left_h: torch.Tensor, left_f: torch.Tensor,
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND, *,
                         strip_width: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sw_affine_strip_group` by the CUDA kernel, on the current
    stream, in one launch."""
    W = _check_group(a, b, (left_h, left_f), strip_width)
    if gap_open > 0 or gap_extend > 0:
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    M, Wtot = a.shape[0], b.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    if M == 0 or Wtot == 0:
        return best, left_h.clone(), left_f.clone()
    right_h = torch.empty_like(left_h)
    right_f = torch.empty_like(left_f)
    (buf_h, buf_f), flags = _group_scratch(M, W, Wtot, 2, a.device)
    with torch.cuda.device(a.device):
        _launch(_kernel_lib().sw_affine_long_group_launch, "sw_long affine",
                a.data_ptr(), M, b.data_ptr(), W, Wtot, left_h.data_ptr(),
                left_f.data_ptr(), right_h.data_ptr(), right_f.data_ptr(),
                _ptr(buf_h), _ptr(buf_f), flags.data_ptr(), best.data_ptr(),
                int(gap_open), int(gap_extend),
                torch.cuda.current_stream(a.device).cuda_stream)
    sw_affine_strip_cuda.launches += 1
    return best, right_h, right_f


sw_affine_strip_cuda.launches = 0


def strip_best(affine: bool, device: torch.device):
    """The group function for ``device``: the plain group on the CPU, the
    CUDA kernel's wrapper on anything else."""
    if device.type == "cpu":
        return sw_affine_strip_group if affine else sw_strip_group
    return sw_affine_strip_cuda if affine else sw_strip_cuda


def group_strips(M: int, affine: bool) -> int:
    """Strips per group at M rows: the group's S - 1 boundary buffers of
    4 M bytes (8 M affine: H and F) stay within GROUP_BYTES, i.e.
    S = 1 + GROUP_BYTES // (4 M n_cols): 269 strips linear and 135 affine
    at M = 500,000 (537 MB of buffers), 672 and 336 at M = 200,000."""
    return 1 + GROUP_BYTES // (4 * max(M, 1) * (2 if affine else 1))


# ---------------------------------------------------------------------------
# Host loops
# ---------------------------------------------------------------------------


def _sweep(affine: bool, seq_a, seq_b, device: torch.device,
           strip_width: int, progress, gap_args: tuple = (),
           strips_per_group: int | None = None) -> int:
    """The host loop: a and b go to ``device`` once (b padded with PAD_B
    to a multiple of WIDTH_MULTIPLE); each group of ``strips_per_group``
    strips of W columns (None: :func:`group_strips`) takes the carried
    column(s) and hands on its last column(s); the best score stays on the
    device until the one read at the end."""
    if strip_width <= 0 or strip_width % WIDTH_MULTIPLE \
            or strip_width > MAX_STRIP_WIDTH:
        raise ValueError(f"strip_width {strip_width} must be a positive "
                         f"multiple of {WIDTH_MULTIPLE} up to "
                         f"{MAX_STRIP_WIDTH}")
    if strips_per_group is not None and strips_per_group <= 0:
        raise ValueError(f"strips_per_group {strips_per_group} must be "
                         "positive")
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
    per_group = strips_per_group or group_strips(M, affine)
    for s0 in range(0, n_strips, per_group):
        s1 = min(s0 + per_group, n_strips)
        group_max, *cols = fn(a, b[s0 * W:s1 * W], *cols, *gap_args,
                              strip_width=W)
        best = torch.maximum(best, group_max)
        if progress:
            progress(f"  {'sw-affine-long' if affine else 'sw-long'} strips "
                     f"{s0 + 1}-{s1}/{n_strips} (cols {s0 * W}-"
                     f"{min(s1 * W, N)})")
    return int(best)


def sw_score_long(seq_a, seq_b, device: torch.device,
                  strip_width: int = DEFAULT_STRIP_WIDTH,
                  progress=None, strips_per_group: int | None = None) -> int:
    """Exact linear-gap SW score of ONE pair of any length by column
    strips on ``device``. seq_a/seq_b: ASCII bytes, str or uint8 arrays;
    rows run along seq_a (pass the longer side as seq_a: each strip's
    blocks pipeline down the rows)."""
    return _sweep(False, seq_a, seq_b, device, strip_width, progress,
                  strips_per_group=strips_per_group)


def sw_affine_score_long(seq_a, seq_b, device: torch.device,
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND,
                         strip_width: int = DEFAULT_STRIP_WIDTH,
                         progress=None,
                         strips_per_group: int | None = None) -> int:
    """Exact affine-gap (Gotoh) SW score of ONE pair of any length by
    column strips on ``device``: carries BOTH the H and F boundary
    columns between strips."""
    if gap_open > 0 or gap_extend > 0:
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    return _sweep(True, seq_a, seq_b, device, strip_width, progress,
                  (gap_open, gap_extend), strips_per_group)
