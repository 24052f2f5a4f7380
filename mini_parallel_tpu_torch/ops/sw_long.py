"""Exact Smith-Waterman for LONG sequence pairs by full-height column
strips: the counterpart of mini_parallel_tpu/ops/sw_long.py, on one device
and, by row bands, on a device mesh with a ``seq`` axis.

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

Row bands (:func:`sw_score_long_sharded` and
:func:`sw_affine_score_long_sharded`): the rows are cut into C nearly
equal bands, one per device of the mesh's ``seq`` axis. A band below the
first has a real top row, so the group functions (plain and kernel) also
take an optional top row, H of the row above with the corner H[r0-1][j0-1]
in front (and E, affine), and then return the band's last row laid out
the same way, which becomes the next band's top row. The host loop walks
(band, group) in diagonal stage order, as the JAX package's pipelined
stages do (stage s: band c takes group s - c), and moves each bottom row
to the next band's device. The JAX package's band geometry (rows padded
to C * blk, bands of at least one strip width, overlap rows swept twice)
comes from its skewed wavefront state; the port's state is row-major, so
any band of one row or more is exact.

The strip width and the strips per group are parameters of both host
loops, so that tests can force many strips and groups. The width is a
multiple of ``WIDTH_MULTIPLE``; the host pads b with PAD_B up to that
multiple, which never changes the score (pads mismatch and gaps only
cost), and a ragged last strip is narrower.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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
from mini_parallel_tpu_torch.parallel import collectives

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


def _shift_down(x: torch.Tensor, fill) -> torch.Tensor:
    """x[i] -> x[i-1], ``fill`` (a number or a 1-element tensor) at i = 0."""
    head = fill.reshape(1) if torch.is_tensor(fill) else x.new_full((1,), fill)
    return torch.cat([head, x[:-1]])


def default_top(width: int, affine: bool, device
                ) -> tuple[torch.Tensor, ...]:
    """The true top edge as a band's top row(s): H = 0 over ``width``
    columns and the corner, and (affine) E = NEG."""
    top = [torch.zeros(width + 1, dtype=torch.int32, device=device)]
    if affine:
        top.append(torch.full((width,), NEG, dtype=torch.int32,
                              device=device))
    return tuple(top)


def _bottom(left_h: torch.Tensor, last_rows: list) -> torch.Tensor:
    """[left_h[M-1], the last row's H of each column]: a bottom row."""
    return torch.cat([left_h[-1:], *last_rows])


def sw_strip(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor,
             top_h: torch.Tensor | None = None):
    """One strip, linear gaps, plain PyTorch: a (M,) uint8, b (W,) uint8,
    left_h (M,) int32 = H of the column before the strip ->
    (best 0-d int32, right_h (M,) int32 = H of the strip's last column).

    With ``top_h`` (W + 1,) int32, the row above the strip (corner first,
    the band contract of csrc/sw_long.cu), it returns
    (best, right_h, bottom_h (W + 1,)). The gap chain down a column then
    starts from top_h[j] + gap instead of the edge's 0."""
    M, W = a.shape[0], b.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    top = default_top(W, False, a.device)[0] if top_h is None else top_h
    h = left_h
    if M == 0:
        return (best, h) if top_h is None else (best, h, top.clone())
    ramp = GAP_PENALTY * torch.arange(M, dtype=torch.int32, device=a.device)
    last = []
    for j in range(W):
        x = torch.maximum(_shift_down(h, top[j]) + _column_scores(a, b[j]),
                          h + GAP_PENALTY).clamp_min_(0)
        # H[i] = max(X[i], H[i-1] + g) from H[-1] = top[j + 1]
        h = torch.maximum(torch.cummax(x - ramp, 0).values,
                          top[j + 1] + GAP_PENALTY) + ramp
        best = torch.maximum(best, h.max())
        last.append(h[-1:])
    if top_h is None:
        return best, h
    return best, h, _bottom(left_h, last)


def sw_affine_strip(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor,
                    left_f: torch.Tensor, gap_open: int = GAP_OPEN,
                    gap_extend: int = GAP_EXTEND,
                    top_h: torch.Tensor | None = None,
                    top_e: torch.Tensor | None = None):
    """One strip, affine gaps, plain PyTorch: as :func:`sw_strip`, plus
    left_f (M,) int32 = F (gap along j) of the column before the strip ->
    (best, right_h, right_f).

    With the row above, ``top_h`` (W + 1,) and ``top_e`` (W,), it returns
    (best, right_h, right_f, bottom_h (W + 1,), bottom_e (W,))."""
    M, W = a.shape[0], b.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    banded = top_h is not None
    if banded != (top_e is not None):
        raise ValueError("top_h and top_e come together")
    th, te = (top_h, top_e) if banded else default_top(W, True, a.device)
    h, f = left_h, left_f
    if M == 0:
        return ((best, h, f, th.clone(), te.clone()) if banded
                else (best, h, f))
    ramp = gap_extend * torch.arange(M, dtype=torch.int32, device=a.device)
    last_h, last_e = [], []
    for j in range(W):
        f = torch.maximum(f, h + gap_open) + gap_extend
        x = torch.maximum(_shift_down(h, th[j]) + _column_scores(a, b[j]),
                          f).clamp_min_(0)
        # E[i] = ge*i + max(go + max_{k<i} (X[k] - ge*k), T + ge), where
        # T = max(H[-1] + go, E[-1]) is the row above's contribution
        # (go at the true edge: H = 0, E = NEG)
        run = _shift_down(torch.cummax(x - ramp, 0).values, NEG)
        t = torch.maximum(th[j + 1] + gap_open, te[j])
        e = torch.maximum(run + gap_open, t + gap_extend) + ramp
        h = torch.maximum(x, e)
        best = torch.maximum(best, h.max())
        last_h.append(h[-1:])
        last_e.append(e[-1:])
    if not banded:
        return best, h, f
    return best, h, f, _bottom(left_h, last_h), torch.cat(last_e)


def _strip_bounds(b: torch.Tensor, strip_width: int | None):
    """(j0, j1) of b's strips of ``strip_width`` columns (None: one
    strip), the last one narrower when b is ragged."""
    W = strip_width or max(b.shape[0], 1)
    return [(j0, min(j0 + W, b.shape[0]))
            for j0 in range(0, b.shape[0], W)]


def _check_top_len(b: torch.Tensor, top_h, top_e) -> None:
    """The band rows' lengths, as the kernel's wrappers check them."""
    for row, n in ((top_h, b.shape[0] + 1), (top_e, b.shape[0])):
        if row is not None and row.shape[0] != n:
            raise ValueError(f"a top row of {row.shape[0]} for {n}")


def sw_strip_group(a: torch.Tensor, b: torch.Tensor, left_h: torch.Tensor,
                   *, strip_width: int | None = None,
                   top_h: torch.Tensor | None = None):
    """A group of strips, linear gaps, plain PyTorch: :func:`sw_strip`
    on each strip of ``strip_width`` columns of b in turn, carrying the
    column -> (the group's best, its last column). With the row above,
    ``top_h`` (Wtot + 1,), it also returns the group's bottom row
    (Wtot + 1,)."""
    _check_top_len(b, top_h, None)
    (top,) = (default_top(b.shape[0], False, a.device) if top_h is None
              else (top_h,))
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    h, rows = left_h, []
    for j0, j1 in _strip_bounds(b, strip_width):
        m, h, bottom = sw_strip(a, b[j0:j1], h, top[j0:j1 + 1])
        best = torch.maximum(best, m)
        rows.append(bottom[1:])
    if top_h is None:
        return best, h
    return best, h, _bottom(left_h, rows) if a.shape[0] else top_h.clone()


def sw_affine_strip_group(a: torch.Tensor, b: torch.Tensor,
                          left_h: torch.Tensor, left_f: torch.Tensor,
                          gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND, *,
                          strip_width: int | None = None,
                          top_h: torch.Tensor | None = None,
                          top_e: torch.Tensor | None = None):
    """:func:`sw_strip_group` for affine gaps, with
    :func:`sw_affine_strip` -> (best, last H column, last F column), and
    with the row above (``top_h`` (Wtot + 1,), ``top_e`` (Wtot,)) also the
    bottom rows (bottom_h (Wtot + 1,), bottom_e (Wtot,))."""
    _check_top_len(b, top_h, top_e)
    banded = top_h is not None
    if banded != (top_e is not None):
        raise ValueError("top_h and top_e come together")
    th, te = ((top_h, top_e) if banded
              else default_top(b.shape[0], True, a.device))
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    h, f, rows_h, rows_e = left_h, left_f, [], []
    for j0, j1 in _strip_bounds(b, strip_width):
        m, h, f, bh, be = sw_affine_strip(a, b[j0:j1], h, f, gap_open,
                                          gap_extend, th[j0:j1 + 1],
                                          te[j0:j1])
        best = torch.maximum(best, m)
        rows_h.append(bh[1:])
        rows_e.append(be)
    if not banded:
        return best, h, f
    if not a.shape[0]:
        return best, h, f, top_h.clone(), top_e.clone()
    return best, h, f, _bottom(left_h, rows_h), torch.cat(rows_e)


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL_NAME, KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sw_long_group_launch.argtypes = [p, i, p, i, i, p, p, p, p, p, p, p,
                                         p]
    lib.sw_long_group_launch.restype = i
    lib.sw_affine_long_group_launch.argtypes = [p, i, p, i, i, p, p, p, p, p,
                                                p, p, p, p, p, p, p, i, i, p]
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


def _check_top(a: torch.Tensor, Wtot: int,
               rows: tuple[torch.Tensor | None, ...]) -> None:
    """Raise on band rows the kernel does not take: top_h (Wtot + 1,) and,
    affine, top_e (Wtot,), contiguous int32 on a's device, all or none."""
    if all(r is None for r in rows):
        return
    if any(r is None for r in rows):
        raise ValueError("top_h and top_e come together")
    for k, r in enumerate(rows):
        n = Wtot + 1 if k == 0 else Wtot
        if (r.device != a.device or r.dtype != torch.int32 or r.dim() != 1
                or not r.is_contiguous() or r.shape[0] != n):
            raise ValueError(f"top row {k} must be a contiguous ({n},) int32 "
                             f"tensor on {a.device}, got {r.dtype} "
                             f"{tuple(r.shape)} on {r.device}")


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
                  *, strip_width: int | None = None,
                  top_h: torch.Tensor | None = None):
    """:func:`sw_strip_group` by the CUDA kernel, on the current stream:
    b's columns in strips of ``strip_width`` (None: one strip), all swept
    by one launch. With ``top_h`` the kernel takes the band's row above
    and also returns its bottom row."""
    W = _check_group(a, b, (left_h,), strip_width)
    M, Wtot = a.shape[0], b.shape[0]
    _check_top(a, Wtot, (top_h,))
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    if M == 0 or Wtot == 0:
        if top_h is None:
            return best, left_h.clone()
        return best, left_h.clone(), top_h.clone()
    right_h = torch.empty_like(left_h)
    bottom_h = None if top_h is None else torch.empty_like(top_h)
    (buf_h,), flags = _group_scratch(M, W, Wtot, 1, a.device)
    with torch.cuda.device(a.device):
        _launch(_kernel_lib().sw_long_group_launch, "sw_long",
                a.data_ptr(), M, b.data_ptr(), W, Wtot, left_h.data_ptr(),
                right_h.data_ptr(), _ptr(top_h), _ptr(bottom_h), _ptr(buf_h),
                flags.data_ptr(), best.data_ptr(),
                torch.cuda.current_stream(a.device).cuda_stream)
    sw_strip_cuda.launches += 1
    if top_h is None:
        return best, right_h
    return best, right_h, bottom_h


sw_strip_cuda.launches = 0


def sw_affine_strip_cuda(a: torch.Tensor, b: torch.Tensor,
                         left_h: torch.Tensor, left_f: torch.Tensor,
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND, *,
                         strip_width: int | None = None,
                         top_h: torch.Tensor | None = None,
                         top_e: torch.Tensor | None = None):
    """:func:`sw_affine_strip_group` by the CUDA kernel, on the current
    stream, in one launch; with the band's row above (``top_h``,
    ``top_e``) it also returns the bottom rows."""
    W = _check_group(a, b, (left_h, left_f), strip_width)
    if gap_open > 0 or gap_extend > 0:
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    M, Wtot = a.shape[0], b.shape[0]
    _check_top(a, Wtot, (top_h, top_e))
    banded = top_h is not None
    best = torch.zeros((), dtype=torch.int32, device=a.device)
    if M == 0 or Wtot == 0:
        if not banded:
            return best, left_h.clone(), left_f.clone()
        return (best, left_h.clone(), left_f.clone(), top_h.clone(),
                top_e.clone())
    right_h = torch.empty_like(left_h)
    right_f = torch.empty_like(left_f)
    bottom_h = torch.empty_like(top_h) if banded else None
    bottom_e = torch.empty_like(top_e) if banded else None
    (buf_h, buf_f), flags = _group_scratch(M, W, Wtot, 2, a.device)
    with torch.cuda.device(a.device):
        _launch(_kernel_lib().sw_affine_long_group_launch, "sw_long affine",
                a.data_ptr(), M, b.data_ptr(), W, Wtot, left_h.data_ptr(),
                left_f.data_ptr(), right_h.data_ptr(), right_f.data_ptr(),
                _ptr(top_h), _ptr(top_e), _ptr(bottom_h), _ptr(bottom_e),
                _ptr(buf_h), _ptr(buf_f), flags.data_ptr(), best.data_ptr(),
                int(gap_open), int(gap_extend),
                torch.cuda.current_stream(a.device).cuda_stream)
    sw_affine_strip_cuda.launches += 1
    if not banded:
        return best, right_h, right_f
    return best, right_h, right_f, bottom_h, bottom_e


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


def band_bounds(M: int, C: int) -> list[tuple[int, int]]:
    """(r0, r1) of C nearly equal row bands of M rows (sizes differ by at
    most one). Raises ValueError when a band would be empty (M < C)."""
    if C > M:
        raise ValueError(f"{C} row bands of a {M}-row sequence: a band would "
                         f"be empty; use fewer devices on the seq axis")
    return [(c * M // C, (c + 1) * M // C) for c in range(C)]


@dataclass(frozen=True)
class SweepPlan:
    """The geometry of one host loop: ``bounds`` the (r0, r1) row bands,
    ``width`` the strip width W, ``n_cols`` b's columns padded to
    ``WIDTH_MULTIPLE``, ``groups`` the (s0, s1) strip ranges of each
    group. Stage s runs group s - c of band c."""

    bounds: list
    width: int
    n_cols: int
    n_strips: int
    strips_per_group: int
    groups: list

    @property
    def stages(self) -> int:
        return len(self.groups) + len(self.bounds) - 1

    def group_cols(self, g: int) -> int:
        """The columns of b that group g sweeps (its last strip may be
        narrower)."""
        s0, s1 = self.groups[g]
        return min(s1 * self.width, self.n_cols) - s0 * self.width


def sweep_plan(M: int, N: int, n_bands: int, strip_width: int, affine: bool,
               strips_per_group: int | None = None) -> SweepPlan:
    """The geometry :func:`_sweep` runs an M x N pair in: ``n_bands`` row
    bands (:func:`band_bounds`), strips of ``strip_width`` columns (at most
    the padded b), ``strips_per_group`` strips a group (None:
    :func:`group_strips` at the tallest band's rows)."""
    bounds = band_bounds(M, n_bands)
    n_cols = -(-N // WIDTH_MULTIPLE) * WIDTH_MULTIPLE
    W = min(strip_width, n_cols)
    n_strips = -(-n_cols // W)
    per_group = strips_per_group or group_strips(
        max(r1 - r0 for r0, r1 in bounds), affine)
    groups = [(s0, min(s0 + per_group, n_strips))
              for s0 in range(0, n_strips, per_group)]
    return SweepPlan(bounds, W, n_cols, n_strips, per_group, groups)


def band_handoff_bytes(cols: int, affine: bool) -> int:
    """Bytes one band hands the next for a group of ``cols`` columns: the
    bottom H row with its corner (cols + 1 int32, the length
    :func:`default_top` gives a top row) and, affine, the E row (cols
    int32)."""
    return 4 * (cols + 1) + (4 * cols if affine else 0)


def _sweep(affine: bool, seq_a, seq_b, devices: list,
           strip_width: int, progress, gap_args: tuple = (),
           strips_per_group: int | None = None) -> int:
    """The host loop: the rows of a cut into one band per device of
    ``devices`` (:func:`band_bounds`); band c holds its rows of a, b
    (padded with PAD_B to a multiple of WIDTH_MULTIPLE), its carried
    column(s) and its best on its device. b is swept in groups of
    ``strips_per_group`` strips of W columns (None: :func:`group_strips`);
    each group takes the carried column(s) and hands on its last column(s).
    Stage s runs group s - c of every band c that has one, so band c takes
    group g once band c - 1 has handed it the bottom row(s) of group g;
    band 0 starts from the true top edge (:func:`default_top`). One band
    passes no top row, so its groups take the unbanded kernel. The best
    stays on the devices until the one read at the end."""
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
    devs = list(devices)
    plan = sweep_plan(M, N, len(devs), strip_width, affine, strips_per_group)
    bounds, W, groups = plan.bounds, plan.width, plan.groups
    bp = np.full(plan.n_cols, PAD_B, np.uint8)
    bp[:N] = b_np
    fn = strip_best(affine, devs[0])
    bands = []
    for (r0, r1), dev in zip(bounds, devs):
        cols = [torch.zeros(r1 - r0, dtype=torch.int32, device=dev)]
        if affine:
            cols.append(torch.full((r1 - r0,), NEG, dtype=torch.int32,
                                   device=dev))
        bands.append({
            "a": torch.from_numpy(a_np[r0:r1].copy()).to(dev),
            "b": torch.from_numpy(bp).to(dev), "cols": cols,
            "best": torch.zeros((), dtype=torch.int32, device=dev),
            "tops": {},  # group -> the row(s) above, from the band above
        })
    C, K = len(bands), len(groups)
    name = ("sw-affine-long" if affine else "sw-long") + (
        "-sharded" if C > 1 else "")
    for s in range(K + C - 1):
        for c in range(max(0, s - K + 1), min(C, s + 1)):
            g, band = s - c, bands[c]
            s0, s1 = groups[g]
            cols_b = band["b"][s0 * W:s1 * W]
            if C == 1:
                top = ()
            elif c == 0:
                top = default_top(cols_b.shape[0], affine, devs[c])
            else:
                top = band["tops"].pop(g)
            tops = dict(zip(("top_h", "top_e"), top))
            group_max, *out = fn(band["a"], cols_b, *band["cols"], *gap_args,
                                 strip_width=W, **tops)
            n_cols = 2 if affine else 1
            band["cols"], bottom = out[:n_cols], out[n_cols:]
            band["best"] = torch.maximum(band["best"], group_max)
            if c + 1 < C:
                bands[c + 1]["tops"][g] = tuple(
                    x.to(devs[c + 1], non_blocking=True) for x in bottom)
        if progress:
            progress(f"  {name} stage {s + 1}/{K + C - 1} (cols "
                     f"{groups[max(0, s - C + 1)][0] * W}-"
                     f"{min(groups[min(s, K - 1)][1] * W, N)})")
    return int(collectives.merge_max([band["best"] for band in bands]))


def sw_score_long(seq_a, seq_b, device: torch.device,
                  strip_width: int = DEFAULT_STRIP_WIDTH,
                  progress=None, strips_per_group: int | None = None) -> int:
    """Exact linear-gap SW score of ONE pair of any length by column
    strips on ``device``. seq_a/seq_b: ASCII bytes, str or uint8 arrays;
    rows run along seq_a (pass the longer side as seq_a: each strip's
    blocks pipeline down the rows)."""
    return _sweep(False, seq_a, seq_b, [device], strip_width, progress,
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
    return _sweep(True, seq_a, seq_b, [device], strip_width, progress,
                  (gap_open, gap_extend), strips_per_group)


# ---------------------------------------------------------------------------
# Row bands on a device mesh
# ---------------------------------------------------------------------------


def sw_score_long_sharded(seq_a, seq_b, mesh, axis: str = "seq",
                          strip_width: int = DEFAULT_STRIP_WIDTH,
                          progress=None,
                          strips_per_group: int | None = None) -> int:
    """Exact linear-gap SW of ONE long pair on a device mesh: the rows of
    seq_a cut into bands over the mesh's ``axis``, each band swept by
    column strips, bands pipelined by stage. Equals :func:`sw_score_long`."""
    return _sweep(False, seq_a, seq_b, mesh.axis_devices(axis), strip_width,
                  progress, strips_per_group=strips_per_group)


def sw_affine_score_long_sharded(seq_a, seq_b, mesh, axis: str = "seq",
                                 gap_open: int = GAP_OPEN,
                                 gap_extend: int = GAP_EXTEND,
                                 strip_width: int = DEFAULT_STRIP_WIDTH,
                                 progress=None,
                                 strips_per_group: int | None = None) -> int:
    """Affine (Gotoh) :func:`sw_score_long_sharded`: each band hands the
    next both H and E of its last row. Equals :func:`sw_affine_score_long`."""
    if gap_open > 0 or gap_extend > 0:
        raise ValueError(
            f"gap costs must be <= 0, got open {gap_open} extend {gap_extend}")
    return _sweep(True, seq_a, seq_b, mesh.axis_devices(axis), strip_width,
                  progress, (gap_open, gap_extend), strips_per_group)
