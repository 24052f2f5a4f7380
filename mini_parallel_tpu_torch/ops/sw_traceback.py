"""Smith-Waterman with traceback: the counterpart of
mini_parallel_tpu/ops/sw_traceback.py (linear and affine gaps).

A pair's alignment is read off a per-cell **move code** written during the
DP: linear 0=stop, 1=diag, 2=up (query gap, CIGAR I), 3=left (reference
gap, CIGAR D); affine ``hsrc | eext << 2 | fext << 3`` with H sources
stop/diag/E/F and the E/F "extended" bits. The argmax cell is the max H
over the columns 0 <= j < N, ties broken by the first anti-diagonal, then
the smallest row. Tie precedence: linear diag > up > left; affine H
prefers diag > E > F and E/F prefer extending on ties. The walk stops at
the first stop move or at the matrix edge.

Layers:
  - :func:`sw_align_numpy`, :func:`sw_affine_align_numpy`: host goldens
    (tests), with :class:`Alignment` and its CIGAR.
  - :func:`sw_moves_batch`, :func:`sw_affine_moves_batch`: the plain moves
    scans, an anti-diagonal loop over (B, M) int32 tensors; moves come out
    as (Dp, B, M) uint8 as in the JAX package.
  - :func:`sw_positions_batch`, :func:`sw_affine_positions_batch`: the plain
    walks, a descending diagonal sweep that gathers each pair's move once
    per diagonal -> (score, per-base reference positions, -1 unaligned).
  - :func:`sw_positions_batch_best`, :func:`sw_affine_positions_batch_best`:
    route by device: CPU tensors to the plain versions, CUDA tensors to the
    kernel ``csrc/sw_moves.cu`` (ops/sw_traceback_cuda.py), which fuses the
    walk. Nothing falls back from the kernel to the plain version.
  - :func:`sw_align_batch`, :func:`sw_affine_align_batch`: batched local
    alignment with CIGARs, one :class:`Alignment` a pair. The moves come
    from the plain scans on CPU tensors, as (B, M, N) cell codes walked by
    :func:`traceback_host` / :func:`traceback_affine_host`; on CUDA tensors
    from the kernel, its moves written out (``return_moves``), and the
    host walks the fetched moves words themselves
    (:func:`traceback_words_host`), decoding only the cells it visits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mini_parallel_tpu_torch.ops import sw_traceback_cuda
from mini_parallel_tpu_torch.ops.encode import PAD_B
from mini_parallel_tpu_torch.ops.sw import (
    GAP_EXTEND,
    GAP_OPEN,
    GAP_PENALTY,
    MATCH_SCORE,
    MISMATCH_PENALTY,
    NEG,
)

STOP, DIAG, UP, LEFT = 0, 1, 2, 3
E_SRC, F_SRC = 2, 3  # affine H sources (STOP and DIAG shared with linear)
WALK_UNROLL = 4  # the moves tensor's diagonal count is padded to a multiple


@dataclass
class Alignment:
    score: int
    # 0-based inclusive start, exclusive end, in query (a) / reference (b)
    query_start: int
    query_end: int
    ref_start: int
    ref_end: int
    cigar: str

    def cigar_ops(self) -> list[tuple[int, str]]:
        out, num = [], ""
        for ch in self.cigar:
            if ch.isdigit():
                num += ch
            else:
                out.append((int(num), ch))
                num = ""
        return out


def _as_u8(s) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    return np.frombuffer(bytes(s), np.uint8)


def _rle(ops: str) -> str:
    if not ops:
        return ""
    out = []
    cur, count = ops[0], 1
    for ch in ops[1:]:
        if ch == cur:
            count += 1
        else:
            out.append(f"{count}{cur}")
            cur, count = ch, 1
    out.append(f"{count}{cur}")
    return "".join(out)


def sw_align_numpy(a, b) -> Alignment:
    """Golden linear-gap scoring + traceback (host-only, tests)."""
    a, b = _as_u8(a), _as_u8(b)
    m, n = len(a), len(b)
    H = np.zeros((m + 1, n + 1), np.int64)
    move = np.zeros((m + 1, n + 1), np.uint8)
    best, bi, bj = 0, 0, 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = MATCH_SCORE if a[i - 1] == b[j - 1] else MISMATCH_PENALTY
            diag = H[i - 1, j - 1] + s
            up = H[i - 1, j] + GAP_PENALTY
            left = H[i, j - 1] + GAP_PENALTY
            h = max(0, diag, up, left)
            H[i, j] = h
            if h == 0:
                move[i, j] = STOP
            elif h == diag:
                move[i, j] = DIAG
            elif h == up:
                move[i, j] = UP
            else:
                move[i, j] = LEFT
            if h > best or (h == best and h > 0
                            and (i + j, i) < (bi + bj, bi)):
                best, bi, bj = h, i, j
    ops = []
    i, j = bi, bj
    while i > 0 and j > 0 and move[i, j] != STOP:
        mv = move[i, j]
        if mv == DIAG:
            ops.append("M")
            i, j = i - 1, j - 1
        elif mv == UP:
            ops.append("I")
            i -= 1
        else:
            ops.append("D")
            j -= 1
    return Alignment(
        score=int(best), query_start=i, query_end=bi, ref_start=j, ref_end=bj,
        cigar=_rle("".join(reversed(ops))),
    )


def sw_affine_align_numpy(a, b, gap_open: int | None = None,
                          gap_extend: int | None = None,
                          match: int = MATCH_SCORE,
                          mismatch: int = MISMATCH_PENALTY) -> Alignment:
    """Golden Gotoh scoring + traceback (host-only, tests), with the tie
    conventions of :func:`sw_affine_moves_batch`."""
    gap_open = GAP_OPEN if gap_open is None else gap_open
    gap_extend = GAP_EXTEND if gap_extend is None else gap_extend
    a, b = _as_u8(a), _as_u8(b)
    m, n = len(a), len(b)
    neg = -(10**9)
    H = np.zeros((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), neg, np.int64)
    F = np.full((m + 1, n + 1), neg, np.int64)
    hsrc = np.zeros((m + 1, n + 1), np.uint8)
    eext = np.zeros((m + 1, n + 1), bool)
    fext = np.zeros((m + 1, n + 1), bool)
    best, bi, bj = 0, 0, 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = match if a[i - 1] == b[j - 1] else mismatch
            e_open = H[i, j - 1] + gap_open
            eext[i, j] = E[i, j - 1] >= e_open
            E[i, j] = max(E[i, j - 1], e_open) + gap_extend
            f_open = H[i - 1, j] + gap_open
            fext[i, j] = F[i - 1, j] >= f_open
            F[i, j] = max(F[i - 1, j], f_open) + gap_extend
            diag = H[i - 1, j - 1] + s
            h = max(0, diag, E[i, j], F[i, j])
            H[i, j] = h
            if h <= 0:
                hsrc[i, j] = STOP
            elif h == diag:
                hsrc[i, j] = DIAG
            elif h == E[i, j]:
                hsrc[i, j] = E_SRC
            else:
                hsrc[i, j] = F_SRC
            if h > best or (h == best and h > 0
                            and (i + j, i) < (bi + bj, bi)):
                best, bi, bj = h, i, j
    if best <= 0:
        return Alignment(0, 0, 0, 0, 0, "")
    ops = []
    i, j, state = bi, bj, "H"
    while i > 0 and j > 0:
        if state == "H":
            src = hsrc[i, j]
            if src == STOP:
                break
            if src == DIAG:
                ops.append("M")
                i, j = i - 1, j - 1
            elif src == E_SRC:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append("D")
            state = "E" if eext[i, j] else "H"
            j -= 1
        else:
            ops.append("I")
            state = "F" if fext[i, j] else "H"
            i -= 1
    return Alignment(
        score=int(best), query_start=i, query_end=bi, ref_start=j, ref_end=bj,
        cigar=_rle("".join(reversed(ops))),
    )


# ---------------------------------------------------------------------------
# Plain moves scans. Diagonal d holds cells (i, d - i) of the M rows; the
# window w[i] = b[d - i] is a slice of the reversed, PAD_B-extended b row
# (as in ops/sw.py). Cells left of column 0 are swept too (their H is 0),
# which is what gives E its value entering column 0.
# ---------------------------------------------------------------------------


def _windows(seq_a: torch.Tensor, seq_b: torch.Tensor, steps: int):
    """(a as int32, reversed padded b, its width): the diagonal-d window
    is ``rev[:, W - M - d: W - d]`` for d < steps."""
    B, M = seq_a.shape
    dev = seq_a.device
    bp = torch.cat([
        torch.full((B, M - 1), int(PAD_B), dtype=torch.int32, device=dev),
        seq_b.to(torch.int32),
        torch.full((B, steps), int(PAD_B), dtype=torch.int32, device=dev),
    ], dim=1)
    rev = bp.flip(1)
    return seq_a.to(torch.int32), rev, rev.shape[1]


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x[:, i - 1] at row i, ``fill`` at row 0."""
    col = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([col, x[:, :-1]], dim=1)


def _track_best(h, d, i_idx, N, best, bd, bi):
    """The argmax update of one diagonal over its cells with 0 <= j < N:
    the first diagonal reaching a new max wins, the smallest row within
    it."""
    j = d - i_idx
    cand = torch.where((j >= 0) & (j < N), h, 0)
    row_best = cand.amax(dim=1)
    first = torch.where(cand == row_best[:, None], i_idx,
                        cand.shape[1]).amin(dim=1).to(torch.int32)
    better = row_best > best
    return (torch.where(better, row_best, best),
            torch.where(better, d, bd),
            torch.where(better, first, bi))


def sw_moves_batch(seq_a: torch.Tensor, seq_b: torch.Tensor):
    """Batched linear-gap scan emitting per-diagonal move codes.

    seq_a (B, M) uint8 PAD_A-padded, seq_b (B, N) uint8 PAD_B-padded.
    Returns (best (B,), bd (B,), bi (B,), moves (Dp, B, M) uint8), all
    int32 but the moves, with Dp = M + N - 1 rounded up to WALK_UNROLL;
    moves[d, p, i] is the code of cell (i, d - i)."""
    B, M = seq_a.shape
    N = seq_b.shape[1]
    dev = seq_a.device
    Dp = -(-(M + N - 1) // WALK_UNROLL) * WALK_UNROLL
    a, rev, W = _windows(seq_a, seq_b, Dp)
    i_idx = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    d1 = torch.zeros((B, M), dtype=torch.int32, device=dev)
    d2 = torch.zeros((B, M), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bd = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    moves = torch.empty((Dp, B, M), dtype=torch.uint8, device=dev)
    for d in range(Dp):
        w = rev[:, W - M - d: W - d]
        s = (a == w).to(torch.int32) * (MATCH_SCORE - MISMATCH_PENALTY) \
            + MISMATCH_PENALTY
        diag = _shift_down(d2, 0) + s
        up = _shift_down(d1, 0) + GAP_PENALTY
        left = d1 + GAP_PENALTY
        cand = torch.clamp_min(torch.maximum(torch.maximum(diag, up), left), 0)
        moves[d] = torch.where(
            cand <= 0, STOP,
            torch.where(cand == diag, DIAG, torch.where(cand == up, UP, LEFT)),
        ).to(torch.uint8)
        best, bd, bi = _track_best(cand, d, i_idx, N, best, bd, bi)
        d1, d2 = cand, d1
    return best, bd, bi, moves


def sw_affine_moves_batch(seq_a: torch.Tensor, seq_b: torch.Tensor,
                          gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND):
    """Batched Gotoh scan emitting per-diagonal move bytes ``hsrc | eext
    << 2 | fext << 3``; same layout and argmax as :func:`sw_moves_batch`.
    A gap of length L costs gap_open + L * gap_extend."""
    B, M = seq_a.shape
    N = seq_b.shape[1]
    dev = seq_a.device
    Dp = -(-(M + N - 1) // WALK_UNROLL) * WALK_UNROLL
    a, rev, W = _windows(seq_a, seq_b, Dp)
    i_idx = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    h1 = torch.zeros((B, M), dtype=torch.int32, device=dev)
    h2 = torch.zeros((B, M), dtype=torch.int32, device=dev)
    e1 = torch.full((B, M), NEG, dtype=torch.int32, device=dev)
    f1 = torch.full((B, M), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bd = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    moves = torch.empty((Dp, B, M), dtype=torch.uint8, device=dev)
    for d in range(Dp):
        w = rev[:, W - M - d: W - d]
        s = (a == w).to(torch.int32) * (MATCH_SCORE - MISMATCH_PENALTY) \
            + MISMATCH_PENALTY
        e_open = h1 + gap_open
        e_ext = e1 >= e_open  # ties extend
        e = torch.maximum(e1, e_open) + gap_extend
        f_prev_f = _shift_down(f1, NEG)
        f_open = _shift_down(h1, 0) + gap_open
        f_ext = f_prev_f >= f_open
        f = torch.maximum(f_prev_f, f_open) + gap_extend
        diag = _shift_down(h2, 0) + s
        h = torch.maximum(torch.clamp_min(diag, 0), torch.maximum(e, f))
        h_src = torch.where(
            h <= 0, STOP,
            torch.where(h == diag, DIAG, torch.where(h == e, E_SRC, F_SRC)))
        moves[d] = (h_src | (e_ext.to(torch.int32) << 2)
                    | (f_ext.to(torch.int32) << 3)).to(torch.uint8)
        best, bd, bi = _track_best(h, d, i_idx, N, best, bd, bi)
        h1, h2, e1, f1 = h, h1, e, f
    return best, bd, bi, moves


def plain_moves_to_cells(moves: torch.Tensor, N: int) -> torch.Tensor:
    """The plain scans' (Dp, B, M) moves -> (B, M, N): cell (i, j) is
    moves[i + j, p, i] (the layout the kernel's moves are compared in)."""
    Dp, B, M = moves.shape
    dev = moves.device
    d = (torch.arange(M, device=dev)[:, None]
         + torch.arange(N, device=dev)[None, :])  # (M, N)
    rows = torch.arange(M, device=dev)[:, None].expand(M, N)
    return moves.permute(1, 0, 2)[:, d, rows]


# ---------------------------------------------------------------------------
# Plain walks. Every action strictly lowers the walker's anti-diagonal
# qi + ji, so sweeping d = Dp-1 .. 0 and letting each pair act only when
# qi + ji == d visits every action once; each step gathers the pair's move
# from the diagonal's (B, M) slab.
# ---------------------------------------------------------------------------


def _walk_move(moves: torch.Tensor, d: int, qi: torch.Tensor):
    """(the move of each pair's cell (qi, d - qi), qi as a gather column)."""
    col = qi.clamp(0, moves.shape[2] - 1).to(torch.int64)[:, None]
    return moves[d].gather(1, col)[:, 0].to(torch.int32), col


def _set_positions(pos, col, hit, ji) -> None:
    """pos[p, col[p]] = ji[p] where hit[p] (a scatter, no host sync)."""
    keep = pos.gather(1, col)[:, 0]
    pos.scatter_(1, col, torch.where(hit, ji, keep)[:, None])


def _positions_walk(best, bd, bi, moves):
    """Linear walk -> positions (B, M) int32: the reference index of each
    query base on a DIAG step of the best alignment, -1 elsewhere."""
    Dp, B, M = moves.shape
    dev = moves.device
    qi, ji = bi.clone(), bd - bi
    done = best <= 0
    pos = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    for d in range(Dp - 1, -1, -1):
        mv, col = _walk_move(moves, d, qi)
        active = (~done) & (qi + ji == d) & (qi >= 0) & (ji >= 0)
        act = torch.where(active, mv, STOP)
        is_diag = act == DIAG
        _set_positions(pos, col, is_diag, ji)
        qi = qi - is_diag.to(torch.int32) - (act == UP).to(torch.int32)
        ji = ji - is_diag.to(torch.int32) - (act == LEFT).to(torch.int32)
        done = done | (active & (mv == STOP))
    return pos


def _affine_walk(best, bd, bi, moves):
    """Gotoh walk -> positions: the 3-state machine (H / E / F) that fuses
    each H->E (H->F) switch with the D (I) step it mandates, taking the
    current cell's extend bit as the next state."""
    Dp, B, M = moves.shape
    dev = moves.device
    S_H, S_E, S_F = 0, 1, 2
    qi, ji = bi.clone(), bd - bi
    state = torch.zeros(B, dtype=torch.int32, device=dev)
    done = best <= 0
    pos = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    for d in range(Dp - 1, -1, -1):
        mv, col = _walk_move(moves, d, qi)
        active = (~done) & (qi + ji == d) & (qi >= 0) & (ji >= 0)
        src = mv & 3
        eext = ((mv >> 2) & 1) == 1
        fext = ((mv >> 3) & 1) == 1
        in_h = active & (state == S_H)
        h_diag = in_h & (src == DIAG)
        emit_d = (in_h & (src == E_SRC)) | (active & (state == S_E))
        emit_i = (in_h & (src == F_SRC)) | (active & (state == S_F))
        _set_positions(pos, col, h_diag, ji)
        state = torch.where(
            h_diag, S_H,
            torch.where(emit_d, torch.where(eext, S_E, S_H),
                        torch.where(emit_i, torch.where(fext, S_F, S_H),
                                    state))).to(torch.int32)
        qi = qi - h_diag.to(torch.int32) - emit_i.to(torch.int32)
        ji = ji - h_diag.to(torch.int32) - emit_d.to(torch.int32)
        done = done | (in_h & (src == STOP))
    return pos


def sw_positions_batch(seq_a: torch.Tensor, seq_b: torch.Tensor):
    """Plain traceback -> (score (B,) int32, positions (B, M) int32):
    positions[p, i] is the 0-based index in seq_b that query base i aligns
    to under the best local alignment (M ops only), -1 for unaligned,
    inserted or clipped bases."""
    best, bd, bi, moves = sw_moves_batch(seq_a, seq_b)
    return best, _positions_walk(best, bd, bi, moves)


def sw_affine_positions_batch(seq_a: torch.Tensor, seq_b: torch.Tensor,
                              gap_open: int = GAP_OPEN,
                              gap_extend: int = GAP_EXTEND):
    """Plain Gotoh traceback -> (score, positions), as
    :func:`sw_positions_batch`."""
    best, bd, bi, moves = sw_affine_moves_batch(seq_a, seq_b, gap_open,
                                                gap_extend)
    return best, _affine_walk(best, bd, bi, moves)


def sw_positions_batch_best(seq_a: torch.Tensor, seq_b: torch.Tensor):
    """(score, positions) on the operands' device: the plain version for
    CPU tensors, the CUDA kernel (or an error) for anything else."""
    if seq_a.device.type == "cpu" and seq_b.device.type == "cpu":
        return sw_positions_batch(seq_a, seq_b)
    best, _, _, positions = sw_traceback_cuda.sw_moves_batch_cuda(seq_a, seq_b)
    return best, positions


def sw_affine_positions_batch_best(seq_a: torch.Tensor, seq_b: torch.Tensor,
                                   gap_open: int = GAP_OPEN,
                                   gap_extend: int = GAP_EXTEND):
    """Affine (score, positions) on the operands' device (see
    :func:`sw_positions_batch_best`)."""
    if seq_a.device.type == "cpu" and seq_b.device.type == "cpu":
        return sw_affine_positions_batch(seq_a, seq_b, gap_open, gap_extend)
    best, _, _, positions = sw_traceback_cuda.sw_affine_moves_batch_cuda(
        seq_a, seq_b, gap_open, gap_extend)
    return best, positions


# ---------------------------------------------------------------------------
# Batched CIGAR alignment: device moves, host walk. The walk reads cell
# (i, j)'s code from the plain cells or from the kernel's moves words; its
# tie rules are the goldens' (linear DIAG > UP > LEFT; affine H prefers
# DIAG > E > F, E and F extend on ties, which the scans already fixed in
# the codes).
# ---------------------------------------------------------------------------


def _walk(best, bd, bi, code, step) -> list[Alignment]:
    """One host walk per pair: ``code(p, i, j)`` reads cell (i, j)'s move
    code of pair p; ``step(mv, state)`` -> (op or None to stop, qi step,
    ji step, next state)."""
    out = []
    for p in range(len(best)):
        score = int(best[p])
        if score <= 0:
            out.append(Alignment(0, 0, 0, 0, 0, ""))
            continue
        i = int(bi[p])
        j = int(bd[p]) - i
        qi, ji, state = i, j, "H"
        ops = []
        while qi >= 0 and ji >= 0:
            op, di, dj, state = step(code(p, qi, ji), state)
            if op is None:
                break
            if op:
                ops.append(op)
            qi -= di
            ji -= dj
        out.append(Alignment(score=score, query_start=qi + 1,
                             query_end=i + 1, ref_start=ji + 1,
                             ref_end=j + 1,
                             cigar=_rle("".join(reversed(ops)))))
    return out


def _cell_codes(cells: np.ndarray):
    _, M, N = cells.shape
    flat = memoryview(np.ascontiguousarray(cells, np.uint8).reshape(-1))
    return lambda p, i, j: flat[(p * M + i) * N + j]


def _word_codes(words: np.ndarray, M: int, N: int, affine: bool):
    """Cell (i, j)'s code of pair p read from the kernel's moves words by
    the arithmetic of sw_traceback_cuda.moves_layout (the per-cell form
    of its ``moves_to_cells``)."""
    R, P, codes, W = sw_traceback_cuda.moves_layout(M, N, affine)
    bits = 32 // codes
    mask = (1 << bits) - 1
    per_pair, stripe_words = words.shape[1], W * 32 * P
    flat = memoryview(np.ascontiguousarray(words, np.int32).reshape(-1))

    def code(p: int, i: int, j: int) -> int:
        stripe, rem = divmod(i, 32 * R)
        lane, r = divmod(rem, R)
        t = j + lane
        word = flat[p * per_pair + stripe * stripe_words
                    + t // codes * 32 * P + lane * P + r]
        # int32 words shift in their sign, but the mask keeps the code
        return (word >> bits * (t % codes)) & mask

    return code


def _linear_step(mv: int, state: str):
    if mv == STOP:
        return None, 0, 0, state
    if mv == DIAG:
        return "M", 1, 1, state
    if mv == UP:
        return "I", 1, 0, state
    return "D", 0, 1, state


def _affine_step(mv: int, state: str):
    """The Gotoh walk's three states: in H the cell's source picks M or a
    switch to E / F (no step); in E (F) a D (I) step, staying while the
    cell's extend bit is set."""
    if state == "H":
        src = mv & 3
        if src == STOP:
            return None, 0, 0, state
        if src == DIAG:
            return "M", 1, 1, "H"
        return "", 0, 0, "E" if src == E_SRC else "F"
    if state == "E":
        return "D", 0, 1, "E" if (mv >> 2) & 1 else "H"
    return "I", 1, 0, "F" if (mv >> 3) & 1 else "H"


def traceback_host(best, bd, bi, cells: np.ndarray) -> list[Alignment]:
    """Walk linear-gap cell codes (B, M, N) to one :class:`Alignment` a
    pair; best/bd/bi as the scans give them. A pair whose score is <= 0
    gives ``Alignment(0, 0, 0, 0, 0, "")``."""
    return _walk(best, bd, bi, _cell_codes(cells), _linear_step)


def traceback_affine_host(best, bd, bi, cells: np.ndarray
                          ) -> list[Alignment]:
    """Walk affine cell bytes (``hsrc | eext << 2 | fext << 3``) to one
    :class:`Alignment` a pair, as :func:`traceback_host`."""
    return _walk(best, bd, bi, _cell_codes(cells), _affine_step)


def traceback_words_host(best, bd, bi, words: np.ndarray, M: int, N: int,
                         affine: bool) -> list[Alignment]:
    """:func:`traceback_host` (:func:`traceback_affine_host` when
    ``affine``) over the moves kernel's (B, words) int32 moves words,
    fetched as they are: each step decodes the one cell it visits, so
    nothing decodes the other cells of the M x N matrix."""
    return _walk(best, bd, bi, _word_codes(words, M, N, affine),
                 _affine_step if affine else _linear_step)


def _align_batch(seq_a: torch.Tensor, seq_b: torch.Tensor, affine: bool,
                 gap_open: int, gap_extend: int) -> list[Alignment]:
    B, M = seq_a.shape
    N = seq_b.shape[1]
    if B == 0 or M == 0 or N == 0:
        return [Alignment(0, 0, 0, 0, 0, "") for _ in range(B)]
    if seq_a.device.type == "cpu" and seq_b.device.type == "cpu":
        best, bd, bi, moves = (
            sw_affine_moves_batch(seq_a, seq_b, gap_open, gap_extend)
            if affine else sw_moves_batch(seq_a, seq_b))
        walk = traceback_affine_host if affine else traceback_host
        return walk(best.numpy(), bd.numpy(), bi.numpy(),
                    plain_moves_to_cells(moves, N).numpy())
    best, bd, bi, _, words = (
        sw_traceback_cuda.sw_affine_moves_batch_cuda(
            seq_a, seq_b, gap_open, gap_extend, return_moves=True)
        if affine else sw_traceback_cuda.sw_moves_batch_cuda(
            seq_a, seq_b, return_moves=True))
    return traceback_words_host(best.cpu().numpy(), bd.cpu().numpy(),
                                bi.cpu().numpy(), words.cpu().numpy(), M, N,
                                affine)


def sw_align_batch(seq_a: torch.Tensor, seq_b: torch.Tensor
                   ) -> list[Alignment]:
    """Batched linear-gap local alignment with CIGARs: (B, M) uint8
    PAD_A-padded queries x (B, N) uint8 PAD_B-padded references -> one
    :class:`Alignment` a pair. The moves are computed on the operands'
    device (the plain scan for CPU tensors, the CUDA kernel or an error
    for anything else) and walked on the host."""
    return _align_batch(seq_a, seq_b, False, 0, 0)


def sw_affine_align_batch(seq_a: torch.Tensor, seq_b: torch.Tensor,
                          gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND) -> list[Alignment]:
    """Batched affine-gap (Gotoh) :func:`sw_align_batch`; a gap of length
    L costs gap_open + L * gap_extend."""
    return _align_batch(seq_a, seq_b, True, gap_open, gap_extend)
