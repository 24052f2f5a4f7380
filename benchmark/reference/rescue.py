"""Plain seed-free rescue and SAM lines for ``--variant-prep --rescue
--sam-out``, on top of reference/variant.py's mapping, alignment, pileup
and genotyping.

The semantics are those the ``ecoli_rescue`` configuration states:

- a read that no seed anchors (variant.py's ``map_reads``) is swept on both
  strands, the read as written and its reverse complement, against the
  whole joined reference (contigs and their ``SPACER`` N bases): local
  alignment with a linear gap, match +2, mismatch -1, a gap base -2, bytes
  compared as they are (N against N is a match). The sweep gives the best
  score (at least 0) and the smallest reference index of a cell at that
  score (``end``, -1 at score 0);
- the read is rescued when its better strand's score reaches
  max(1, trunc(float32(2 * min_frac) * L)); the reverse strand wins only
  when its score is strictly higher, and then the read is flipped; its
  anchor is max(0, end - L + 1);
- a rescued read is aligned, piled up and genotyped as a seed-mapped read
  anchored there (variant.py);
- the SAM line of a read gives FLAG 4, RNAME ``*``, POS 0, CIGAR ``*`` and
  the read as written when it is unmapped or no base of it aligned; else
  FLAG 16 when flipped (0 otherwise), the contig of its first aligned base,
  that base's 1-based position in the contig, the CIGAR of its aligned
  positions (:func:`cigar`) and the oriented read.

The sweep runs in plain torch on any device, in int32, a block of reads a
step (:func:`sweep`); with ``cap`` it saturates every cell at that value,
the control's narrower integers.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import variant as plain

MATCH, MISMATCH, GAP = 2, -1, -2
SAT8 = 127  # the largest score of a saturating signed 8-bit cell
BLOCK_CELLS = 1 << 28  # reads x reference cells of one sweep step


def sweep(reads: np.ndarray, ref: torch.Tensor, cap: int | None = None,
          block_cells: int = BLOCK_CELLS) -> tuple[np.ndarray, np.ndarray]:
    """(scores, ends) int64 of every row of ``reads`` (B, L) ASCII against
    the whole of ``ref`` (N,) uint8, on ``ref``'s device.

    The DP runs down the read, a row over the whole reference at a time:
    X[j] = max(0, H[i-1, j-1] + s(i, j), H[i-1, j] - 2), then the gap along
    the row, H[i, j] = max_t (X[j - t] - 2t), by doubling: after shifts of
    1, 2, 4, ... 2^(k-1) every t < 2^k is in. A read of L bases scores at
    most 2L, so no t > L can win, and k = bit_length(L) is exact."""
    B, L = reads.shape
    N = int(ref.shape[0])
    dev = ref.device
    scores = np.zeros(B, np.int64)
    ends = np.full(B, -1, np.int64)
    if B == 0 or L == 0 or N == 0:
        return scores, ends
    rows = max(1, block_cells // N)
    shifts = [1 << k for k in range(L.bit_length())]
    two = torch.tensor(MATCH, dtype=torch.int32, device=dev)
    one = torch.tensor(MISMATCH, dtype=torch.int32, device=dev)
    for lo in range(0, B, rows):
        a = torch.from_numpy(np.ascontiguousarray(reads[lo:lo + rows])).to(dev)
        b = a.shape[0]
        h = torch.zeros((b, N), dtype=torch.int32, device=dev)
        best = torch.zeros(b, dtype=torch.int32, device=dev)
        end = torch.zeros(b, dtype=torch.int64, device=dev)
        for i in range(L):
            x = torch.where(a[:, i:i + 1] == ref[None, :], two, one)
            x[:, 1:] += h[:, :-1]  # the diagonal; H[i-1, -1] = 0
            torch.maximum(x, h.add_(GAP), out=x)  # the cell above
            x.clamp_(0, cap)
            for t in shifts:
                if t >= N:
                    break
                torch.maximum(x[:, t:], x[:, :-t] + GAP * t, out=x[:, t:])
            h = x
            top = h.amax(1)
            first = (h == top[:, None]).to(torch.uint8).argmax(1)
            end = torch.where(top > best, first, torch.where(
                top == best, torch.minimum(end, first), end))
            best = torch.maximum(best, top)
        scores[lo:lo + b] = best.cpu().numpy()
        ends[lo:lo + b] = torch.where(best > 0, end, -1).cpu().numpy()
    return scores, ends


def threshold(length: int, min_frac: float) -> int:
    """The score a read of ``length`` bases needs to be rescued."""
    return max(1, int(np.float32(2.0 * min_frac) * np.float32(length)))


def cigar(pos: np.ndarray) -> tuple[str, int]:
    """(CIGAR, reference position of the first aligned base) of one read's
    per-base reference positions, -1 where a base is not aligned: unaligned
    bases before the first and after the last aligned one are soft clips
    (S), runs of consecutive positions M; between two aligned bases, the
    unaligned read bases are an insertion (I), then the skipped reference
    bases a deletion (D). ("*", -1) when no base aligned."""
    al = np.flatnonzero(pos >= 0)
    if al.size == 0:
        return "*", -1
    ops = [(int(al[0]), "S")]
    run = 1
    for k0, k1 in zip(al[:-1].tolist(), al[1:].tolist()):
        ins, dele = k1 - k0 - 1, int(pos[k1] - pos[k0]) - 1
        if ins or dele:
            ops += [(run, "M"), (ins, "I"), (dele, "D")]
            run = 0
        run += 1
    ops += [(run, "M"), (pos.size - 1 - int(al[-1]), "S")]
    return "".join(f"{n}{op}" for n, op in ops if n > 0), int(pos[al[0]])


class RescueReference(plain.VariantReference):
    """variant.py's plain pipeline with the seed-free rescue: the seed
    mapper's answers stay in ``seed_mapped``; :meth:`rescue` sweeps reads
    that no seed anchors and maps the ones it rescues (at their anchor and
    strand) for everything that follows. ``cap`` saturates the sweep."""

    def __init__(self, contigs, seqs, quals, params: dict, device,
                 cap: int | None = None):
        super().__init__(contigs, seqs, quals, params, device)
        self.seed_mapped = self.mapped.copy()
        self.cap = cap
        self.min_frac = float(params["rescue_min_frac"])
        self.swept: dict[int, tuple[int, int, int, int]] = {}
        self._ref_dev = None

    def rescue(self, rows) -> np.ndarray:
        """Sweep the reads of ``rows`` that no seed anchors and have not
        been swept, both strands; map those that clear the threshold.
        -> the rows of ``rows`` that are rescued."""
        rows = np.unique(np.asarray(rows, np.int64))
        todo = rows[~self.seed_mapped[rows]]
        todo = np.array([r for r in todo.tolist() if r not in self.swept],
                        np.int64)
        if todo.size:
            if self._ref_dev is None:
                self._ref_dev = torch.from_numpy(self.ref.copy()).to(
                    self.device)
            fwd = self.seqs[todo]
            rev = plain.COMP[fwd][:, ::-1]
            s, e = sweep(np.concatenate([fwd, rev]), self._ref_dev, self.cap)
            n = todo.size
            need = threshold(self.L, self.min_frac)
            for k, r in enumerate(todo.tolist()):
                self.swept[r] = (int(s[k]), int(e[k]), int(s[n + k]),
                                 int(e[n + k]))
                flip = s[n + k] > s[k]
                if max(s[k], s[n + k]) >= need:
                    end = e[n + k] if flip else e[k]
                    self.starts[r] = max(0, int(end) - self.L + 1)
                    self.mapped[r] = True
                    self.flipped[r] = bool(flip)
        return rows[self.mapped[rows] & ~self.seed_mapped[rows]]

    def rescued(self) -> np.ndarray:
        """Every row rescued so far."""
        return np.flatnonzero(self.mapped & ~self.seed_mapped)

    def sam_fields(self, rows) -> list[tuple]:
        """(FLAG, RNAME, POS, CIGAR, SEQ) of each row's SAM line, as the
        reads stand mapped now."""
        rows = np.asarray(rows, np.int64)
        live = rows[self.mapped[rows]]
        pos = dict(zip(live.tolist(), self.positions(live)))
        seqs, _ = self.oriented(rows)
        out = []
        for r, s in zip(rows.tolist(), seqs):
            cig, first = cigar(pos[r]) if r in pos else ("*", -1)
            if first < 0:
                out.append((4, "*", 0, "*", self.seqs[r].tobytes().decode()))
                continue
            c = self.contig_of(first)
            out.append((16 if self.flipped[r] else 0, self.names[c],
                        first - int(self.offsets[c]) + 1, cig,
                        s.tobytes().decode()))
        return out
