"""Plain variant-call prep: seed mapping, gapped affine alignment,
pileup, candidates, and Pair-HMM genotype likelihoods.

The semantics are those the ``ecoli_prep`` configuration states for
``--variant-prep --gapped --gap-model affine --genotype``:

- the reference is the contigs joined by ``SPACER`` N bases;
- a read anchors at the first of its seeds (15-mers at offsets 0, 17, 34,
  51) whose key occurs in the reference, at that key's first reference
  position minus the seed's offset (never before the reference start);
  forward seeds first, else the reverse complement's, which flips the read;
- a mapped read is aligned locally (Gotoh: match +2, mismatch -1, a gap of
  length k costs open + k * extend) against the reference window that
  starts ``MARGIN`` bases before its anchor and is 2 * MARGIN wider than
  the padded read; the best cell is the largest, first by anti-diagonal,
  then by row; the walk prefers diagonal, then E (a reference gap), then F
  (a read gap), and E and F extend on ties;
- the pileup counts, per reference position, the aligned A C G T bases, a
  deletion at the first skipped base, and an insertion at the base after
  its left anchor;
- a site is a candidate SNP when its depth >= ``min_depth`` and the
  non-reference share >= ``alt_fraction``, with the most frequent
  non-reference base (the first on ties), and a <DEL> or <INS> on the
  evidence columns by the same rule;
- genotyping takes, for each site, the first ``gt_max_reads`` mapped reads
  (in stream order) whose anchored span covers it, oriented, against the
  reference and alternate haplotypes ``gt_window`` bases either side;
  an insertion's bases are the majority, first seen on ties, of the
  covering reads' alignments (two or more), and the record moves to its
  anchor base; per-read log10 P(read | haplotype) by the Pair-HMM forward
  (gap open Phred 45, extension Phred 10, a free start and end on the
  haplotype), floored at -300, give the diploid (RR, RA, AA) log10
  likelihoods.

Everything runs on the generated inputs; the alignment and the Pair-HMM
are plain torch on any device, the rest NumPy. A check asks for the
pileup rows of some reference positions (:meth:`VariantReference.
pileup_rows`) and aligns only the reads whose windows hold them.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

SPACER = 512
SEED_K = 15
SEED_OFFSETS = (0, 17, 34, 51)
MARGIN = 16
MATCH, MISMATCH = 2, -1
NEG = -(1 << 28)
GAP_OPEN_PHRED, GAP_EXT_PHRED = 45.0, 10.0
LL_FLOOR = -300.0
LOG10_2 = float(np.log10(2.0))
STOP, DIAG, E_SRC, F_SRC = 0, 1, 2, 3
PAD_Q, PAD_W = 0xFE, 0xFF  # pads of the read and of the haplotype/window

CODE = np.full(256, 4, np.int64)
CODE[np.frombuffer(b"ACGT", np.uint8)] = [0, 1, 2, 3]
COMP = np.arange(256, dtype=np.uint8)
COMP[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)
BASES = "ACGTN"


def read_pad(length: int) -> int:
    """The padded read width: at least 152, a multiple of 8."""
    return -(-max(152, SEED_K + 1, length) // 8) * 8


class SeedIndex:
    """Each 15-mer key of the reference with its first position."""

    def __init__(self, ref: np.ndarray):
        codes = CODE[ref]
        W = codes.size - SEED_K + 1
        key = np.zeros(W, np.int64)
        ok = np.ones(W, bool)
        for m in range(SEED_K):
            c = codes[m:m + W]
            ok &= c <= 3
            key = key * 4 + np.where(c <= 3, c, 0)
        pos = np.nonzero(ok)[0]
        self.keys, first = np.unique(key[ok], return_index=True)
        self.first = pos[first]

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """The first position of each key, -1 where it does not occur."""
        i = np.searchsorted(self.keys, keys).clip(0, self.keys.size - 1)
        return np.where(self.keys[i] == keys, self.first[i], -1)


def seed_keys(codes: np.ndarray, at: int) -> tuple[np.ndarray, np.ndarray]:
    """(big-endian key, clean) of the 15-mer at column ``at`` of each row."""
    win = codes[:, at:at + SEED_K]
    clean = (win <= 3).all(1)
    key = (np.where(win <= 3, win, 0) * (4 ** np.arange(SEED_K - 1, -1, -1))
           ).sum(1)
    return key, clean


def map_reads(seqs: np.ndarray, index: SeedIndex, block: int = 1 << 17):
    """(starts, mapped, flipped) of every read (rows of ASCII, all of one
    length): forward seeds first, then the reverse complement's."""
    R, L = seqs.shape
    starts = np.full(R, -1, np.int64)
    mapped = np.zeros(R, bool)
    flipped = np.zeros(R, bool)
    for lo in range(0, R, block):
        codes = CODE[seqs[lo:lo + block]]
        rc = np.where(codes <= 3, 3 - codes, codes)[:, ::-1]
        found = []
        for strand in (codes, rc):
            start = np.full(codes.shape[0], -1, np.int64)
            for o in SEED_OFFSETS[::-1]:  # the first hit wins
                if o + SEED_K > L:
                    continue
                key, clean = seed_keys(strand, o)
                first = index.lookup(key)
                hit = clean & (first >= 0) & (first - o >= 0)
                start = np.where(hit, first - o, start)
            found.append(start)
        fwd, rev = found
        use_rc = (fwd < 0) & (rev >= 0)
        starts[lo:lo + block] = np.where(fwd >= 0, fwd, rev)
        mapped[lo:lo + block] = (fwd >= 0) | (rev >= 0)
        flipped[lo:lo + block] = use_rc
    return starts, mapped, flipped


def affine_positions(q: torch.Tensor, w: torch.Tensor, gap_open: int,
                     gap_extend: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Local Gotoh alignment of each row of ``q`` (B, M) against ``w``
    (B, N), both int32 byte values with distinct pads: (best (B,), the
    window column of each read base on a diagonal step of the best
    alignment, else -1 (B, M))."""
    B, M = q.shape
    N = w.shape[1]
    dev = q.device
    i = torch.arange(M, device=dev)[None, :]
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    h1 = torch.zeros((B, M), dtype=torch.int32, device=dev)
    h2 = torch.zeros_like(h1)
    e1 = torch.full((B, M), NEG, dtype=torch.int32, device=dev)
    f1 = torch.full((B, M), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bd = torch.zeros(B, dtype=torch.int64, device=dev)
    bi = torch.zeros(B, dtype=torch.int64, device=dev)
    D = M + N - 1
    moves = torch.empty((D, B, M), dtype=torch.uint8, device=dev)
    for d in range(D):
        j = d - i
        left_of = j < 0
        wj = w.gather(1, j.clamp(0, N - 1).expand(B, M))
        s = torch.where(q == wj, MATCH, MISMATCH)
        e_open = h1 + gap_open  # from (i, j-1)
        eext = e1 >= e_open
        e = torch.maximum(e1, e_open) + gap_extend
        f_up = torch.cat([neg_col, f1[:, :-1]], 1)  # from (i-1, j)
        f_open = torch.cat([zero_col, h1[:, :-1]], 1) + gap_open
        fext = f_up >= f_open
        f = torch.maximum(f_up, f_open) + gap_extend
        diag = torch.cat([zero_col, h2[:, :-1]], 1) + s
        h = torch.maximum(torch.maximum(diag, e), torch.maximum(f, zero_col))
        src = torch.where(h <= 0, STOP, torch.where(
            h == diag, DIAG, torch.where(h == e, E_SRC, F_SRC)))
        # column -1 of the DP: H 0, E and F minus infinity
        h = torch.where(left_of, 0, h)
        e = torch.where(left_of, NEG, e)
        f = torch.where(left_of, NEG, f)
        moves[d] = (src | (eext.to(torch.int32) << 2)
                    | (fext.to(torch.int32) << 3)).to(torch.uint8)
        cand = torch.where((j >= 0) & (j < N), h, 0)
        top = cand.amax(1)
        first = torch.where(cand == top[:, None], i, M).amin(1)
        better = top > best
        best = torch.where(better, top, best)
        bd = torch.where(better, d, bd)
        bi = torch.where(better, first, bi)
        h1, h2, e1, f1 = h, h1, e, f
    return best, _walk(best, bd, bi, moves)


def _walk(best, bd, bi, moves) -> torch.Tensor:
    """The traceback from each best cell: in H, a diagonal step aligns the
    read base (i) to column j; E emits a reference gap (j - 1), F a read
    gap (i - 1), each keeping its state while the cell's extend bit is
    set. Ends at a stop cell or the matrix edge."""
    D, B, M = moves.shape
    dev = moves.device
    rows = torch.arange(B, device=dev)
    qi, ji = bi.clone(), bd - bi
    state = torch.zeros(B, dtype=torch.int64, device=dev)  # 0 H, 1 E, 2 F
    live = best > 0
    pos = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    for _ in range(2 * D + 2):
        live = live & (qi >= 0) & (ji >= 0)
        if not bool(live.any()):
            break
        code = moves[(qi + ji).clamp(0, D - 1), rows,
                     qi.clamp(0, M - 1)].to(torch.int64)
        src, eext, fext = code & 3, (code >> 2) & 1, (code >> 3) & 1
        in_h = live & (state == 0)
        step_d = in_h & (src == DIAG)
        emit_e = live & (((state == 0) & (src == E_SRC)) | (state == 1))
        emit_f = live & (((state == 0) & (src == F_SRC)) | (state == 2))
        live = live & ~(in_h & (src == STOP))
        hit = rows[step_d]
        pos[hit, qi[step_d]] = ji[step_d].to(torch.int32)
        state = torch.where(emit_e, eext, torch.where(
            emit_f, 2 * fext, torch.where(step_d, 0, state)))
        qi = qi - step_d.to(torch.int64) - emit_f.to(torch.int64)
        ji = ji - step_d.to(torch.int64) - emit_e.to(torch.int64)
    return pos


def pairhmm_log10(reads: torch.Tensor, err: torch.Tensor, haps: torch.Tensor,
                  rlen: torch.Tensor, hlen: torch.Tensor,
                  dtype: torch.dtype = torch.float64,
                  scale_log2: float = 0.0) -> torch.Tensor:
    """(B,) log10 P(read | hap) by the forward algorithm over the
    anti-diagonals of the (read, hap) matrix, computed in ``dtype`` with
    the boundary row scaled by 2**scale_log2 (-inf where it underflows).
    reads and haps are int32 byte values with distinct pads; err is each
    read base's error probability."""
    B, M = reads.shape
    N = haps.shape[1]
    dev = reads.device
    delta = 10.0 ** (-GAP_OPEN_PHRED / 10.0)
    eps = 10.0 ** (-GAP_EXT_PHRED / 10.0)
    tMM, tGO, tGE, tGM = 1.0 - 2.0 * delta, delta, eps, 1.0 - eps
    i = torch.arange(M + 1, device=dev)[None, :]
    e = torch.cat([torch.zeros((B, 1), dtype=torch.float64, device=dev),
                   err.to(torch.float64)], 1)
    hit = (1.0 - e).to(dtype)
    miss = (e / 3.0).to(dtype)
    rd = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev),
                    reads], 1)
    init = (2.0 ** scale_log2 / hlen.to(torch.float64))[:, None].to(dtype)
    zero = torch.zeros((B, M + 1), dtype=dtype, device=dev)
    zc = torch.zeros((B, 1), dtype=dtype, device=dev)
    m1, i1, d1 = zero, zero, torch.where(i == 0, init, zero)  # diagonal 0
    m2, i2, d2 = zero, zero, zero
    total = torch.zeros(B, dtype=dtype, device=dev)
    m_row = rlen.to(torch.int64)[:, None]

    def down(x):
        return torch.cat([zc, x[:, :-1]], 1)

    for d in range(1, M + N + 1):
        j = d - i
        inner = (i >= 1) & (j >= 1) & (j <= N)
        hj = haps.gather(1, (j - 1).clamp(0, N - 1).expand(B, M + 1))
        prior = torch.where(rd == hj, hit, miss)
        m = prior * (tMM * down(m2) + tGM * down(i2) + tGM * down(d2))
        ins = tGO * down(m1) + tGE * down(i1)
        dl = tGO * m1 + tGE * d1
        m = torch.where(inner, m, zero)
        ins = torch.where(inner, ins, zero)
        dl = torch.where(inner, dl, torch.where((i == 0) & (j >= 1) & (j <= N),
                                                init, zero))
        jm = d - m_row[:, 0]
        last = (jm >= 1) & (jm <= hlen.to(torch.int64))
        at = m.gather(1, m_row) + ins.gather(1, m_row)
        total = total + torch.where(last, at[:, 0], torch.zeros_like(total))
        m2, i2, d2, m1, i1, d1 = m1, i1, d1, m, ins, dl
    t = total.to(torch.float64)
    ll = torch.log10(t) - scale_log2 * LOG10_2
    return torch.where(t > 0, ll, torch.full_like(ll, float("-inf")))


def genotype_likelihoods(ref_ll: np.ndarray, alt_ll: np.ndarray):
    """Diploid (RR, RA, AA) log10 likelihoods: each read from one of the
    genotype's two haplotypes with probability 1/2."""
    ref = np.maximum(np.asarray(ref_ll, np.float64), LL_FLOOR)
    alt = np.maximum(np.asarray(alt_ll, np.float64), LL_FLOOR)
    hi, lo = np.maximum(ref, alt), np.minimum(ref, alt)
    ra = (hi + np.log10(1.0 + 10.0 ** (lo - hi)) - LOG10_2).sum()
    return float(ref.sum()), float(ra), float(alt.sum())


def phred_records(gl) -> tuple[str, int, list[int], int]:
    """(GT, GQ, PL, QUAL) of a site's (RR, RA, AA) log10 likelihoods."""
    best = max(gl)
    pl = [-10.0 * (g - best) for g in gl]
    gt_i = int(np.argmin(pl))
    gq = int(round(min(min(p for k, p in enumerate(pl) if k != gt_i), 99.0)))
    return (("0/0", "0/1", "1/1")[gt_i], gq,
            [int(round(p)) for p in pl],
            int(round(min(-10.0 * (gl[0] - best), 9999.0))))


def vcf_line(rec: dict, genotyped: bool) -> str:
    """One VCF data line of a record {contig, pos (0-based), ref, alt,
    depth, alt_count, gl}."""
    af = rec["alt_count"] / rec["depth"] if rec["depth"] else 0.0
    qual = "." if rec["gl"] is None else str(phred_records(rec["gl"])[3])
    line = (f"{rec['contig']}\t{rec['pos'] + 1}\t.\t{rec['ref']}\t{rec['alt']}"
            f"\t{qual}\t.\tDP={rec['depth']};AC={rec['alt_count']};"
            f"AF={af:.3f}")
    if genotyped:
        if rec["gl"] is not None:
            gt, gq, pl, _ = phred_records(rec["gl"])
            line += f"\tGT:GQ:PL\t{gt}:{gq}:{','.join(map(str, pl))}"
        else:
            line += "\tGT:GQ:PL\t./.:.:."
    return line


class VariantReference:
    """The plain pipeline over one sample's generated reads."""

    def __init__(self, contigs: list[tuple[str, bytes]], seqs: np.ndarray,
                 quals: np.ndarray, params: dict, device, block: int = 8192):
        self.names = [n for n, _ in contigs]
        parts, offs = [], []
        at = 0
        for k, (_, s) in enumerate(contigs):
            if k:
                parts.append(b"N" * SPACER)
                at += SPACER
            offs.append(at)
            parts.append(s.upper())
            at += len(s)
        self.ref = np.frombuffer(b"".join(parts), np.uint8)
        self.offsets = np.asarray(offs, np.int64)
        self.lengths = np.asarray([len(s) for _, s in contigs], np.int64)
        self.G = self.ref.size
        self.seqs, self.quals = seqs, quals
        self.p = params
        self.device = device
        self.block = block
        self.L = seqs.shape[1]
        self.pad = read_pad(self.L)
        self.W = self.pad + 2 * MARGIN
        self.starts, self.mapped, self.flipped = map_reads(
            seqs, SeedIndex(self.ref))
        self._positions: dict[int, np.ndarray] = {}

    # -- coordinates ----------------------------------------------------

    def contig_of(self, pos: int) -> int:
        return int(np.searchsorted(self.offsets, pos, "right")) - 1

    def site(self, contig: str, pos: int) -> int:
        return int(self.offsets[self.names.index(contig)]) + pos

    def oriented(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The reads as aligned and genotyped: reverse complemented, and
        their qualities reversed, where the anchor was on the reverse
        strand."""
        s, q = self.seqs[rows].copy(), self.quals[rows].copy()
        f = self.flipped[rows]
        s[f] = COMP[s[f]][:, ::-1]
        q[f] = q[f][:, ::-1]
        return s, q

    # -- alignment and pileup --------------------------------------------

    def window_starts(self, rows: np.ndarray) -> np.ndarray:
        return np.clip(self.starts[rows] - MARGIN, 0, max(self.G - self.W, 0))

    def positions(self, rows: np.ndarray) -> np.ndarray:
        """(len(rows), L) absolute reference position of each base of the
        oriented mapped reads ``rows``, -1 where unaligned."""
        todo = np.array([r for r in np.unique(rows).tolist()
                         if r not in self._positions], np.int64)
        gap_open, gap_extend = self.p["gap_open"], self.p["gap_extend"]
        for lo in range(0, todo.size, self.block):
            part = todo[lo:lo + self.block]
            s, _ = self.oriented(part)
            q = np.full((part.size, self.pad), PAD_Q, np.int32)
            q[:, :self.L] = s
            ws = self.window_starts(part)
            w = self.ref[ws[:, None] + np.arange(self.W)[None, :]]
            best, col = affine_positions(
                torch.from_numpy(q).to(self.device),
                torch.from_numpy(w.astype(np.int32)).to(self.device),
                gap_open, gap_extend)
            col = col.cpu().numpy()[:, :self.L].astype(np.int64)
            ok = (best.cpu().numpy() > 0)[:, None] & (col >= 0)
            absolute = np.where(ok, col + ws[:, None], -1)
            for r, row in zip(part.tolist(), absolute):
                self._positions[r] = row
        return np.stack([self._positions[r] for r in rows.tolist()]) \
            if rows.size else np.zeros((0, self.L), np.int64)

    def reads_touching(self, sites: np.ndarray) -> np.ndarray:
        """Mapped reads whose alignment window holds any of ``sites``."""
        rows = np.flatnonzero(self.mapped)
        ws = self.window_starts(rows)
        srt = np.sort(sites)
        k = np.searchsorted(srt, ws, "left")
        return rows[(k < srt.size) & (srt[np.minimum(k, srt.size - 1)]
                                      < ws + self.W)]

    def pileup_rows(self, sites: np.ndarray) -> np.ndarray:
        """(len(sites), 7) pileup rows: A C G T N, deletion, insertion."""
        sites = np.asarray(sites, np.int64)
        rows = self.reads_touching(sites)
        pos = self.positions(rows)
        s, _ = self.oriented(rows)
        codes = CODE[s]
        uniq, back = np.unique(sites, return_inverse=True)
        out = np.zeros((uniq.size, 7), np.int64)
        nxt = np.concatenate([pos[:, 1:], np.full((pos.shape[0], 1), -1)], 1)
        prev = np.concatenate([np.full((pos.shape[0], 1), -1), pos[:, :-1]], 1)
        aligned = pos >= 0
        later = np.flip(np.cumsum(np.flip(aligned, 1), 1), 1) > 0
        events = [
            (pos, codes, aligned & (pos < self.G) & (codes <= 3)),
            (pos + 1, np.full_like(codes, 5),
             aligned & (nxt >= 0) & (nxt - pos - 1 > 0) & (pos + 1 < self.G)),
            (prev + 1, np.full_like(codes, 6),
             ~aligned & (prev >= 0) & later & (prev + 1 < self.G)),
        ]
        for at, col, keep in events:
            at, col = at[keep], col[keep]
            k = np.searchsorted(uniq, at).clip(0, uniq.size - 1)
            hit = uniq[k] == at
            np.add.at(out, (k[hit], col[hit]), 1)
        return out[back]

    def records_at(self, site: int, row: np.ndarray) -> list[dict]:
        """The candidate records of one site's pileup row, before
        genotyping."""
        rc = int(CODE[self.ref[site]])
        if rc > 3:
            return []
        ci = self.contig_of(site)
        base = {"contig": self.names[ci], "pos": site - int(self.offsets[ci]),
                "ref": BASES[rc], "site": site, "gl": None}
        depth = int(row[:4].sum())
        md, af = self.p["min_depth"], self.p["alt_fraction"]
        out = []
        if depth >= md and (depth - int(row[rc])) / max(depth, 1) >= af:
            counts = row[:4].copy()
            counts[rc] = -1
            alt = int(np.argmax(counts))
            out.append({**base, "alt": BASES[alt], "depth": depth,
                        "alt_count": int(row[alt])})
        for col, tag in ((5, "<DEL>"), (6, "<INS>")):
            ev = int(row[col])
            eff = depth + (ev if tag == "<DEL>" else 0)
            if eff >= md and ev / max(eff, 1) >= af:
                out.append({**base, "alt": tag, "depth": depth,
                            "alt_count": ev})
        return out

    # -- genotyping --------------------------------------------------------

    def covering(self, site: int) -> np.ndarray:
        """The first ``gt_max_reads`` mapped reads, in stream order, whose
        anchored span covers ``site``."""
        cov = (self.mapped & (self.starts <= site)
               & (site < self.starts + self.L))
        return np.flatnonzero(cov)[: self.p["gt_max_reads"]]

    def inserted(self, site: int, rows: np.ndarray) -> bytes | None:
        """The inserted bases between site-1 and site that two or more of
        ``rows`` carry, the most frequent first seen."""
        if rows.size == 0:
            return None
        pos = self.positions(rows)
        s, _ = self.oriented(rows)
        votes: Counter = Counter()
        for r in range(rows.size):
            p = pos[r]
            hit = np.flatnonzero(p == site - 1)
            if hit.size != 1:
                continue
            k0 = int(hit[0]) + 1
            after = np.flatnonzero(p[k0:] != -1)
            k1 = k0 + int(after[0]) if after.size else self.L
            if k1 > k0 and k1 < self.L and p[k1] == site:
                votes[s[r, k0:k1].tobytes()] += 1
        if not votes:
            return None
        seq, n = votes.most_common(1)[0]
        return seq if n >= 2 else None

    def genotype(self, records: list[dict], dtype=torch.float64,
                 scale_log2: float = 0.0) -> list[dict]:
        """Records with ``gl`` set (and insertions rewritten to their
        anchor), where the site has covering reads and, for an insertion,
        inferred bases and an anchor base. A ``dtype`` narrower than
        float64 computes the Pair-HMM in it, with the boundary scaled by
        2**scale_log2, and the lanes it underflows again in float64."""
        lanes, owners = [], []
        out = []
        win = self.p["gt_window"]
        for rec in records:
            rec = dict(rec)
            out.append(rec)
            s = rec["site"]
            rows = self.covering(s)
            if rows.size == 0:
                continue
            ci = self.contig_of(s)
            o, n = int(self.offsets[ci]), int(self.lengths[ci])
            w0, w1 = max(o, s - win), min(o + n, s + win + 1)
            i0 = s - w0
            ref_hap = self.ref[w0:w1]
            if rec["alt"] == "<DEL>":
                alt_hap = np.concatenate([ref_hap[:i0], ref_hap[i0 + 1:]])
            elif rec["alt"] == "<INS>":
                seq = self.inserted(s, rows)
                if seq is None or i0 == 0:
                    continue
                alt_hap = np.concatenate([ref_hap[:i0],
                                          np.frombuffer(seq, np.uint8),
                                          ref_hap[i0:]])
                anchor = chr(int(ref_hap[i0 - 1]))
                rec.update(pos=rec["pos"] - 1, ref=anchor,
                           alt=anchor + seq.decode())
            else:
                alt_hap = ref_hap.copy()
                alt_hap[i0] = ord(rec["alt"])
            lanes.append((rows, ref_hap, alt_hap))
            owners.append(len(out) - 1)
        if not lanes:
            return out
        lls = self._pairhmm(lanes, dtype, scale_log2)
        at = 0
        for (rows, _, _), k in zip(lanes, owners):
            n = rows.size
            out[k]["gl"] = genotype_likelihoods(lls[at:at + 2 * n:2],
                                                lls[at + 1:at + 2 * n:2])
            at += 2 * n
        return out

    def _pairhmm(self, lanes, dtype, scale_log2) -> np.ndarray:
        """log10 P(read | hap) of every (read, ref hap), (read, alt hap)
        lane of ``lanes``, in that order."""
        reads, errs, haps, rl, hl = [], [], [], [], []
        N = max(max(r.size, a.size) for _, r, a in lanes)
        for rows, ref_hap, alt_hap in lanes:
            s, q = self.oriented(rows)
            err = 10.0 ** (-(q.astype(np.float64) - 33.0) / 10.0)
            for hap in (ref_hap, alt_hap):
                h = np.full(N, PAD_W, np.int32)
                h[:hap.size] = hap
                reads.append(s.astype(np.int32))
                errs.append(err)
                haps.append(np.broadcast_to(h, (rows.size, N)))
                rl.append(np.full(rows.size, self.L))
                hl.append(np.full(rows.size, hap.size))
        # each read's ref lane, then its alt lane
        R = np.concatenate([np.stack([a, b], 1).reshape(-1, a.shape[1])
                            for a, b in zip(reads[0::2], reads[1::2])])
        E = np.concatenate([np.stack([a, b], 1).reshape(-1, a.shape[1])
                            for a, b in zip(errs[0::2], errs[1::2])])
        H = np.concatenate([np.stack([a, b], 1).reshape(-1, N)
                            for a, b in zip(haps[0::2], haps[1::2])])
        RL = np.concatenate([np.stack([a, b], 1).reshape(-1)
                             for a, b in zip(rl[0::2], rl[1::2])])
        HL = np.concatenate([np.stack([a, b], 1).reshape(-1)
                             for a, b in zip(hl[0::2], hl[1::2])])
        out = np.empty(R.shape[0], np.float64)
        dev = self.device
        step = 4 * self.block
        for lo in range(0, R.shape[0], step):
            args = [torch.from_numpy(np.ascontiguousarray(x[lo:lo + step]))
                    .to(dev) for x in (R, E, H, RL, HL)]
            ll = pairhmm_log10(*args, dtype, scale_log2)
            redo = torch.isinf(ll)
            if dtype != torch.float64 and bool(redo.any()):
                # the lanes the narrow pass underflows, again in float64
                ll[redo] = pairhmm_log10(*(a[redo] for a in args))
            out[lo:lo + step] = ll.cpu().numpy()
        return out
