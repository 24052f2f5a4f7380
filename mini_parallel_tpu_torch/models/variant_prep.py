"""Variant-call prep: seed mapping, device pileup, candidate extraction.
The counterpart of mini_parallel_tpu/models/variant_prep.py.

- **seed mapping**: each read is anchored by looking up seed 15-mers
  (30-bit keys in int32) at staggered offsets in a sorted index of the
  reference's 15-mers, with ``torch.searchsorted``; forward and
  reverse-complement seeds are probed in one pass (reads anchored on the
  reverse strand are flipped before pileup). ``rescue=True`` maps the
  seed-missed reads by exhaustive SW against the whole reference (the
  ``csrc/sw_vs_ref.cu`` kernel on the card).
- **pileup**: mapped reads add their base codes into a (G, 7) int32 count
  matrix (A C G T N, deletion and insertion evidence), on the card by one
  launch a chunk of ``csrc/pileup.cu``, which adds only the real counts; on
  the CPU by ``index_add_`` on int64 bins ``pos * 7 + column`` (the plain
  route). The engine adds each chunk into ONE device accumulator in place
  (a flat (G * 7 + 1,) buffer whose last slot takes the plain route's
  masked entries), where the JAX package builds a (G, 7) array per chunk
  and adds it. The ungapped path piles up through the same route, at the
  positions its anchors imply.
- **gapped** (``gapped=True``): each mapped read is aligned against its
  anchored reference window with traceback (``csrc/sw_moves.cu`` on the
  card, linear or affine gaps), and its bases pile up at the aligned
  positions, with deletion/insertion evidence columns.
- **candidates**: sites with depth >= min_depth whose non-reference allele
  fraction >= threshold, extracted on the host as VCF-like records; SAM
  records come from the same traceback positions.

- **genotyping** (:meth:`VariantPrepEngine.genotype_candidates`): a second
  pass maps the reads again, assigns them to the candidate sites they
  cover, and scores every (read, ref haplotype) and (read, alt haplotype)
  pair with one batched Pair-HMM call (``csrc/pairhmm.cu`` on the card,
  float32, then float64 on the lanes that underflow) for diploid GL, GT
  and GQ; insertion alleles are inferred from the covering reads'
  traceback.

Mapped counts stay on the device and are read once per checkpoint and once
at the end.

With a device mesh (``mesh=``), packed batches shard data-parallel: each
shard runs the same fused batch step (seed mapping, the rescue sweep, the
traceback) on its rows and device against a zero pileup, and one merge
adds the shards' pileups and mapped counts into the accumulator
(scatter-adds commute, so the result equals the single-device one); the
first shard adds into the accumulator itself. Without a mesh the same path
runs on a mesh of one shard, the engine's device. The SAM path runs on the
mesh's first device, as in the JAX package; ``genotype_candidates`` shards
its Pair-HMM lanes.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mini_parallel_tpu_torch.device import require_cuda
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.ops import encode
from mini_parallel_tpu_torch.ops import packed as packedmod
from mini_parallel_tpu_torch.ops import pairhmm
from mini_parallel_tpu_torch.ops.pairhmm import pairhmm_log10_padded
from mini_parallel_tpu_torch.ops.pileup_cuda import (
    PILEUP_COLS,
    pileup_positions_cuda,
)
from mini_parallel_tpu_torch.ops.sw_cuda import sw_vs_ref_batch_best
from mini_parallel_tpu_torch.ops.sw_traceback import (
    sw_affine_positions_batch_best,
    sw_positions_batch_best,
)
from mini_parallel_tpu_torch.parallel import collectives
from mini_parallel_tpu_torch.parallel.mesh import (
    engine_mesh,
    mesh_device,
    put_sharded,
    shard_batch,
)
from mini_parallel_tpu_torch.utils import spans
from mini_parallel_tpu_torch.utils.config import Config

SEED_K = 15  # 2*15 = 30 bits: seed keys fit non-negative int32

# Ns between concatenated contigs: a local alignment crossing the spacer
# pays -1 per N, so with reads <= 255 bp the bridge cost (512) exceeds the
# largest possible gain (2 * 255) and cross-contig alignments never win.
CONTIG_SPACER_N = 512

N_SEED_TRIES = 4  # seed offsets attempted per read (0, stride, 2*stride, ...)
SEED_STRIDE = 17  # coprime-ish with k = 15, so one SNP cannot kill two seeds


def concat_contigs(contigs: dict[str, bytes],
                   spacer: int = CONTIG_SPACER_N):
    """Join contigs with N-spacers -> (concat_bytes, names, offsets,
    lengths). Seeds containing N are invalid and SW cannot profitably cross
    a spacer, so mapping and pileup on the concat behave like per-contig
    mapping; spacer positions are reference N and never become candidate
    sites."""
    names = list(contigs)
    offsets, lengths, parts = [], [], []
    at = 0
    for i, n in enumerate(names):
        seq = contigs[n].upper()
        if i:
            parts.append(b"N" * spacer)
            at += spacer
        offsets.append(at)
        lengths.append(len(seq))
        parts.append(seq)
        at += len(seq)
    return b"".join(parts), names, np.asarray(offsets), np.asarray(lengths)


@dataclass
class Candidate:
    pos: int  # 0-based position within its contig
    ref_base: str
    alt_base: str
    depth: int
    alt_count: int
    contig: str = "ref"
    # Pair-HMM genotyping (genotype_candidates): (RR, RA, AA) log10
    # likelihoods, the argmax genotype string, and its Phred-scaled quality
    gl: tuple | None = None
    gt: str | None = None
    gq: int | None = None

    @property
    def alt_fraction(self) -> float:
        return self.alt_count / self.depth if self.depth else 0.0


@dataclass
class VariantPrepResult:
    reference_length: int
    total_reads: int = 0
    mapped_reads: int = 0
    candidates: list[Candidate] = field(default_factory=list)
    # (G, 7): base counts A C G T N, deletion evidence, insertion evidence
    pileup: np.ndarray | None = None
    seconds: float = 0.0
    contigs: list = field(default_factory=list)  # [(name, length)]

    @property
    def mapping_rate(self) -> float:
        return self.mapped_reads / self.total_reads if self.total_reads else 0.0


# A window's key with its bases' flags in one int64: bits 0..2k-1 hold its
# 2-bit base codes, and each base that is not A C G T (N, a pad) sets a bit
# at _SEED_BAD or above, which the shifts that place a window's k bases
# (2(k-1) bits at most) never bring below 2^(2k) nor past bit 62.
_SEED_BAD = 1 << 32


def _window_keys(codes: torch.Tensor, k: int = SEED_K) -> torch.Tensor:
    """Every k-window of a 1-D code tensor -> int64 on its device: the
    window's key ``sum_m codes[i+m] * 4^(k-1-m)`` where its k bases are all
    A C G T, _SEED_BAD or more where one is not. Blocks of 1, 2, 4, 8 bases
    join by shifts, log2(k) passes with no (W, k) temporary; the last join
    overlaps two blocks and keeps the second's last k - b digits."""
    w = codes.long()
    w = torch.where(w <= 3, w, _SEED_BAD)
    b = 1
    while 2 * b <= k:
        w = (w[:-b] << 2 * b) | w[b:]
        b *= 2
    r = k - b
    if r:
        w = (w[:-r] << 2 * r) | (w[r:] & (((1 << 2 * r) - 1) | -_SEED_BAD))
    return w


class ReferenceIndex:
    """Sorted seed-k-mer index of a reference sequence (device tensors),
    built on the device: the keys of every clean k-window, sorted STABLY,
    so a key's first entry is its first reference occurrence and a left
    ``searchsorted`` anchors there. Keys arrive in position order, so the
    index is the one ordering by (key, position)."""

    def __init__(self, reference: bytes, device: torch.device,
                 k: int = SEED_K):
        self.k = k
        self.reference = reference.upper()
        ref_u8 = np.frombuffer(self.reference, np.uint8)
        self.ref_codes = encode._ASCII_TO_CODE[ref_u8]
        self.ref_ascii_dev = torch.from_numpy(ref_u8.copy()).to(device)
        # an unclean window sorts after every clean key as 4^k (int32)
        keys = _window_keys(encode.ascii_to_code(self.ref_ascii_dev), k)
        keys = keys.clamp_max(4 ** k).to(torch.int32)
        n_clean = (keys < 4 ** k).sum()
        keys, order = torch.sort(keys, stable=True)
        n = int(n_clean)  # the build's one sync
        self.sorted_keys = keys[:n]
        self.sorted_pos = order[:n].to(torch.int32)

    def __len__(self) -> int:
        return int(self.sorted_keys.shape[0])


def _first_true(h: torch.Tensor) -> torch.Tensor:
    """Index of each row's first True (0 for a row with none): the JAX
    package's argmax over bool rows."""
    S = h.shape[1]
    idx = torch.arange(S, device=h.device)
    return torch.where(h, idx, S).amin(dim=1).clamp_max(S - 1)


def _map_reads_both(codes: torch.Tensor, lengths: torch.Tensor,
                    sorted_keys: torch.Tensor, sorted_pos: torch.Tensor,
                    k: int = SEED_K):
    """Forward + reverse-complement seed anchoring in ONE pass.

    Probes N_SEED_TRIES forward windows at offsets 0, 17, 34, 51 (clipped
    to the row) and the reverse complement's windows at the same offsets,
    which are the forward windows at ``len - o - k`` read backwards:
    rc_key(o) = (4^k - 1) - sum_m fwd[len-o-k+m] * 4^m. A strand anchors at
    its first probe whose key is in the index (and does not start before
    the reference). Returns (starts_f, mapped_f, starts_r, mapped_r);
    starts are -1 when the strand found no anchor."""
    B, L = codes.shape
    dev = codes.device
    W = L - k + 1
    S = N_SEED_TRIES
    c = codes.to(torch.int32)
    offs = torch.clamp_max(
        torch.arange(S, dtype=torch.int32, device=dev) * SEED_STRIDE, W - 1)
    p_rc = lengths.to(torch.int32)[:, None] - offs[None, :] - k  # (B, S)
    starts = torch.cat([offs[None, :].expand(B, S), p_rc.clamp_min(0)], dim=1)
    idx = starts[:, :, None] + torch.arange(k, dtype=torch.int32,
                                            device=dev)[None, None, :]
    win = c.gather(1, idx.reshape(B, -1).to(torch.int64)).reshape(B, 2 * S, k)
    clean = (win <= 3).all(dim=2)  # N and pad bases kill a seed
    ok = clean & torch.cat(
        [torch.ones((B, S), dtype=torch.bool, device=dev), p_rc >= 0], dim=1)
    digits = torch.where(win <= 3, win, 0)
    pow_hi = torch.from_numpy(
        (4 ** np.arange(k - 1, -1, -1, dtype=np.int64)).astype(np.int32)).to(dev)
    pow_lo = torch.from_numpy(
        (4 ** np.arange(k, dtype=np.int64)).astype(np.int32)).to(dev)
    key_f = (digits[:, :S] * pow_hi).sum(dim=2, dtype=torch.int32)
    key_r = (4 ** k - 1) - (digits[:, S:] * pow_lo).sum(dim=2,
                                                        dtype=torch.int32)
    key_s = torch.cat([key_f, key_r], dim=1)  # (B, 2S) int32
    idx2 = torch.searchsorted(sorted_keys, key_s.reshape(-1)).reshape(B, 2 * S)
    idx2 = idx2.clamp(0, sorted_keys.shape[0] - 1)
    offs2 = torch.cat([offs, offs])  # seed offset within each READ
    start_s = sorted_pos[idx2] - offs2[None, :]
    hit_s = ok & (sorted_keys[idx2] == key_s) & (start_s >= 0)

    def pick(h, st):
        has = h.any(dim=1)
        anchor = st.gather(1, _first_true(h)[:, None])[:, 0]
        return torch.where(has, anchor, -1), has

    starts_f, mapped_f = pick(hit_s[:, :S], start_s[:, :S])
    starts_r, mapped_r = pick(hit_s[:, S:], start_s[:, S:])
    return starts_f, mapped_f, starts_r, mapped_r


def _new_pileup(G: int, device: torch.device) -> torch.Tensor:
    """A zero pileup accumulator: flat (G * 7 + 1,) int32, the last slot
    taking the plain route's masked entries (the kernel never writes it);
    :func:`pileup_view` is its (G, 7) part."""
    return torch.zeros(G * PILEUP_COLS + 1, dtype=torch.int32, device=device)


def pileup_view(acc: torch.Tensor) -> torch.Tensor:
    return acc[:-1].view(-1, PILEUP_COLS)


def _ungapped_positions(lengths: torch.Tensor, starts: torch.Tensor,
                        mapped: torch.Tensor, L: int) -> torch.Tensor:
    """(B, L) int64 reference positions of ungapped reads: ``start + col``
    for each column of a mapped read, -1 past its length and on unmapped
    rows. A row's positions >= 0 form one unbroken run, so the pileup finds
    no deletion or insertion in them."""
    col = torch.arange(L, dtype=torch.int64, device=starts.device)[None, :]
    keep = mapped[:, None] & (col < lengths.to(torch.int64)[:, None])
    return torch.where(keep, starts.to(torch.int64)[:, None] + col, -1)


def _pileup_batch(codes: torch.Tensor, lengths: torch.Tensor,
                  starts: torch.Tensor, mapped: torch.Tensor, G: int,
                  qual_ok: torch.Tensor | None = None,
                  acc: torch.Tensor | None = None) -> torch.Tensor:
    """Add mapped reads, ungapped, into a pileup; returns its (G, 7) view.

    ``acc`` (a :func:`_new_pileup` buffer) is updated in place; without it
    a fresh one is made. ``qual_ok`` (B, L) bool excludes low-quality bases
    from the counts (mapping still uses every base). The bases pile up at
    the positions their anchors imply (:func:`_ungapped_positions`), by
    :func:`_pileup_positions`."""
    positions = _ungapped_positions(lengths, starts, mapped, codes.shape[1])
    return _pileup_positions(codes, positions, G, qual_ok, acc)


def _pileup_positions(codes: torch.Tensor, positions: torch.Tensor, G: int,
                      qual_ok: torch.Tensor | None = None,
                      acc: torch.Tensor | None = None) -> torch.Tensor:
    """Pileup with explicit per-base reference positions (gapped mode);
    returns the (G, 7) view of ``acc`` (updated in place, or fresh).

    positions[b, l] is the reference coordinate of query base l, or -1 for
    unaligned, inserted and soft-clipped bases. Columns 5 and 6 count one
    read per gap event: a jump between consecutive aligned bases is a
    deletion at the first skipped site; an unaligned run between aligned
    bases is an insertion, counted once at the site after its left anchor.
    A gap event counts only when its flanking bases pass the quality
    gate. CPU tensors take :func:`_pileup_positions_plain`; any other
    device the kernel (``ops/pileup_cuda.py``), or an error."""
    acc = _new_pileup(G, codes.device) if acc is None else acc
    if codes.device.type == "cpu":
        _pileup_positions_plain(codes, positions, G, qual_ok, acc)
    else:
        pileup_positions_cuda(codes, positions, G, qual_ok, acc)
    return pileup_view(acc)


def _pileup_positions_plain(codes: torch.Tensor, positions: torch.Tensor,
                            G: int, qual_ok: torch.Tensor | None,
                            acc: torch.Tensor) -> None:
    """:func:`_pileup_positions` in torch ops, on any device: the bins of
    :func:`_pileup_bins` added by ``index_add_``. Integer adds commute, so
    the order never shows."""
    bins = _pileup_bins(codes, positions, G, qual_ok)
    acc.index_add_(0, bins, torch.ones(bins.shape[0], dtype=acc.dtype,
                                       device=acc.device))


def _pileup_bins(codes: torch.Tensor, positions: torch.Tensor, G: int,
                 qual_ok: torch.Tensor | None) -> torch.Tensor:
    """The flat accumulator's slot of every entry of the plain route: three
    (B, L) sets of int64 bins (bases, deletions, insertions) joined, each
    masked entry sent to the trash slot ``G * 7``. Bins are int64: the JAX
    package's int32 ``pos * 5 + code`` wraps past G = 429,496,729."""
    B, L = codes.shape
    dev = codes.device
    trash = G * PILEUP_COLS
    pos = positions.to(torch.int64)
    valid = (positions >= 0) & (positions < G) & (codes <= 3)
    if qual_ok is not None:
        valid = valid & qual_ok
    base = torch.where(valid, pos * PILEUP_COLS + codes.to(torch.int64), trash)

    aligned = positions >= 0
    q_ok = (qual_ok if qual_ok is not None
            else torch.ones((B, L), dtype=torch.bool, device=dev))
    q_nxt = torch.cat(
        [q_ok[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1)
    nxt = torch.cat(
        [pos[:, 1:], torch.full((B, 1), -1, dtype=torch.int64, device=dev)],
        dim=1)
    gap = nxt - pos - 1
    del_here = aligned & (nxt >= 0) & (gap > 0) & q_ok & q_nxt
    del_site = pos + 1
    dels = torch.where(del_here & (del_site < G),
                       del_site * PILEUP_COLS + 5, trash)

    prev = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int64, device=dev), pos[:, :-1]],
        dim=1)
    later = torch.flip(torch.cumsum(torch.flip(aligned.to(torch.int32), [1]),
                                    dim=1), [1]) > 0  # aligned base at >= l
    ins_here = (~aligned) & (prev >= 0) & later & q_ok
    ins_site = prev + 1
    inss = torch.where(ins_here & (ins_site < G),
                       ins_site * PILEUP_COLS + 6, trash)
    return torch.cat([base.reshape(-1), dels.reshape(-1), inss.reshape(-1)])


_BASE_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def _codes_to_ascii(codes: torch.Tensor, lengths: torch.Tensor,
                    keep: torch.Tensor | None = None) -> torch.Tensor:
    """Codes -> ASCII with PAD_A pads; rows where keep is False become
    all-pad."""
    dev = codes.device
    lut = torch.from_numpy(_BASE_ASCII.copy()).to(dev)
    col = torch.arange(codes.shape[1], device=dev)[None, :]
    mask = col < lengths[:, None]
    if keep is not None:
        mask = mask & keep[:, None]
    return torch.where(mask, lut[codes.clamp_max(4).to(torch.int64)],
                       torch.tensor(int(encode.PAD_A), dtype=torch.uint8,
                                    device=dev))


def _rescue_unmapped(codes, rc_codes, lens, ref_ascii, starts, mapped,
                     rescue_min_frac: float):
    """Seed-free rescue: exhaustively SW every still-unmapped read (both
    strands) against the whole reference and anchor at the best end when
    the score clears ``2 * rescue_min_frac * len`` (float32, truncated).
    Mapped reads are blanked to pad, which the vs-ref kernel skips. Both
    strands go through one launch as one (2B, M) batch: the kernel's time
    is set by the reference sweep, not by the number of reads. While the
    recorder is on, counts the rows handed to the sweep
    (``variant.rescue.rows``, two an unmapped read) and the reads rescued
    (``variant.rescue.rescued``)."""
    with spans.span("variant.rescue"):
        unm = ~mapped
        B = codes.shape[0]
        scores, ends = sw_vs_ref_batch_best(
            _codes_to_ascii(torch.cat([codes, rc_codes]), lens.repeat(2),
                            keep=unm.repeat(2)), ref_ascii)
        s_f, s_r = scores[:B], scores[B:]
        p_f, p_r = ends[:B], ends[B:]
        use_rc = s_r > s_f
        s_best = torch.maximum(s_f, s_r)
        p_best = torch.where(use_rc, p_r, p_f)
        frac = torch.tensor(2.0 * rescue_min_frac, dtype=torch.float32,
                            device=lens.device)
        thresh = (frac * lens.to(torch.float32)).to(torch.int32)
        good = unm & (s_best >= thresh.clamp_min(1))
        anchor = (p_best - lens + 1).clamp_min(0)
        rc_used = good & use_rc
        new_codes = torch.where(rc_used[:, None], rc_codes, codes)
        new_starts = torch.where(good, anchor, starts)
        if spans.recording():
            _count_rescue(unm, good)
    return new_codes, new_starts, mapped | good, rc_used


def _count_rescue(unm: torch.Tensor, good: torch.Tensor) -> None:
    """The rescue's two counters, read in one device sync."""
    rows, rescued = torch.stack([unm.sum(), good.sum()]).tolist()
    spans.count("variant.rescue.rows", 2 * rows)
    spans.count("variant.rescue.rescued", rescued)


def _reverse_prefix(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix of a (B, L) tensor; the pad tail
    stays in place (flip the row, then roll it by (len - L) mod L)."""
    L = rows.shape[1]
    flipped = rows.flip(1)
    shift = torch.remainder(lens.to(torch.int64) - L, L)
    col = torch.arange(L, dtype=torch.int64, device=rows.device)[None, :]
    return flipped.gather(1, torch.remainder(col - shift[:, None], L))


def _revcomp_codes(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse-complement each row's valid prefix in code space (pads stay
    at the end; N and pad codes map to themselves)."""
    return _reverse_prefix(encode.complement_code(codes), lengths)


def _map_codes_batch(codes, lens, sorted_keys, sorted_pos, ref_ascii,
                     k, rescue, rescue_min_frac):
    """Mapping on decoded read codes: forward seeds first, then reverse
    complement, then (optionally) rescue. -> (final_codes, final_starts,
    final_mapped, flipped); flipped marks rows whose codes are the reverse
    complement of the input read (per-base side channels such as quality
    masks must be reversed for them)."""
    starts, mapped, rc_starts, rc_mapped = _map_reads_both(
        codes, lens, sorted_keys, sorted_pos, k)
    rc_codes = _revcomp_codes(codes, lens)
    use_rc = (~mapped) & rc_mapped
    final_codes = torch.where(use_rc[:, None], rc_codes, codes)
    final_starts = torch.where(use_rc, rc_starts, starts)
    final_mapped = mapped | rc_mapped
    flipped = use_rc
    if rescue:
        final_codes, final_starts, final_mapped, rc_used = _rescue_unmapped(
            final_codes, rc_codes, lens, ref_ascii, final_starts,
            final_mapped, rescue_min_frac)
        flipped = flipped | rc_used
    return final_codes, final_starts, final_mapped, flipped


def _map_packed_batch(pk, ec, ev, lens, sorted_keys, sorted_pos, ref_ascii,
                      k, rescue, rescue_min_frac):
    """Packed-wire mapping: unpack 2-bit reads, then _map_codes_batch."""
    ascii_ = packedmod.unpack_device(pk, ec, ev, lens, int(encode.PAD_A))
    return _map_codes_batch(encode.ascii_to_code(ascii_), lens, sorted_keys,
                            sorted_pos, ref_ascii, k, rescue, rescue_min_frac)


def _orient_qual_ok(qb, lens, L, flipped):
    """Unpack a bit-packed quality mask and reverse the rows mapped on the
    reverse strand, so the mask stays aligned with the flipped codes."""
    if qb is None:
        return None
    qual_ok = packedmod.unpack_bits_device(qb, L)
    return torch.where(flipped[:, None], _reverse_prefix(qual_ok, lens),
                       qual_ok)


def _ungapped_batch_step(pk, ec, ev, lens, qb, sorted_keys, sorted_pos,
                         ref_ascii, pileup_acc, G: int, k: int = SEED_K,
                         rescue: bool = False, rescue_min_frac: float = 0.6):
    """One device step of the ungapped path: unpack, map both strands (and
    rescue), add the pileup into ``pileup_acc`` in place. Returns
    (pileup_acc, mapped count as a device scalar)."""
    final_codes, final_starts, final_mapped, flipped = _map_packed_batch(
        pk, ec, ev, lens, sorted_keys, sorted_pos, ref_ascii, k, rescue,
        rescue_min_frac)
    qual_ok = _orient_qual_ok(qb, lens, final_codes.shape[1], flipped)
    _pileup_batch(final_codes, lens, final_starts, final_mapped, G, qual_ok,
                  acc=pileup_acc)
    return pileup_acc, final_mapped.sum(dtype=torch.int32)


def _gapped_batch_step(pk, ec, ev, lens, qb, sorted_keys, sorted_pos,
                       ref_ascii, pileup_acc, G: int, W: int, margin: int,
                       k: int = SEED_K, rescue: bool = False,
                       rescue_min_frac: float = 0.6,
                       gap_model: str = "linear", gap_open: int = -2,
                       gap_extend: int = -1):
    """Gapped device step: unpack, map (and rescue), traceback pileup."""
    final_codes, final_starts, final_mapped, flipped = _map_packed_batch(
        pk, ec, ev, lens, sorted_keys, sorted_pos, ref_ascii, k, rescue,
        rescue_min_frac)
    qual_ok = _orient_qual_ok(qb, lens, final_codes.shape[1], flipped)
    return _gapped_pileup_step(
        final_codes, lens, final_starts, final_mapped, ref_ascii, pileup_acc,
        G, W, margin, qual_ok, gap_model=gap_model, gap_open=gap_open,
        gap_extend=gap_extend)


def _gapped_pileup_step(codes, lens, starts, mapped, ref_ascii, pileup_acc,
                        G: int, W: int, margin: int, qual_ok=None,
                        gap_model: str = "linear", gap_open: int = -2,
                        gap_extend: int = -1):
    """Gapped pileup on the device: traceback each mapped read against its
    anchored reference window and add the pileup into ``pileup_acc`` in
    place. Returns (pileup_acc, mapped count as a device scalar)."""
    positions = _traceback_positions(codes, lens, starts, mapped, ref_ascii,
                                     G, W, margin, gap_model, gap_open,
                                     gap_extend)
    _pileup_positions(codes, positions, G, qual_ok, acc=pileup_acc)
    return pileup_acc, mapped.sum(dtype=torch.int32)


def _gapped_operands(codes, lens, starts, mapped, ref_ascii, G, W, margin):
    """The traceback's operands: (queries (B, L) ASCII, unmapped rows all
    PAD_A; reference windows (B, W) ASCII; window starts (B,)). A window
    starts ``margin`` before the anchor (clipped to the reference) and is
    PAD_B past the reference's end."""
    dev = codes.device
    win_starts = (starts - margin).clamp(0, max(G - W, 0))
    widx = (win_starts.to(torch.int64)[:, None]
            + torch.arange(W, dtype=torch.int64, device=dev)[None, :])
    windows = torch.where(
        widx < G, ref_ascii[widx.clamp(0, G - 1)],
        torch.tensor(int(encode.PAD_B), dtype=torch.uint8, device=dev))
    return _codes_to_ascii(codes, lens, keep=mapped), windows, win_starts


def _traceback_positions(codes, lens, starts, mapped, ref_ascii,
                         G, W, margin, gap_model, gap_open, gap_extend):
    """(B, L) absolute reference positions per query base (-1 unaligned)
    by windowed traceback around each read's anchor (see
    :func:`_gapped_operands`)."""
    q_ascii, windows, win_starts = _gapped_operands(
        codes, lens, starts, mapped, ref_ascii, G, W, margin)
    if gap_model == "affine":
        score, positions = sw_affine_positions_batch_best(
            q_ascii, windows, gap_open=gap_open, gap_extend=gap_extend)
    else:
        score, positions = sw_positions_batch_best(q_ascii, windows)
    ok = mapped & (score > 0)
    return torch.where(ok[:, None] & (positions >= 0),
                       positions + win_starts[:, None], -1)


def _gapped_map_step(pk, ec, ev, lens, sorted_keys, sorted_pos, ref_ascii,
                     G: int, W: int, margin: int, k: int = SEED_K,
                     rescue: bool = False, rescue_min_frac: float = 0.6,
                     gap_model: str = "linear", gap_open: int = -2,
                     gap_extend: int = -1):
    """Mapping-output step (SAM writer): per-base reference positions plus
    the oriented codes and strand flags."""
    final_codes, final_starts, final_mapped, flipped = _map_packed_batch(
        pk, ec, ev, lens, sorted_keys, sorted_pos, ref_ascii, k, rescue,
        rescue_min_frac)
    positions = _traceback_positions(
        final_codes, lens, final_starts, final_mapped, ref_ascii, G, W,
        margin, gap_model, gap_open, gap_extend)
    return positions, final_codes, final_mapped, flipped


class VariantPrepEngine:
    """Variant-call prep with ungapped (fast) or gapped (traceback) pileup
    on one device, or on the data shards of a device mesh.

    gapped=True aligns each mapped read against its anchored reference
    window with traceback, so reads containing indels still pile up their
    downstream bases at the right reference coordinates.
    """

    def __init__(
        self,
        reference: bytes | dict[str, bytes],
        cfg: Config | None = None,
        min_depth: int = 2,
        alt_fraction: float = 0.2,
        gapped: bool = False,
        window_margin: int = 16,
        rescue: bool = False,
        rescue_min_frac: float = 0.6,
        min_base_quality: int = 0,
        gap_model: str = "linear",
        contig_spacer: int = CONTIG_SPACER_N,
        device: torch.device | str | None = None,
        mesh=None,
    ):
        self.cfg = cfg or Config(chunk_size_reads=10_000)
        if gap_model not in ("linear", "affine"):
            raise ValueError(f"unknown gap_model {gap_model!r}")
        with spans.span("variant.engine_init"):
            self.device = require_cuda(mesh_device(mesh, device))
            self.mesh = engine_mesh(mesh, self.device)
            if isinstance(reference, dict):
                concat, names, offs, lens = concat_contigs(
                    reference, spacer=contig_spacer)
                self.contig_names = names
                self.contig_offsets = offs
                self.contig_lengths = lens
                reference = concat
            else:
                self.contig_names = ["ref"]
                self.contig_offsets = np.asarray([0])
                self.contig_lengths = np.asarray([len(reference)])
            with spans.span("variant.index"):
                self.index = ReferenceIndex(reference, self.device)
                spans.count("variant.index.seeds", len(self.index))
        # the index's device tensors on each shard device of the mesh
        self._shard_index: dict = {}
        self.min_depth = min_depth
        self.alt_fraction = alt_fraction
        self.gapped = gapped
        self.window_margin = window_margin
        self.rescue = rescue
        self.rescue_min_frac = rescue_min_frac
        # Phred+33 floor: bases below it are left out of the pileup
        # EVIDENCE (mapping and alignment use every base); 0 = off
        self.min_base_quality = min_base_quality
        # gapped traceback scoring: "affine" is Gotoh with cfg.gap_open /
        # cfg.gap_extend, so one long gap beats alternating ops
        self.gap_model = gap_model
        self.contig_spacer = contig_spacer

    # -- batch preparation -------------------------------------------------

    def _pad_for(self, maxlen: int) -> int:
        """Pad bucket + contig-spacer guard (the guard keeps cross-spacer
        alignments impossible for every consumer, pileup and SAM alike)."""
        pad = -(-max(self.cfg.read_pad, SEED_K + 1, maxlen) // 8) * 8
        if len(self.contig_names) > 1 and 2 * pad > self.contig_spacer:
            raise ValueError(
                f"reads up to {pad}bp need a contig spacer > {2 * pad} "
                f"(have {self.contig_spacer}); pass contig_spacer= to "
                "VariantPrepEngine"
            )
        return pad

    def _prep_batch_flat(self, flat: np.ndarray, offs: np.ndarray):
        """Pad + spacer-guard one flat (bytes, offsets) chunk -> (arr, lens,
        pad)."""
        maxlen = int(np.diff(offs).max()) if len(offs) > 1 else 1
        pad = self._pad_for(maxlen)
        arr, lens = encode.pad_batch_flat(flat, offs, pad_to=pad,
                                          pad_value=int(encode.PAD_A))
        return arr, lens, pad

    def _qual_mask_flat(self, qflat: np.ndarray, qoffs: np.ndarray,
                        pad: int) -> np.ndarray | None:
        """(B, pad) bool from a flat quals chunk: a base passes the Phred+33
        floor; quality bytes past a record's end pass."""
        if self.min_base_quality <= 0:
            return None
        B = len(qoffs) - 1
        ok = np.ones((B, pad), bool)
        floor = 33 + self.min_base_quality
        qlens = np.minimum(np.diff(qoffs), pad)
        total = int(qlens.sum())
        if total == 0:
            return ok
        rows = np.repeat(np.arange(B, dtype=np.int64), qlens)
        cols = (np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(qlens) - qlens, qlens))
        vals = qflat[np.repeat(qoffs[:-1], qlens) + cols]
        ok[rows, cols] = vals >= floor
        return ok

    # -- device steps --------------------------------------------------------

    def new_pileup(self) -> torch.Tensor:
        """A zero pileup accumulator on the engine's device."""
        return _new_pileup(len(self.index.ref_codes), self.device)

    def process_reads_batch(self, reads: list[bytes], pileup_acc,
                            quals: list[bytes] | None = None):
        """:meth:`process_flat_batch` over a list of reads, with their
        Phred+33 quality strings when ``min_base_quality`` is set (bases
        past a short quality string pass)."""
        arr, lens, pad = self._prep_batch_flat(*fastq.flatten_rows(reads))
        qmask = None
        if quals is not None:
            if len(quals) != len(reads):
                raise ValueError(f"{len(quals)} quality strings for "
                                 f"{len(reads)} reads")
            qmask = self._qual_mask_flat(*fastq.flatten_rows(quals), pad)
        return self._process_prepped(arr, lens, pad, pileup_acc, qmask)

    def process_flat_batch(self, flat: np.ndarray, offs: np.ndarray,
                           pileup_acc):
        """One flat (bytes, offsets) chunk into ``pileup_acc`` (updated in
        place). Returns the mapped count as a DEFERRED device scalar."""
        with spans.span("variant.prep"):
            arr, lens, pad = self._prep_batch_flat(flat, offs)
        with spans.span("variant.step"):
            return self._process_prepped(arr, lens, pad, pileup_acc, None)

    def _index_on(self, dev: torch.device) -> tuple[torch.Tensor, ...]:
        """(sorted_keys, sorted_pos, ref_ascii) on ``dev``, copied once."""
        if dev not in self._shard_index:
            idx = self.index
            self._shard_index[dev] = tuple(
                t.to(dev) for t in (idx.sorted_keys, idx.sorted_pos,
                                    idx.ref_ascii_dev))
        return self._shard_index[dev]

    def _batch_step(self, pk, ec, ev, lens, qb, index, pileup_acc, G: int,
                    pad: int):
        """The fused packed batch step (gapped or ungapped) on the
        operands' device: -> (pileup_acc, mapped count)."""
        if self.gapped:
            return _gapped_batch_step(
                pk, ec, ev, lens, qb, *index, pileup_acc, G,
                pad + 2 * self.window_margin, self.window_margin,
                rescue=self.rescue, rescue_min_frac=self.rescue_min_frac,
                gap_model=self.gap_model, gap_open=self.cfg.gap_open,
                gap_extend=self.cfg.gap_extend)
        return _ungapped_batch_step(
            pk, ec, ev, lens, qb, *index, pileup_acc, G, rescue=self.rescue,
            rescue_min_frac=self.rescue_min_frac)

    def _process_prepped(self, arr, lens, pad, pileup_acc, qmask):
        """Pack one padded batch; each shard runs the batch step on its
        rows, the first into ``pileup_acc`` (in place), every other
        against a zero pileup on its device; those pileups merge into
        ``pileup_acc`` and the mapped counts into one deferred device
        scalar."""
        G = len(self.index.ref_codes)
        shards = put_sharded(packedmod.pack_batch(arr, lens), self.mesh)
        if qmask is None:
            qbs = [None] * len(shards)
        else:
            rows = sum(s[0].shape[0] for s in shards)
            qmask = np.concatenate(
                [qmask, np.ones((rows - qmask.shape[0], pad), bool)])
            qbs = [q for (q,) in shard_batch(
                self.mesh, (packedmod.pack_bits(qmask),))]
        piles, counts = [], []
        for i, (args, qb) in enumerate(zip(shards, qbs)):
            dev = args[0].device
            pile, n = self._batch_step(
                *args, qb, self._index_on(dev),
                pileup_acc if i == 0 else _new_pileup(G, dev), G, pad)
            piles.append(pile)
            counts.append(n)
        if len(piles) > 1:
            pileup_acc += collectives.merge_scores(piles[1:]).to(
                pileup_acc.device)
        return pileup_acc, collectives.merge_scores(counts)

    # -- checkpoints ---------------------------------------------------------

    def _checkpoint_meta(self, res: VariantPrepResult, chunks_done: int,
                         file_path: str | None = None) -> dict:
        """Resume-safety fingerprint: resuming with a different input,
        reference, scoring config or chunk geometry would corrupt the
        pileup. The same keys and file format as the JAX package."""
        return {
            "file_path": file_path,
            "reference_length": len(self.index.ref_codes),
            "contigs": [(n, int(l)) for n, l in self.contig_table()],
            "chunk_size_reads": self.cfg.chunk_size_reads,
            "gapped": self.gapped, "gap_model": self.gap_model,
            "rescue": self.rescue, "min_base_quality": self.min_base_quality,
            "window_margin": self.window_margin,
            "rescue_min_frac": self.rescue_min_frac,
            "chunks_done": chunks_done, "total_reads": res.total_reads,
            "mapped_reads": res.mapped_reads,
        }

    def _load_resume(self, checkpoint_path: str | None,
                     res: VariantPrepResult, file_path: str | None = None):
        if not checkpoint_path or not os.path.exists(checkpoint_path):
            return None, 0
        with np.load(checkpoint_path) as z:
            pileup = z["pileup"]
            meta = json.loads(str(z["meta"]))
        want = self._checkpoint_meta(res, 0, file_path=file_path)
        for key in ("file_path", "reference_length", "contigs",
                    "chunk_size_reads", "gapped", "gap_model", "rescue",
                    "min_base_quality", "window_margin", "rescue_min_frac"):
            got = meta.get(key)
            if key == "contigs":
                got = [tuple(c) for c in (got or [])]
            if got != want[key]:
                raise ValueError(
                    f"variant-prep checkpoint {checkpoint_path} has "
                    f"{key}={got!r} but the engine uses {want[key]!r}"
                )
        res.total_reads = int(meta["total_reads"])
        res.mapped_reads = int(meta["mapped_reads"])
        return pileup, int(meta["chunks_done"])

    @staticmethod
    def _save_checkpoint(checkpoint_path: str, pileup: np.ndarray,
                         meta: dict) -> None:
        tmp = checkpoint_path + ".tmp.npz"
        np.savez_compressed(tmp, pileup=pileup,
                            meta=np.array(json.dumps(meta)))
        os.replace(tmp, checkpoint_path)

    # -- files ---------------------------------------------------------------

    def process_file(self, path, progress=None, sam_out: str | None = None,
                     checkpoint_path: str | None = None,
                     checkpoint_every: int = 0) -> VariantPrepResult:
        """Map + pileup a FASTQ, or a whole sample: ``path`` may be a LIST
        of lane files streamed in order into one pileup (checkpoint chunk
        indices are global across the list). ``sam_out`` also writes SAM
        1.6 records from the SAME mapping pass (gapped only).

        ``checkpoint_path`` + ``checkpoint_every`` make the run
        crash-resumable: the pileup and read counters snapshot to a
        compressed .npz every N chunks, and a rerun resumes from the last
        snapshot exactly (chunk pileups are additive and independent)."""
        paths = fastq.as_paths(path)
        joined = "|".join(paths)
        if sam_out is not None:
            if not self.gapped:
                raise ValueError("sam_out requires gapped=True (SAM CIGARs "
                                 "come from the traceback)")
            if self.min_base_quality > 0:
                raise ValueError("sam_out with min_base_quality is not "
                                 "supported yet")
            if checkpoint_path is not None:
                raise ValueError("checkpointing with sam_out is not "
                                 "supported (SAM resume would need file "
                                 "truncation to the last complete batch)")
            return self._process_file_sam(paths, sam_out, progress)
        t0 = time.perf_counter()
        G = len(self.index.ref_codes)
        res = VariantPrepResult(reference_length=G)
        saved_pileup, start_chunk = self._load_resume(checkpoint_path, res,
                                                      file_path=joined)
        pileup = self.new_pileup()
        if saved_pileup is not None:
            pileup_view(pileup).copy_(torch.from_numpy(
                np.ascontiguousarray(saved_pileup, np.int32)))
        deferred: list = []  # device scalars of the mapped counts
        if self.min_base_quality > 0:
            stream = fastq.iter_flat_chunks_with_quals_multi(
                paths, self.cfg.chunk_size_reads)
        else:
            stream = fastq.iter_flat_chunks_multi(paths,
                                                  self.cfg.chunk_size_reads)
        with spans.span("variant.pass1"), fastq.prefetch(stream) as batches:
            for idx, item in enumerate(batches):
                if idx < start_chunk:  # resume: already in the saved pileup
                    continue
                with spans.span("variant.chunk", idx):
                    if self.min_base_quality > 0:
                        flat, offs, qflat, qoffs = item
                        with spans.span("variant.prep"):
                            arr, lens, pad = self._prep_batch_flat(flat, offs)
                            # a truncated final record has an EMPTY quality,
                            # whose 0-length row passes the mask
                            qmask = self._qual_mask_flat(qflat, qoffs, pad)
                        with spans.span("variant.step"):
                            pileup, n_mapped = self._process_prepped(
                                arr, lens, pad, pileup, qmask)
                    else:
                        flat, offs = item
                        pileup, n_mapped = self.process_flat_batch(
                            flat, offs, pileup)
                n_reads = len(offs) - 1
                res.total_reads += n_reads
                deferred.append(n_mapped)
                if (checkpoint_path and checkpoint_every
                        and (idx + 1) % checkpoint_every == 0):
                    res.mapped_reads += _drain(deferred)
                    self._save_checkpoint(
                        checkpoint_path, pileup_view(pileup).cpu().numpy(),
                        self._checkpoint_meta(res, idx + 1, file_path=joined))
                if progress:
                    shown = (f"{res.mapped_reads} mapped" if not deferred
                             else f"{len(deferred)} batches queued")
                    progress(f"  {res.total_reads} reads, {shown}")
            with spans.span("variant.drain.sync"):
                res.mapped_reads += _drain(deferred)
                # while recording: summed on the device ahead of the copy,
                # read after it; by rows in int32 first, since a sum to
                # int64 of the whole view would cast all of it first
                events = (pileup_view(pileup).sum(dim=1, dtype=torch.int32)
                          .sum() if spans.recording() else None)
                res.pileup = pileup_view(pileup).cpu().numpy()
                if events is not None:
                    spans.count("variant.pileup.events", int(events))
            with spans.span("variant.extract"):
                res.candidates = self._extract_candidates(res.pileup)
        res.contigs = self.contig_table()
        res.seconds = time.perf_counter() - t0
        return res

    def _process_file_sam(self, paths: list, sam_out: str,
                          progress) -> VariantPrepResult:
        """One mapping pass feeding both the pileup and the SAM writer."""
        t0 = time.perf_counter()
        G = len(self.index.ref_codes)
        idx = self.index
        pileup = self.new_pileup()
        res = VariantPrepResult(reference_length=G)
        rid = 0
        stream = fastq.iter_flat_chunks_multi(
            paths, self.cfg.chunk_size_reads, progress=progress)
        with open(sam_out, "w") as f, spans.span("variant.pass1"), \
                fastq.prefetch(stream) as batches:
            _write_sam_header(f, self.contig_table())
            for chunk, (flat, offs) in enumerate(batches):
                with spans.span("variant.chunk", chunk):
                    with spans.span("variant.prep"):
                        arr, lens, pad = self._prep_batch_flat(flat, offs)
                    with spans.span("variant.sam.step"):
                        pb = packedmod.pack_batch(arr, lens)
                        positions, codes, mapped, flipped = _gapped_map_step(
                            *packedmod.device_args(pb, self.device),
                            idx.sorted_keys, idx.sorted_pos,
                            idx.ref_ascii_dev, G,
                            pad + 2 * self.window_margin, self.window_margin,
                            rescue=self.rescue,
                            rescue_min_frac=self.rescue_min_frac,
                            gap_model=self.gap_model,
                            gap_open=self.cfg.gap_open,
                            gap_extend=self.cfg.gap_extend)
                        _pileup_positions(codes, positions, G, acc=pileup)
                    with spans.span("variant.sam.sync"):
                        host = [t.cpu().numpy()
                                for t in (positions, codes, mapped, flipped)]
                    with spans.span("variant.sam.write"):
                        rid, n_mapped = _write_sam_batch(
                            f, flat, offs, *host, self.contig_names,
                            self.contig_offsets, rid)
                res.total_reads += len(offs) - 1
                res.mapped_reads += n_mapped
            with spans.span("variant.drain.sync"):
                res.pileup = pileup_view(pileup).cpu().numpy()
            with spans.span("variant.extract"):
                res.candidates = self._extract_candidates(res.pileup)
        res.contigs = self.contig_table()
        res.seconds = time.perf_counter() - t0
        return res

    # -- genotyping ----------------------------------------------------------

    def genotype_candidates(self, path, res: VariantPrepResult,
                            window: int = 50, max_reads_per_site: int = 64,
                            progress=None) -> VariantPrepResult:
        """Diploid genotype likelihoods for the candidates by the Pair-HMM
        forward: the likelihood model behind GATK/DeepVariant-style callers.

        A second streaming pass over the FASTQ (a path or a list of lanes)
        maps the reads again with the same seed mapper (and ``rescue``),
        assigns each read to the candidate sites it covers (at most
        ``max_reads_per_site`` per site, in stream order), and ONE batched
        Pair-HMM call scores every (read, ref window) and (read, alt window)
        pair. Reads mapped on the reverse strand are reverse-complemented and
        their qualities reversed; a read whose quality string does not match
        its length is scored at Q30. Windows reach ``window`` bases either
        side of the site, clipped to its contig. Sets Candidate.gl = (RR,
        RA, AA) log10, .gt ('0/0' | '0/1' | '1/1') and .gq (Phred).

        SNPs, <DEL> and <INS> candidates are genotyped; a deletion drops the
        site's base from the alt haplotype. An insertion's SEQUENCE is first
        inferred from the covering reads' traceback (the run of unaligned
        bases between reference positions site-1 and site, majority-voted,
        >= 2 supporting reads); the candidate is then rewritten to the VCF
        anchor convention (POS = site-1, REF = anchor base, ALT = anchor +
        inserted) and genotyped like any other allele. Failures stay
        symbolic <INS> with gl=None. Use gap_model="affine" for canonical
        insertion alleles: linear-gap tracebacks may split a multi-base
        insertion into score-equivalent adjacent single-base events.

        The operands are built by gathers: reads are kept once per chunk
        (only those assigned to a site), haplotype windows are cut from the
        reference in one indexed read; only an <INS> allele is spliced per
        site. The same contract as the JAX package's method."""
        with spans.span("genotype"):
            sites = [c for c in res.candidates
                     if c.gl is None
                     and (len(c.alt_base) == 1
                          or c.alt_base in ("<DEL>", "<INS>"))]
            if not sites:
                return res
            off_by_name = dict(zip(self.contig_names,
                                   (int(x) for x in self.contig_offsets)))
            abs_pos = np.array([off_by_name[c.contig] + c.pos
                                for c in sites], np.int64)
            with spans.span("genotype.remap"):
                reads = self._assign_reads(path, abs_pos, max_reads_per_site,
                                           progress)
            with spans.span("genotype.insertions"):
                ins_seqs = self._infer_insertions(sites, reads, abs_pos)
            with spans.span("genotype.operands"):
                lanes = self._genotype_lanes(sites, reads, abs_pos, ins_seqs,
                                             window)
            if lanes is None:
                return res
            live, operands = lanes
            with spans.span("genotype.pairhmm"):
                lls, n_f64 = pairhmm_log10_padded(*operands, mesh=self.mesh)
                if progress:
                    progress(f"  genotyping: {lls.numel()} Pair-HMM lanes, "
                             f"{n_f64} recomputed in float64")
                with spans.span("genotype.pairhmm.sync"):
                    lls = lls.cpu().numpy()
            with spans.span("genotype.calls"):
                ends = 2 * np.cumsum(reads["per_site"][live])
                for s_i, block in zip(live.tolist(),
                                      np.split(lls, ends[:-1])):
                    rr, ra, aa = pairhmm.genotype_likelihoods(block[0::2],
                                                              block[1::2])
                    c = sites[s_i]
                    c.gl = (rr, ra, aa)
                    best = max(rr, ra, aa)
                    pl = [-10.0 * (g - best) for g in (rr, ra, aa)]
                    gt_i = int(np.argmin(pl))
                    c.gt = ("0/0", "0/1", "1/1")[gt_i]
                    c.gq = int(round(min(
                        min(p for i2, p in enumerate(pl) if i2 != gt_i),
                        99.0)))
                # <INS> rewrites moved pos back by one; restore the VCF sort
                # order
                rank = {n: i for i, n in enumerate(self.contig_names)}
                res.candidates.sort(
                    key=lambda c: (rank.get(c.contig, len(rank)), c.pos))
        return res

    def _assign_reads(self, path, abs_pos: np.ndarray, cap: int,
                      progress) -> dict:
        """The genotyping pass over the reads: map each chunk, find the
        sites each mapped read covers (one ``searchsorted`` pair per chunk),
        and keep a read for a site while the site has fewer than ``cap``
        reads, in stream order. Returns the kept reads, oriented (flipped
        reads reverse-complemented, their qualities reversed, Q30 where the
        quality string's length differs), as a table: ``seqs`` (R, L) ASCII
        padded with PAD_A, ``quals`` (R, L) Phred+33, ``lens``, ``starts``;
        and the assignments: ``rows`` and ``sites`` sorted by site, each
        site's rows in stream order, and ``per_site`` counts."""
        idx = self.index
        dev = self.device
        S = abs_pos.size
        order = np.argsort(abs_pos, kind="stable")
        abs_sorted = abs_pos[order]
        counts = np.zeros(S, np.int64)
        chunks, pair_sites, pair_rows = [], [], []
        n_rows = 0
        stream = fastq.iter_flat_chunks_with_quals_multi(
            fastq.as_paths(path), self.cfg.chunk_size_reads)
        with fastq.prefetch(stream) as batches:
            for chunk, (flat, offs, qflat, qoffs) in enumerate(batches):
                with spans.span("genotype.map", chunk):
                    arr, lens, _ = self._prep_batch_flat(flat, offs)
                    # the mapped codes are dropped: the reads are oriented
                    # below
                    _, *mapping = _map_codes_batch(
                        encode.ascii_to_code(torch.from_numpy(arr).to(dev)),
                        torch.from_numpy(np.asarray(lens, np.int32)).to(dev),
                        idx.sorted_keys, idx.sorted_pos, idx.ref_ascii_dev,
                        SEED_K, self.rescue, self.rescue_min_frac)
                with spans.span("genotype.map.sync", chunk):
                    starts, mapped, flipped = (t.cpu().numpy()
                                               for t in mapping)
                with spans.span("genotype.assign", chunk):
                    lens_v = np.diff(offs)
                    lo = np.searchsorted(abs_sorted, starts, "left")
                    hi = np.searchsorted(abs_sorted, starts + lens_v, "left")
                    n_cov = np.where(mapped & (lens_v > 0), hi - lo,
                                     0).clip(0)
                    read_of = np.repeat(np.arange(len(lens_v)), n_cov)
                    site_of = order[lo[read_of] + _ranks(n_cov)]
                    # each site takes its first reads in stream order
                    by_site = np.argsort(site_of, kind="stable")
                    rank = np.empty_like(by_site)
                    rank[by_site] = (np.arange(by_site.size)
                                     - np.searchsorted(site_of[by_site],
                                                       site_of[by_site],
                                                       "left"))
                    keep = counts[site_of] + rank < cap
                    counts += np.bincount(site_of[keep], minlength=S)
                    rows, inv = np.unique(read_of[keep], return_inverse=True)
                if rows.size:
                    with spans.span("genotype.orient", chunk):
                        chunks.append(_oriented_reads(arr, lens, qflat, qoffs,
                                                      starts, flipped, rows))
                    pair_sites.append(site_of[keep])
                    pair_rows.append(n_rows + inv)
                    n_rows += rows.size
                if progress:
                    progress(f"  genotyping: {int(counts.sum())} read-site "
                             f"assignments")
        L = max((c[0].shape[1] for c in chunks), default=1)
        sites = np.concatenate(pair_sites) if pair_sites else np.zeros(0, int)
        by_site = np.argsort(sites, kind="stable")
        return {
            "seqs": np.concatenate([_widen(c[0], L, int(encode.PAD_A))
                                    for c in chunks]) if chunks
            else np.zeros((0, L), np.uint8),
            "quals": np.concatenate([_widen(c[1], L, 0) for c in chunks])
            if chunks else np.zeros((0, L), np.uint8),
            "lens": np.concatenate([c[2] for c in chunks]) if chunks
            else np.zeros(0, np.int32),
            "starts": np.concatenate([c[3] for c in chunks]) if chunks
            else np.zeros(0, np.int64),
            "rows": (np.concatenate(pair_rows)[by_site] if pair_rows
                     else np.zeros(0, np.int64)),
            "sites": sites[by_site],
            "per_site": counts,
        }

    def _infer_insertions(self, sites: list, reads: dict,
                          abs_pos: np.ndarray) -> dict:
        """For <INS> candidates, infer the inserted sequence from the gapped
        traceback of the covering reads (``_traceback_positions``, the
        moves kernel's walk on the card): bases at reference position -1
        anchored between positions site-1 and site (the pileup records the
        insertion evidence at anchor+1). Majority vote across the site's
        reads, first seen on ties, >= 2 supporting -> {site index: bytes}."""
        from collections import Counter

        ins_idx = [s_i for s_i, c in enumerate(sites)
                   if c.alt_base == "<INS>" and reads["per_site"][s_i]]
        if not ins_idx:
            return {}
        chosen = np.isin(reads["sites"], ins_idx)
        rows, owner = reads["rows"][chosen], reads["sites"][chosen]
        lens = reads["lens"][rows]
        pad = self._pad_for(int(lens.max()))
        seqs = _widen(reads["seqs"][rows], pad, int(encode.PAD_A))[:, :pad]
        dev = self.device
        G = len(self.index.ref_codes)
        lens_t = torch.from_numpy(lens).to(dev)
        positions = _traceback_positions(
            encode.ascii_to_code(torch.from_numpy(seqs).to(dev)), lens_t,
            torch.from_numpy(reads["starts"][rows].astype(np.int32)).to(dev),
            torch.ones(rows.size, dtype=torch.bool, device=dev),
            self.index.ref_ascii_dev, G, pad + 2 * self.window_margin,
            self.window_margin, self.gap_model, self.cfg.gap_open,
            self.cfg.gap_extend).cpu().numpy()
        s_abs = abs_pos[owner][:, None]
        col = np.arange(pad)[None, :]
        hit = positions == s_abs - 1  # the left anchor
        k0 = hit.argmax(axis=1) + 1
        # the insertion runs from k0 to the first aligned base (or the end)
        stop = (positions != -1) | (col >= lens[:, None])
        k1 = np.where(stop & (col >= k0[:, None]), col, pad).min(axis=1)
        at = np.take_along_axis(positions, np.minimum(k1, pad - 1)[:, None],
                                axis=1)[:, 0]
        ok = (hit.sum(axis=1) == 1) & (k1 > k0) & (k1 < lens) & (at == s_abs[:, 0])
        votes: dict = {}
        for r in np.flatnonzero(ok).tolist():
            votes.setdefault(int(owner[r]), Counter())[
                seqs[r, k0[r]:k1[r]].tobytes()] += 1
        out = {}
        for s_i, ctr in votes.items():
            seq, cnt = ctr.most_common(1)[0]
            if cnt >= 2:
                out[s_i] = seq
        return out

    def _genotype_lanes(self, sites: list, reads: dict, abs_pos: np.ndarray,
                        ins_seqs: dict, window: int):
        """The Pair-HMM operands: for each genotyped site in order, each of
        its reads against the ref haplotype, then the alt haplotype. Returns
        (the genotyped sites' indices, (reads, err64, haps, read_lens,
        hap_lens) on the device), or None when no site has reads. Rewrites
        each inferred <INS> candidate to the VCF anchor convention; an <INS>
        without an inferred sequence or anchor base is skipped."""
        ref = np.frombuffer(self.index.reference, np.uint8)
        offs = dict(zip(self.contig_names, (int(x) for x in self.contig_offsets)))
        lens_c = dict(zip(self.contig_names,
                          (int(x) for x in self.contig_lengths)))
        o = np.array([offs[c.contig] for c in sites], np.int64)
        w0 = np.maximum(o, abs_pos - window)
        w1 = np.minimum(o + np.array([lens_c[c.contig] for c in sites]),
                        abs_pos + window + 1)
        i0 = abs_pos - w0
        kind = np.array([{"<DEL>": 1, "<INS>": 2}.get(c.alt_base, 0)
                         for c in sites])
        inferred = np.array([s in ins_seqs for s in range(len(sites))])
        # an <INS> needs its inferred sequence and an anchor base
        ins_ok = inferred & (i0 > 0)
        live = np.flatnonzero((reads["per_site"] > 0)
                              & ((kind != 2) | ins_ok))
        if live.size == 0:
            return None
        w0, w1, i0, kind = w0[live], w1[live], i0[live], kind[live]
        ins = [ins_seqs.get(int(s), b"") for s in live]
        ref_len = w1 - w0
        alt_len = ref_len + np.where(kind == 1, -1, 0) + np.array(
            [len(x) for x in ins])
        N = int(max(ref_len.max(), alt_len.max()))
        col = np.arange(N)[None, :]
        pad_b = int(encode.PAD_B)
        ref_hap = np.where(col < ref_len[:, None],
                           ref[np.minimum(w0[:, None] + col, ref.size - 1)],
                           pad_b).astype(np.uint8)
        # deletions read the window one base further from the site on
        skip = np.where((kind[:, None] == 1) & (col >= i0[:, None]), 1, 0)
        alt_hap = np.where(col < alt_len[:, None],
                           ref[np.minimum(w0[:, None] + col + skip,
                                          ref.size - 1)],
                           pad_b).astype(np.uint8)
        snp = np.flatnonzero(kind == 0)
        alt_hap[snp, i0[snp]] = [ord(sites[s].alt_base) for s in live[snp]]
        for k in np.flatnonzero(kind == 2).tolist():
            c = sites[live[k]]
            h = ref_hap[k, :ref_len[k]].tobytes()
            seq = ins[k]
            alt_hap[k, :alt_len[k]] = np.frombuffer(
                h[:i0[k]] + seq + h[i0[k]:], np.uint8)
            c.pos -= 1
            c.ref_base = chr(h[i0[k] - 1])
            c.alt_base = c.ref_base + seq.decode()
        rows = reads["rows"][np.isin(reads["sites"], live)]
        hap_k = np.repeat(np.arange(live.size), reads["per_site"][live])
        read_rows = np.repeat(rows, 2)
        hap_rows = np.stack([2 * hap_k, 2 * hap_k + 1], axis=1).reshape(-1)
        haps = np.stack([ref_hap, alt_hap], axis=1).reshape(-1, N)
        hap_lens = np.stack([ref_len, alt_len], axis=1).reshape(-1)
        dev = self.device
        seq_t = torch.from_numpy(reads["seqs"]).to(dev)
        lens_t = torch.from_numpy(reads["lens"]).to(dev)
        phred = torch.from_numpy(reads["quals"]).to(dev).to(torch.float64) - 33
        col_t = torch.arange(seq_t.shape[1], device=dev)[None, :]
        err = torch.where(col_t < lens_t[:, None], pairhmm.phred_error(phred),
                          0)
        sel = torch.from_numpy(read_rows).to(dev)
        hsel = torch.from_numpy(hap_rows).to(dev)
        return live, (seq_t[sel], err[sel],
                      torch.from_numpy(haps).to(dev)[hsel], lens_t[sel],
                      torch.from_numpy(hap_lens.astype(np.int32)).to(dev)[hsel])

    def _extract_candidates(self, pileup: np.ndarray) -> list[Candidate]:
        bases = "ACGTN"
        ref = self.index.ref_codes
        G = len(ref)
        depth = pileup[:, :4].sum(axis=1)
        out: list[Candidate] = []
        ref_safe = np.minimum(ref[:G], 4)
        ref_counts = np.where(
            ref_safe < 4, pileup[np.arange(G), ref_safe], 0
        )
        alt_counts = depth - ref_counts
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(depth > 0, alt_counts / np.maximum(depth, 1), 0.0)
        sites = np.nonzero(
            (depth >= self.min_depth) & (frac >= self.alt_fraction)
            & (ref_safe < 4)
        )[0]
        # indel sites from the gapped traceback evidence columns; reads
        # supporting a deletion span the site without a base there, so they
        # count toward its effective depth
        indel_sites: list[tuple[int, str, int]] = []
        if pileup.shape[1] >= 7:
            for col, tag in ((5, "<DEL>"), (6, "<INS>")):
                ev = pileup[:, col]
                eff_depth = depth + (ev if tag == "<DEL>" else 0)
                hits = np.nonzero(
                    (eff_depth >= self.min_depth)
                    & (ev / np.maximum(eff_depth, 1) >= self.alt_fraction)
                    & (ref_safe < 4)
                )[0]
                indel_sites += [(int(p), tag, int(ev[p])) for p in hits]
        for pos in sites.tolist():
            counts = pileup[pos, :4].copy()
            counts[ref_safe[pos]] = -1  # exclude ref from alt argmax
            alt = int(np.argmax(counts))
            ci = int(np.searchsorted(self.contig_offsets, pos, "right")) - 1
            out.append(Candidate(
                pos=pos - int(self.contig_offsets[ci]),
                ref_base=bases[ref_safe[pos]], alt_base=bases[alt],
                depth=int(depth[pos]), alt_count=int(pileup[pos, alt]),
                contig=self.contig_names[ci]))
        for pos, tag, ev in indel_sites:
            ci = int(np.searchsorted(self.contig_offsets, pos, "right")) - 1
            out.append(Candidate(
                pos=pos - int(self.contig_offsets[ci]),
                ref_base=bases[ref_safe[pos]], alt_base=tag,
                depth=int(depth[pos]), alt_count=ev,
                contig=self.contig_names[ci]))
        out.sort(key=lambda c: (c.contig, c.pos, c.alt_base))
        return out

    def contig_table(self) -> list[tuple[str, int]]:
        """[(name, length)] of the reference contigs, for VCF headers."""
        return list(zip(self.contig_names,
                        (int(x) for x in self.contig_lengths)))


def _ranks(n: np.ndarray) -> np.ndarray:
    """0, 1, ..., n[0]-1, 0, 1, ..., n[1]-1, ...: each entry's rank in its
    run of ``np.repeat(..., n)``."""
    total = int(n.sum())
    return np.arange(total) - np.repeat(np.cumsum(n) - n, n)


def _oriented_reads(arr, lens, qflat, qoffs, starts, flipped, rows):
    """Rows ``rows`` of a chunk as the genotyper scores them: (seqs, quals,
    lens, starts). Reads mapped on the reverse strand are
    reverse-complemented and their qualities reversed; a read whose quality
    string's length differs from its own is scored at Q30."""
    seqs = arr[rows]
    n = np.asarray(lens, np.int32)[rows]
    quals = np.full(seqs.shape, 33 + 30, np.uint8)
    qlen = np.diff(qoffs)[rows]
    same = np.flatnonzero(qlen == n)
    r = np.repeat(same, n[same])
    c = _ranks(n[same])
    quals[r, c] = qflat[np.repeat(qoffs[rows][same], n[same]) + c]
    flip = np.asarray(flipped, bool)[rows]
    n_flip = torch.from_numpy(n[flip])
    seqs[flip] = encode.revcomp_padded(torch.from_numpy(seqs[flip]), n_flip,
                                       int(encode.PAD_A)).numpy()
    quals[flip] = _reverse_prefix(torch.from_numpy(quals[flip]),
                                  n_flip).numpy()
    return seqs, quals, n, np.asarray(starts, np.int64)[rows]


def _widen(rows: np.ndarray, width: int, fill: int) -> np.ndarray:
    """(R, L) -> (R, max(L, width)), the new columns ``fill``."""
    if rows.shape[1] >= width:
        return rows
    out = np.full((rows.shape[0], width), fill, rows.dtype)
    out[:, :rows.shape[1]] = rows
    return out


def _drain(deferred: list) -> int:
    """Sum and clear the deferred device counts (one device read)."""
    if not deferred:
        return 0
    total = int(torch.stack(deferred).to(torch.int64).sum())
    deferred.clear()
    return total


def write_candidates_vcf(path: str, res: VariantPrepResult,
                         contigs: list[tuple[str, int]] | None = None) -> None:
    """Minimal VCF-like output for the DeepVariant hand-off, byte for byte
    the JAX package's: genotyped candidates (``--genotype``) add the
    FORMAT header lines, GT:GQ:PL columns and QUAL = the 0/0 genotype's PL,
    capped at 9999; a site left without a genotype prints ./.:.:. .
    ``contigs`` defaults to the table the engine recorded on the result."""
    if contigs is None:
        contigs = res.contigs or [("ref", res.reference_length)]
    genotyped = any(c.gl is not None for c in res.candidates)
    with spans.span("vcf.write"), open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        for name, length in contigs:
            f.write(f"##contig=<ID={name},length={length}>\n")
        if genotyped:
            f.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                    'Description="Genotype">\n')
            f.write('##FORMAT=<ID=GQ,Number=1,Type=Integer,'
                    'Description="Genotype quality (Phred)">\n')
            f.write('##FORMAT=<ID=PL,Number=G,Type=Integer,Description='
                    '"Phred-scaled genotype likelihoods (Pair-HMM)">\n')
        cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        f.write(cols + ("\tFORMAT\tSAMPLE\n" if genotyped else "\n"))
        for c in res.candidates:
            # QUAL: Phred confidence that ANY variant is present, the 0/0
            # genotype's PL; "." when not genotyped
            qual = "."
            if c.gl is not None:
                qual = str(int(round(min(-10.0 * (c.gl[0] - max(c.gl)),
                                         9999.0))))
            line = (f"{c.contig}\t{c.pos + 1}\t.\t{c.ref_base}\t{c.alt_base}"
                    f"\t{qual}\t.\tDP={c.depth};AC={c.alt_count};"
                    f"AF={c.alt_fraction:.3f}")
            if genotyped:
                if c.gl is not None:
                    best = max(c.gl)
                    pl = ",".join(str(int(round(-10.0 * (g - best))))
                                  for g in c.gl)
                    line += f"\tGT:GQ:PL\t{c.gt}:{c.gq}:{pl}"
                else:
                    line += "\tGT:GQ:PL\t./.:.:."
            f.write(line + "\n")


# ---------------------------------------------------------------------------
# SAM output: records rebuilt from the traceback positions (the same data
# the pileup consumes).
# ---------------------------------------------------------------------------


def positions_to_cigar(pos: np.ndarray, length: int) -> tuple[str, int]:
    """(CIGAR, 0-based ref start) from a read's per-base reference
    positions: runs of consecutive positions -> M; jumps between aligned
    bases -> D; unaligned bases between aligned ones -> I; leading and
    trailing unaligned bases -> S. ("", -1) for unmapped reads."""
    pos = pos[:length]
    aligned = np.nonzero(pos >= 0)[0]
    if aligned.size == 0:
        return "", -1
    first, last = int(aligned[0]), int(aligned[-1])
    ops: list[tuple[int, str]] = []
    if first > 0:
        ops.append((first, "S"))
    run_m = 0
    pend_i = 0
    prev_p = None
    for i in range(first, last + 1):
        p = int(pos[i])
        if p < 0:
            if run_m:
                ops.append((run_m, "M"))
                run_m = 0
            pend_i += 1
            continue
        if prev_p is not None:
            gap = p - prev_p - 1
            if pend_i:
                if run_m:
                    ops.append((run_m, "M"))
                    run_m = 0
                ops.append((pend_i, "I"))
                pend_i = 0
            if gap > 0:
                if run_m:
                    ops.append((run_m, "M"))
                    run_m = 0
                ops.append((gap, "D"))
        run_m += 1
        prev_p = p
    if run_m:
        ops.append((run_m, "M"))
    if length - 1 > last:
        ops.append((length - 1 - last, "S"))
    return "".join(f"{n}{op}" for n, op in ops), int(pos[first])


_CODE_TO_BASE = np.frombuffer(b"ACGTN", np.uint8)


def _write_sam_header(f, contigs: list[tuple[str, int]]) -> None:
    f.write("@HD\tVN:1.6\tSO:unknown\n")
    for name, length in contigs:
        f.write(f"@SQ\tSN:{name}\tLN:{length}\n")
    f.write("@PG\tID:mini_parallel_tpu\tPN:mini_parallel_tpu\n")


def _write_sam_batch(f, flat, offs, positions, codes, mapped, flipped,
                     names, offsets, rid: int) -> tuple[int, int]:
    """Write one flat (bytes, offsets) batch of records; returns (next
    rid, mapped count). Read names are synthetic r{N}; QUAL is '*'. SEQ is
    in alignment orientation with FLAG 0x10 on reverse-strand hits, 0x4
    when unmapped."""
    n_mapped = 0
    for b in range(len(offs) - 1):
        read = flat[offs[b]:offs[b + 1]].tobytes()
        n = len(read)
        qname = f"r{rid}"
        rid += 1
        cigar, start = positions_to_cigar(positions[b], n)
        if not mapped[b] or start < 0:
            # SAM requires '*' (not empty) for an absent sequence
            f.write(f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                    f"{read.decode() or '*'}\t*\n")
            continue
        n_mapped += 1
        ci = int(np.searchsorted(offsets, start, "right")) - 1
        local = start - int(offsets[ci])
        seq = _CODE_TO_BASE[np.minimum(codes[b, :n], 4)].tobytes()
        flag = 16 if flipped[b] else 0
        f.write(
            f"{qname}\t{flag}\t{names[ci]}\t{local + 1}\t255\t"
            f"{cigar}\t*\t0\t0\t{seq.decode()}\t*\n"
        )
    return rid, n_mapped


def write_sam(path: str, engine: VariantPrepEngine, fastq_path,
              progress=None) -> dict:
    """Map ``fastq_path`` against the engine's reference and write SAM:
    process_file(sam_out=...) on a gapped copy of the engine when it is not
    gapped."""
    import copy

    eng = engine
    if not eng.gapped:
        eng = copy.copy(engine)  # keeps the prebuilt index and contig tables
        eng.gapped = True
    res = eng.process_file(fastq_path, progress=progress, sam_out=path)
    return {"records": res.total_reads, "mapped": res.mapped_reads}
