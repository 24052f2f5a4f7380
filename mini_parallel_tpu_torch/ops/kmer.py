"""k-mer counting: window packing, sort + run-length counting on the device,
exact counts: the counterpart of mini_parallel_tpu/ops/kmer.py.

A k-mer's key is one int64: its 2-bit string (A=0 C=1 G=2 T=3), first base
most significant, so every key of a k <= 31 k-mer is below 2^62 and the
int64 order is the k-mer strings' order at every k. The JAX package splits
the key into (hi, lo) int32 words for the TPU and compares them signed; at
k <= 30 that order is the same as this one, and at k = 31 a hi word whose
first base is G or T is negative, so its canonical fold and its dump order
differ from its own golden, ``count_kmers_python``. The port follows the
golden at every k. :func:`split_keys` and :func:`join_keys` convert to and
from the JAX words (its checkpoints store them).

Windows that hold an N (any code above 3) or run past their read's length
are dropped. Canonical mode keeps the smaller of a k-mer and its reverse
complement. Nothing here is a kernel: the device work is sorts, scans and
reductions in plain torch ops, on whatever device the tensors live on.

The JAX package's drain codec is here as functions of its own: the deltas
of ascending keys and their counts as byte planes, only as many as their
largest value needs (:func:`plane_pack`, on the device), decoded on the
host by one cumsum (:func:`decode_planes_numpy`) or one C++ pass
(native/kmer_store.py:decode_planes_native). The accumulator does not use
it: its drain and spills fetch the raw int64 arrays, which on the card
take less time than packing and decoding the planes (PERF.md).
"""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from mini_parallel_tpu_torch.ops import encode
from mini_parallel_tpu_torch.ops import packed as packedmod

DEFAULT_K = 21
MAX_K = 31  # keys stay below 2^62: the sentinel sorts after every key
SENTINEL = torch.iinfo(torch.int64).max
ACGT = np.frombuffer(b"ACGT", np.uint8)  # code -> ASCII base
EMPTY_ARRAYS = (np.empty(0, np.int64), np.empty(0, np.int64))


def lo_bits(k: int) -> int:
    """Bits in the JAX package's lo word: its last k // 2 bases."""
    return 2 * (k // 2)


def split_keys(keys: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """int64 keys -> the JAX package's (hi, lo) int32 words. A hi word of
    32 bits (k = 31) wraps to a negative int32, as the JAX package's does."""
    keys = np.asarray(keys, np.int64)
    s = lo_bits(k)
    hi = (keys >> s).astype(np.uint32).view(np.int32)
    lo = (keys & ((1 << s) - 1)).astype(np.int32)
    return hi, lo


def join_keys(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """The JAX package's (hi, lo) int32 words -> int64 keys."""
    hi = np.asarray(hi).astype(np.int64) & 0xFFFFFFFF
    return (hi << lo_bits(k)) | np.asarray(lo).astype(np.int64)


def pack_kmers(codes: torch.Tensor, lengths: torch.Tensor,
               k: int = DEFAULT_K, canonical: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Key every length-k window of a (B, L) code batch.

    Returns (keys, valid), each (B, W) with W = L - k + 1: keys int64, and
    a window is valid iff it lies within its read's length and holds no
    code above 3 (N, pads).
    """
    B, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"read pad {L} shorter than k={k}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} out of range: 2-bit packed keys support "
                         f"1 <= k <= {MAX_K}")
    c = codes.to(torch.int64)
    base_ok = c <= 3
    c = torch.where(base_ok, c, 0)
    keys = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    ok = torch.ones((B, W), dtype=torch.bool, device=codes.device)
    for i in range(k):
        keys = keys * 4 + c[:, i:i + W]
        ok &= base_ok[:, i:i + W]
    pos = torch.arange(W, device=codes.device)[None, :]
    ok &= pos + k <= lengths.to(codes.device)[:, None]
    if canonical:
        rc = torch.zeros_like(keys)
        for i in range(k - 1, -1, -1):  # complement, read backwards
            rc = rc * 4 + (3 - c[:, i:i + W])
        keys = torch.minimum(keys, rc)
    return keys, ok


def unique_counts_batch(codes: torch.Tensor, lengths: torch.Tensor,
                        k: int = DEFAULT_K, canonical: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Exact k-mer counts of one read batch on its device.

    Returns (keys, counts, n_unique): the batch's distinct keys in
    ascending order, their counts (int64), and how many there are. One
    sort and one ``unique_consecutive``; invalid windows sort last as
    ``SENTINEL`` and are cut off.
    """
    keys, ok = pack_kmers(codes, lengths, k, canonical)
    flat = torch.where(ok, keys, SENTINEL).reshape(-1)
    # one sentinel more, so that the last run is always the sentinel's
    flat = torch.cat([flat, flat.new_full((1,), SENTINEL)])
    uniq, counts = torch.unique_consecutive(torch.sort(flat).values,
                                            return_counts=True)
    return uniq[:-1], counts[:-1], uniq.numel() - 1


def unique_counts_packed(packed: torch.Tensor, exc_col: torch.Tensor,
                         exc_val: torch.Tensor, lengths: torch.Tensor,
                         k: int = DEFAULT_K, canonical: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`unique_counts_batch` over a 2-bit packed batch
    (ops/packed.py): the reads cross to the device 4 bases a byte."""
    ascii_ = packedmod.unpack_device(packed, exc_col, exc_val, lengths,
                                     int(encode.PAD_A))
    return unique_counts_batch(encode.ascii_to_code(ascii_), lengths, k=k,
                               canonical=canonical)


def fold_counts(keys: torch.Tensor, counts: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum the counts of equal keys: -> (distinct keys ascending, their
    total counts), on the tensors' device."""
    keys, order = torch.sort(keys)
    uniq, inverse = torch.unique_consecutive(keys, return_inverse=True)
    totals = torch.zeros(uniq.numel(), dtype=torch.int64, device=keys.device)
    return uniq, totals.index_add_(0, inverse, counts[order].to(torch.int64))


def _planes_needed(max_val: int) -> int:
    """Bytes of the little-endian form of a value in [0, max_val]."""
    return max(1, (max_val.bit_length() + 7) // 8)


def plane_pack(keys: torch.Tensor, counts: torch.Tensor
               ) -> tuple[torch.Tensor, int, int, int]:
    """The drain codec's device side: (planes, kp, cp, key0) of m keys and
    their counts, on the tensors' device.

    planes is a (kp + cp, m) uint8 tensor: rows 0..kp-1 the bytes of each
    key's delta from the key before it (least significant first; element
    0's delta is 0 and the first key, ``key0``, travels apart), then cp
    rows of count bytes. kp covers the largest delta (all 8 bytes when a
    delta is negative: keys out of order wrap mod 2^64 and still decode);
    cp is 0 when every count is 1. The key is already one int64 (the JAX
    package's tight hi * 2^s + lo embedding), so there are no limbs and
    no sign bias, and the planes are cut at exactly m keys: the JAX
    package's eighth-octave buckets only bound its compiled shapes."""
    m = keys.numel()
    delta = torch.diff(keys, prepend=keys[:1])
    d_max, d_min, c_max, key0 = torch.stack(
        [delta.max(), delta.min(), counts.max().to(torch.int64), keys[0]]
    ).tolist()
    kp = 8 if d_min < 0 else _planes_needed(d_max)
    cp = 0 if c_max == 1 else _planes_needed(c_max)
    planes = torch.cat([
        delta.view(torch.uint8).view(m, 8)[:, :kp].T,
        counts.to(torch.int64).view(torch.uint8).view(m, 8)[:, :cp].T,
    ])
    return planes, kp, cp, key0


def decode_planes_numpy(planes: np.ndarray, m: int, kp: int, cp: int,
                        key0: int) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of native/kmer_store.py:decode_planes_native:
    (keys, counts) int64 from :func:`plane_pack`'s planes, one cumsum."""
    rows = np.asarray(planes, np.uint8).reshape(kp + cp, m)
    buf = np.zeros((m, 8), np.uint8)
    buf[:, :kp] = rows[:kp].T
    delta = buf.view("<u8").ravel()
    if m:
        delta[0] += np.uint64(key0 & ((1 << 64) - 1))
    keys = np.cumsum(delta, dtype=np.uint64).view(np.int64)
    if cp == 0:
        return keys, np.ones(m, np.int64)
    cbuf = np.zeros((m, 8), np.uint8)
    cbuf[:, :cp] = rows[kp:].T
    return keys, cbuf.view("<u8").ravel().view(np.int64)


def sorted_unique(keys: np.ndarray) -> bool:
    """Whether host keys are strictly ascending."""
    return keys.size < 2 or bool(np.all(keys[1:] > keys[:-1]))


def merge_sorted_arrays(a: tuple, b: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Merge two host (keys, counts) pairs into one pair of ascending
    distinct keys and int64 counts.

    Inputs that are already ascending and distinct (a drain, a spill, a
    checkpoint) merge by rank: a key of ``a`` that ``b`` holds adds its
    count into ``b``'s slot, and the others go straight to their merged
    positions. An empty side returns the other side as it is. Any other
    input is sorted and its runs summed."""
    ka, ca = np.asarray(a[0], np.int64), np.asarray(a[1]).astype(np.int64)
    kb, cb = np.asarray(b[0], np.int64), np.asarray(b[1]).astype(np.int64)
    sa, sb = sorted_unique(ka), sorted_unique(kb)
    if ka.size == 0 and sb:
        return kb, cb
    if kb.size == 0 and sa:
        return ka, ca
    if sa and sb:
        pos = np.searchsorted(kb, ka, side="left")
        inb = pos < kb.size
        match = np.zeros(ka.size, bool)
        match[inb] = kb[pos[inb]] == ka[inb]
        cb = cb.copy()
        cb[pos[match]] += ca[match]
        keep = ~match
        ka_u = ka[keep]
        ra = pos[keep] + np.arange(ka_u.size)
        rb = np.searchsorted(ka_u, kb, side="left") + np.arange(kb.size)
        keys = np.empty(ka_u.size + kb.size, np.int64)
        counts = np.empty(keys.size, np.int64)
        keys[ra], keys[rb] = ka_u, kb
        counts[ra], counts[rb] = ca[keep], cb
        return keys, counts
    keys = np.concatenate([ka, kb])
    counts = np.concatenate([ca, cb])
    if keys.size == 0:
        return EMPTY_ARRAYS
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    return keys[starts], np.add.reduceat(counts, starts)


class DeviceKmerAccumulator:
    """Cross-batch k-mer counts kept on the device.

    ``add`` stages a batch's (keys, counts); every ``staging_batches``
    batches (or ``MAX_STAGING_SLOTS`` staged keys) ``flush`` folds the
    store and the staged batches by one sort. Nothing crosses to the host
    until ``drain`` or ``summary``. When a fold leaves more than
    ``capacity`` distinct keys, the fold's result spills to a sorted host
    pair on a background thread and the store restarts empty, so counts
    stay exact at any number of distinct keys. A spill that fails poisons
    the accumulator: every later ``drain`` raises.
    """

    MAX_STAGING_SLOTS = 1 << 26

    def __init__(self, capacity: int = 1 << 25, staging_batches: int = 40):
        self.capacity = capacity
        self.staging_batches = staging_batches
        self.spilled = False
        self._store: tuple[torch.Tensor, torch.Tensor] | None = None
        self._staged: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._staged_slots = 0
        self._spill_arrays = EMPTY_ARRAYS  # ascending, distinct
        self._spill_thread: threading.Thread | None = None
        self._spill_error: BaseException | None = None

    def add(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        """Stage one batch's keys and counts (any order, repeats allowed)."""
        self._staged.append((keys, counts))
        self._staged_slots += keys.numel()
        if (len(self._staged) >= self.staging_batches
                or self._staged_slots >= self.MAX_STAGING_SLOTS):
            self.flush()

    def flush(self) -> None:
        """Fold the staged batches into the store (one sort)."""
        if not self._staged:
            return
        parts = self._staged if self._store is None else [self._store,
                                                          *self._staged]
        self._staged, self._staged_slots = [], 0
        keys, counts = fold_counts(torch.cat([p[0] for p in parts]),
                                   torch.cat([p[1] for p in parts]))
        if keys.numel() > self.capacity:
            self._spill(keys, counts)
            self._store = None
        else:
            self._store = (keys, counts)

    def _fetch(self, keys: torch.Tensor, counts: torch.Tensor
               ) -> tuple[np.ndarray, np.ndarray]:
        return keys.cpu().numpy(), counts.cpu().numpy()

    def _spill(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        """Fetch and merge one fold's result into the host pair on a worker
        thread; the workers run one after another. The tensors are never
        written again, so the store may restart at once."""
        prev = self._spill_thread

        def fold() -> None:
            try:
                if prev is not None:
                    prev.join()
                if self._spill_error is not None:
                    return
                self._spill_arrays = merge_sorted_arrays(
                    self._spill_arrays, self._fetch(keys, counts))
            except BaseException as e:  # noqa: BLE001 — raised by drain()
                self._spill_error = e

        self._spill_thread = threading.Thread(target=fold, daemon=True,
                                              name="mptt-kmer-spill")
        self._spill_thread.start()
        self.spilled = True

    def _join_spills(self) -> None:
        if self._spill_thread is not None:
            self._spill_thread.join()
            self._spill_thread = None
        if self._spill_error is not None:
            # stays set: the folds after the failure were skipped, so any
            # later drain would return an undercount
            raise RuntimeError(
                "k-mer spill fold failed; counts in this accumulator are "
                "incomplete (recount required)") from self._spill_error

    def summary(self, top_n: int = 10, hist_bins: int = 64) -> dict | None:
        """Distinct count, multiplicity histogram and top-N, computed on the
        device without draining the table.

        Returns {"n_unique": int, "hist": int64[hist_bins] (hist[c-1] = the
        distinct k-mers seen c times for c < hist_bins; the last bin holds
        every count >= hist_bins), "top": [(key, count), ...] by count
        descending, ties by ascending key}, or None after a spill, when
        only ``drain`` is exact.
        """
        self.flush()
        if self.spilled:
            return None
        if self._store is None:
            return {"n_unique": 0, "hist": np.zeros(hist_bins, np.int64),
                    "top": []}
        keys, counts = self._store
        hist = torch.bincount(counts.clamp(max=hist_bins),
                              minlength=hist_bins + 1)[1:hist_bins + 1]
        # the store is in key order, so a stable sort by count keeps ties
        # in ascending key order (topk promises no order among ties)
        top = torch.sort(counts, descending=True, stable=True).indices[:top_n]
        return {"n_unique": keys.numel(),
                "hist": hist.cpu().numpy().astype(np.int64),
                "top": list(zip(keys[top].tolist(), counts[top].tolist()))}

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """Every distinct k-mer on the host: (keys ascending, counts), both
        int64."""
        self.flush()
        keys, counts = (EMPTY_ARRAYS if self._store is None
                        else self._fetch(*self._store))
        if self.spilled:
            self._join_spills()
            keys, counts = merge_sorted_arrays(self._spill_arrays,
                                               (keys, counts))
        return keys, counts


def keys_to_bytes(keys: np.ndarray, k: int = DEFAULT_K) -> np.ndarray:
    """int64 keys -> (n, k) uint8 ASCII k-mers."""
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.int64)
    return ACGT[(np.asarray(keys, np.int64)[:, None] >> shifts) & 3]


def key_to_string(key: int, k: int = DEFAULT_K) -> str:
    """One key back to its ACGT string."""
    return keys_to_bytes(np.array([key]), k)[0].tobytes().decode()


def count_kmers_python(reads: list[bytes], k: int = DEFAULT_K,
                       canonical: bool = False) -> Counter:
    """Pure-Python golden counter (tests, small inputs)."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    c: Counter = Counter()
    for r in reads:
        r = r.upper()
        for j in range(len(r) - k + 1):
            w = r[j:j + k]
            if any(b not in b"ACGT" for b in w):
                continue
            if canonical:
                w = min(w, w.translate(comp)[::-1])
            c[w.decode()] += 1
    return c


def merge_device_counts(agg: dict, keys: np.ndarray,
                        counts: np.ndarray) -> dict:
    """Add one batch's (keys, counts) into a host dict keyed by int64 key;
    zero counts are padding."""
    nz = np.asarray(counts) > 0
    for key, ct in zip(np.asarray(keys)[nz].tolist(),
                       np.asarray(counts)[nz].tolist()):
        agg[key] = agg.get(key, 0) + ct
    return agg
