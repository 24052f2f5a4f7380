"""k-mer counting pipeline, FASTQ lanes -> exact k-mer counts: the
counterpart of mini_parallel_tpu/models/kmer_model.py.

BASELINE.json config 3: "k-mer counting (k=21) over one FASTQ lane with
exact count parity". Reads cross to the device 2-bit packed
(ops/packed.py); each batch is counted by one sort on the device
(ops/kmer.py); the counts of all batches stay on the device in a
``DeviceKmerAccumulator`` until one drain at the end, or a summary that
never drains the table. The host-store path (``device_accumulate=False``)
fetches each batch's distinct keys into the native hash store
(native/kmer_store.cpp), or a dict where that library is not built. A
device mesh (``mesh=``) takes the host-store path: each shard sorts and
dedups its rows on its device, and the store merges every shard's distinct
keys. In summary mode the host-store path keeps the summary (distinct
count, histogram, top-N) of the merged store and no table, as the device
path does.

Keys are one int64 (ops/kmer.py); checkpoints keep the JAX package's
``.npz`` layout (``hi``, ``lo`` int32, ``ct`` int64, ``meta`` JSON), so a
checkpoint of either package resumes in the other.
"""

from __future__ import annotations

import gzip
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mini_parallel_tpu_torch.device import require_cuda
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.native import BuildError, kmer_store
from mini_parallel_tpu_torch.ops import encode, kmer
from mini_parallel_tpu_torch.ops import packed as packedmod
from mini_parallel_tpu_torch.ops.kmer import EMPTY_ARRAYS, merge_sorted_arrays
from mini_parallel_tpu_torch.parallel.mesh import mesh_device, put_sharded
from mini_parallel_tpu_torch.utils.config import Config

WRITE_BLOCK = 1 << 20  # k-mers formatted and written at a time


@dataclass
class KmerResult:
    file_path: str
    k: int
    canonical: bool
    total_kmers: int = 0
    distinct_kmers: int = 0
    total_reads: int = 0
    seconds: float = 0.0
    # (keys, counts) int64 arrays of the distinct k-mers, keys ascending
    # (empty in summary mode: the table never left the device)
    arrays: tuple = ()
    # summary mode (DeviceKmerAccumulator.summary): the multiplicity
    # histogram and the top-N (key, count) pairs
    count_histogram: np.ndarray | None = None
    top_items: list = field(default_factory=list)

    def _require_full(self, what: str) -> None:
        if not self.arrays and self.distinct_kmers > 0:
            raise ValueError(
                f"{what} needs the full count table, but this result is "
                f"summary-mode (the table never left the device); re-run "
                f"with result_mode='full' (CLI: --kmer-out)"
            )

    @property
    def counts(self) -> dict:
        """key -> count dict. O(distinct): use .arrays for large runs."""
        self._require_full("counts")
        if not self.arrays:
            return {}
        return dict(zip(self.arrays[0].tolist(), self.arrays[1].tolist()))

    def top(self, n: int = 10) -> list[tuple[str, int]]:
        """The n most frequent k-mers, by count descending, ties by
        ascending k-mer."""
        if not self.arrays:
            if n > len(self.top_items) and self.distinct_kmers > len(
                    self.top_items):
                raise ValueError(
                    f"summary mode kept only the top {len(self.top_items)} "
                    f"k-mers; re-run with count_file(..., summary_top_n>="
                    f"{n}) or result_mode='full' for top({n})"
                )
            return [(kmer.key_to_string(key, self.k), c)
                    for key, c in self.top_items[:n]]
        keys, counts = self.arrays
        order = np.lexsort((keys, -counts))[:n]
        return [(kmer.key_to_string(int(keys[i]), self.k), int(counts[i]))
                for i in order]

    def histogram(self, bins: int = 64) -> np.ndarray:
        """Multiplicity histogram: out[c-1] = distinct k-mers with count c
        (c < bins), out[bins-1] = the tail. A summary-mode histogram can be
        re-binned down exactly, never up."""
        if self.count_histogram is not None:
            h = self.count_histogram
            if h.size == bins:
                return h.copy()
            if bins > h.size:
                raise ValueError(
                    f"summary kept {h.size} bins; cannot expand to {bins} "
                    f"(tail bin is aggregated) — use result_mode='full'"
                )
            out = np.zeros(bins, np.int64)
            out[: bins - 1] = h[: bins - 1]
            out[bins - 1] = int(h[bins - 1:].sum())
            return out
        out = np.zeros(bins, np.int64)
        if self.arrays:
            ct = np.minimum(self.arrays[1], bins)
            out[:] = np.bincount(ct, minlength=bins + 1)[1:bins + 1]
        return out

    def write_counts(self, path: str) -> int:
        """Write every distinct k-mer as a "<kmer>\\t<count>" line in key
        order (gzip when the path ends in .gz), the JAX package's bytes;
        returns the number of lines. Lines are formatted in NumPy a block
        at a time, not one k-mer at a time."""
        self._require_full("write_counts")
        keys, counts = self.arrays if self.arrays else EMPTY_ARRAYS
        if not kmer.sorted_unique(keys):
            order = np.argsort(keys, kind="stable")
            keys, counts = keys[order], counts[order]
        opener = gzip.open if path.endswith(".gz") else open
        tmp = path + ".tmp"
        with opener(tmp, "wb") as f:
            for s in range(0, keys.size, WRITE_BLOCK):
                f.write(count_lines(keys[s:s + WRITE_BLOCK],
                                    counts[s:s + WRITE_BLOCK], self.k))
        os.replace(tmp, path)
        return int(keys.size)


def count_lines(keys: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    """The "<kmer>\\t<count>\\n" lines of (keys, counts >= 1) as bytes.

    Each line's start follows from the digit counts; the bases, the tab,
    the newline and the digits (least significant first, over the lines
    that still have one) are each scattered to their offsets in one pass
    over the block."""
    keys = np.asarray(keys, np.int64)
    counts = np.asarray(counts, np.int64)
    ndig = np.ones(keys.size, np.int64)
    p = 10
    while keys.size and p <= counts.max():
        ndig += counts >= p
        p *= 10
    ends = np.cumsum(k + 2 + ndig)
    starts = ends - (k + 2 + ndig)
    out = np.empty(int(ends[-1]) if keys.size else 0, np.uint8)
    for j in range(k):
        out[starts + j] = kmer.ACGT[(keys >> (2 * (k - 1 - j))) & 3]
    out[starts + k] = ord("\t")
    out[ends - 1] = ord("\n")
    pos, rest = ends - 2, counts
    for d in range(int(ndig.max()) if keys.size else 0):
        live = ndig > d
        out[pos[live]] = rest[live] % 10 + ord("0")
        pos, rest = pos - 1, rest // 10
    return out.tobytes()


def summarize_counts(keys: np.ndarray, counts: np.ndarray, top_n: int,
                     hist_bins: int = 64) -> tuple[np.ndarray, list]:
    """The summary of a host table, as DeviceKmerAccumulator.summary gives
    it: the multiplicity histogram (the last bin holds every count >=
    ``hist_bins``) and the top-N (key, count) pairs, by count descending,
    ties by ascending key."""
    hist = np.bincount(np.minimum(counts, hist_bins),
                       minlength=hist_bins + 1)[1:hist_bins + 1]
    top = np.lexsort((keys, -counts))[:top_n]
    return (hist.astype(np.int64),
            list(zip(keys[top].tolist(), counts[top].tolist())))


def save_kmer_checkpoint(path: str, arrays: tuple, meta: dict) -> None:
    """Atomic .npz snapshot of the counts so far and the resume metadata,
    in the JAX package's layout: keys as (hi, lo) int32 words of
    ``meta["k"]``."""
    hi, lo = kmer.split_keys(arrays[0], meta["k"])
    tmp = path + ".tmp.npz"
    np.savez(tmp, hi=hi, lo=lo, ct=np.asarray(arrays[1], np.int64),
             meta=np.array(json.dumps(meta)))
    os.replace(tmp, path)


def load_kmer_checkpoint(path: str):
    """-> ((keys, counts), meta), keys ascending, or None when no checkpoint
    exists. Reads the JAX package's checkpoints too (whose k = 31 keys are
    in its signed order)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        keys = kmer.join_keys(z["hi"], z["lo"], meta["k"])
        counts = z["ct"].astype(np.int64)
    return merge_sorted_arrays(EMPTY_ARRAYS, (keys, counts)), meta


class KmerEngine:
    def __init__(self, cfg: Config | None = None, k: int = kmer.DEFAULT_K,
                 canonical: bool = False, mesh=None,
                 device_accumulate: bool = True,
                 device_capacity: int | None = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg or Config(chunk_size_reads=10_000)
        self.k = k
        self.canonical = canonical
        self.device_accumulate = device_accumulate
        self.device_capacity = device_capacity
        self.mesh = mesh
        self.device = require_cuda(mesh_device(mesh, device))

    def make_store(self):
        """The native hash store when its library builds, else a dict."""
        try:
            # 4M slots: spares the early rehashes of a table that grows
            # toward 10^7+ distinct keys
            return kmer_store.KmerStore(initial_capacity=1 << 22)
        except BuildError:
            return {}

    def _pad_for(self, maxlen: int) -> int:
        pad = max(self.cfg.read_pad, self.k + 7, maxlen)
        return -(-pad // 8) * 8

    def _count_device(self, arr: np.ndarray, lens: np.ndarray):
        """(keys, counts, n_unique) of one padded batch, on the device."""
        return kmer.unique_counts_packed(
            *packedmod.device_args(packedmod.pack_batch(arr, lens),
                                   self.device),
            k=self.k, canonical=self.canonical)

    def count_reads_batch(self, reads: list[bytes], agg) -> tuple[int, int]:
        """Count one batch on the device and merge it into ``agg`` (a
        KmerStore or a dict). Returns (k-mers in the batch, reads)."""
        pad = self._pad_for(max((len(r) for r in reads), default=1))
        arr, lens = encode.pad_batch(reads, pad_to=pad,
                                     pad_value=int(encode.PAD_A))
        return self._count_arr_batch(arr, lens, agg)

    def _count_arr_batch(self, arr, lens, agg) -> tuple[int, int]:
        if self.mesh is not None:
            parts = [kmer.unique_counts_packed(*args, k=self.k,
                                               canonical=self.canonical)
                     for args in put_sharded(
                         packedmod.pack_batch(arr, lens), self.mesh)]
        else:
            parts = [self._count_device(arr, lens)]
        total = 0
        for keys, counts, _ in parts:  # each shard's distinct keys
            keys, counts = keys.cpu().numpy(), counts.cpu().numpy()
            if isinstance(agg, dict):
                kmer.merge_device_counts(agg, keys, counts)
            else:
                agg.merge(keys, counts)
            total += int(counts.sum())
        return total, arr.shape[0]

    def _checkpoint_meta(self, path: str, res: KmerResult,
                         chunks_done: int) -> dict:
        return {
            "file_path": path, "k": self.k, "canonical": self.canonical,
            "chunk_size_reads": self.cfg.chunk_size_reads,
            "chunks_done": chunks_done, "total_reads": res.total_reads,
            "total_kmers": res.total_kmers,
        }

    @staticmethod
    def _agg_arrays(agg) -> tuple[np.ndarray, np.ndarray]:
        """(keys, counts) of a host store's contents, in any order."""
        if isinstance(agg, dict):
            return (np.fromiter(agg.keys(), np.int64, len(agg)),
                    np.fromiter(agg.values(), np.int64, len(agg)))
        return agg.items_arrays()

    def _load_resume(self, checkpoint_path: str | None, res: KmerResult,
                     file_path: str | None = None):
        """-> (base arrays, start_chunk). A checkpoint of another k,
        canonical mode, chunk size or input is refused: resuming it would
        corrupt the counts."""
        if not checkpoint_path:
            return EMPTY_ARRAYS, 0
        loaded = load_kmer_checkpoint(checkpoint_path)
        if loaded is None:
            return EMPTY_ARRAYS, 0
        base, meta = loaded
        for key, val in (("k", self.k), ("canonical", self.canonical),
                         ("chunk_size_reads", self.cfg.chunk_size_reads),
                         ("file_path", file_path)):
            if meta.get(key) != val:
                raise ValueError(
                    f"k-mer checkpoint {checkpoint_path} has {key}="
                    f"{meta.get(key)!r} but this run uses {key}={val!r}"
                )
        res.total_reads = int(meta["total_reads"])
        res.total_kmers = int(meta["total_kmers"])
        return base, int(meta["chunks_done"])

    def _new_accumulator(self) -> kmer.DeviceKmerAccumulator:
        cap = self.device_capacity
        if cap is None:
            cap = 1 << 25 if self.device.type == "cuda" else 1 << 20
        return kmer.DeviceKmerAccumulator(capacity=cap)

    def _count_file_device(self, paths: list, res: KmerResult, progress,
                           start_chunk: int, base: tuple,
                           checkpoint_path: str | None,
                           checkpoint_every: int, result_mode: str,
                           summary_top_n: int) -> None:
        """The counts of every batch stay on the device; the k-mer total
        is summed there too. A checkpoint drains the accumulator into the
        host ``base`` and starts a fresh one; the result is base + the
        final drain (or the final summary, when there is no base)."""
        acc = self._new_accumulator()
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        chunk_size = self.cfg.chunk_size_reads
        min_pad = self._pad_for(1)
        joined = "|".join(paths)
        with fastq.prefetch(fastq.iter_flat_chunks_multi(
                paths, chunk_size, progress=progress)) as batches:
            for idx, (flat, offs) in enumerate(batches):
                if idx < start_chunk:  # counted before the checkpoint
                    continue
                n_reads = len(offs) - 1
                res.total_reads += n_reads
                maxlen = int(np.diff(offs).max()) if n_reads else 1
                pad = min_pad
                while pad < maxlen:  # powers of two: few batch widths
                    pad *= 2
                arr, lens = encode.pad_batch_flat(
                    flat, offs, pad_to=pad, pad_value=int(encode.PAD_A))
                keys, counts, _ = self._count_device(arr, lens)
                acc.add(keys, counts)
                total += counts.sum()
                if (checkpoint_path and checkpoint_every
                        and (idx + 1) % checkpoint_every == 0):
                    res.total_kmers += int(total)
                    total.zero_()
                    base = merge_sorted_arrays(base, acc.drain())
                    acc = self._new_accumulator()
                    save_kmer_checkpoint(
                        checkpoint_path, base,
                        self._checkpoint_meta(joined, res, idx + 1))
        res.total_kmers += int(total)
        if result_mode == "summary" and base[0].size == 0:
            s = acc.summary(top_n=summary_top_n)
            if s is not None:  # exact without the host spill pair
                res.distinct_kmers = s["n_unique"]
                res.count_histogram = s["hist"]
                res.top_items = s["top"]
                return
        keys, counts = merge_sorted_arrays(base, acc.drain())
        res.arrays = (keys, counts)
        res.distinct_kmers = int(keys.size)

    def count_file(self, path, progress=None,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 0,
                   result_mode: str = "full",
                   summary_top_n: int = 10) -> KmerResult:
        """Count one FASTQ lane, or a sample's lanes in order (``path`` a
        list: chunk indices, and so checkpoint resume points, run across
        the list). ``checkpoint_path`` + ``checkpoint_every`` write an .npz
        snapshot every N chunks, from which a rerun resumes exactly.

        ``result_mode="summary"`` computes the distinct count, histogram
        and top-N on the device and never drains the table (``arrays``
        stays empty); it takes the full drain wherever exactness needs the
        host (a spill, a resumed base). On the host-store path (a mesh, or
        ``device_accumulate=False``) the summary is that of the merged
        store, and ``arrays`` stays empty too."""
        if result_mode not in ("full", "summary"):
            raise ValueError(f"unknown result_mode {result_mode!r}")
        paths = fastq.as_paths(path)
        joined = "|".join(paths)
        res = KmerResult(file_path=joined, k=self.k, canonical=self.canonical)
        t0 = time.perf_counter()
        base, start_chunk = self._load_resume(checkpoint_path, res,
                                              file_path=joined)
        if self.device_accumulate and self.mesh is None:
            self._count_file_device(
                paths, res, progress, start_chunk, base, checkpoint_path,
                checkpoint_every, result_mode, summary_top_n)
            res.seconds = time.perf_counter() - t0
            return res
        agg = self.make_store()
        with fastq.prefetch(fastq.iter_flat_chunks_multi(
                paths, self.cfg.chunk_size_reads,
                progress=progress)) as batches:
            for idx, (flat, offs) in enumerate(batches):
                if idx < start_chunk:
                    continue
                pad = self._pad_for(int(np.diff(offs).max()) if len(offs) > 1
                                    else 1)
                arr, lens = encode.pad_batch_flat(
                    flat, offs, pad_to=pad, pad_value=int(encode.PAD_A))
                n_kmers, n_reads = self._count_arr_batch(arr, lens, agg)
                res.total_kmers += n_kmers
                res.total_reads += n_reads
                if (checkpoint_path and checkpoint_every
                        and (idx + 1) % checkpoint_every == 0):
                    base = merge_sorted_arrays(base, self._agg_arrays(agg))
                    agg = self.make_store()
                    save_kmer_checkpoint(
                        checkpoint_path, base,
                        self._checkpoint_meta(joined, res, idx + 1))
        keys, counts = merge_sorted_arrays(base, self._agg_arrays(agg))
        res.distinct_kmers = int(keys.size)
        if result_mode == "summary":
            res.count_histogram, res.top_items = summarize_counts(
                keys, counts, summary_top_n)
        else:
            res.arrays = (keys, counts)
        res.seconds = time.perf_counter() - t0
        return res
