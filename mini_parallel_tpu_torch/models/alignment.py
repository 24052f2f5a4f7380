"""Alignment engine: the counterpart of mini_parallel_tpu/models/alignment.py
for the ``kadane`` and ``sw`` modes on one device.

Maps the reference orchestration (`smith_waterman/src/aligner.rs`) onto
batched device calls: chunks are staged into padded uint8 buckets, scores
are summed on the device, and the host reads the running total only at
checkpoints and at file end.

Scoring modes:
- ``kadane`` (default): bit-parity with the reference's live kernel
  (ops/kadane.py). Self-alignment chunks score 2 (>= 1000 bases) or 0.
- ``sw``: true Smith-Waterman; each read is scored against itself through
  the CUDA kernel on the card (ops/sw_cuda.py), 2 * len per read.

Not yet ported (raise NotImplementedError): ``sw-affine`` and
``contiguous``, sw pairs longer than LONG_PAIR_THRESHOLD (the JAX package's
sw_long route), device meshes, and pair-file mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mini_parallel_tpu_torch.device import require_cuda
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.ops import encode, kadane, sw
from mini_parallel_tpu_torch.ops import packed as packedmod
from mini_parallel_tpu_torch.ops.sw_cuda import sw_score_batch_best
from mini_parallel_tpu_torch.utils.config import Config
from mini_parallel_tpu_torch.utils.system_info import get_system_info

MIN_SELF_CHUNK_BASES = 1000  # aligner.rs:366-368: skip chunks < 1000 bases
# The device-side score accumulator is int64 (torch sums int32 scores into
# int64). It is still folded into the exact host total before its tracked
# magnitude bound could leave int64 range, as the JAX package folds its
# int32 accumulator at 1 << 30.
_ACC_LIMIT = 1 << 62
_EMPTY = np.empty(0, np.uint8)  # zero-length batch-pad row (scores 0)
MODES = ("kadane", "sw")


class SequenceTooLarge(ValueError):
    """Mirror of the reference's launch guard (aligner.rs:445-455)."""


def check_device_budget(batch_bytes: int, device: torch.device) -> None:
    """Refuse launches that would overrun the device memory budget:
    available_memory / 3, as the reference (aligner.rs:436-456,
    system_info.rs:236-243). A no-op on the CPU."""
    budget = get_system_info(device).available_device_memory_bytes()
    if budget is None:
        return
    limit = budget // 3  # 3x overhead rule, aligner.rs:440
    if batch_bytes > limit:
        raise SequenceTooLarge(
            f"Batch too large ({batch_bytes} bytes), max allowed: {limit} "
            f"bytes ({limit // (1024*1024)} MB). Device budget: "
            f"{budget // (1024*1024)} MB"
        )


def _bucket(n: int, floor: int = 1 << 10) -> int:
    """Round up to a power of two (bounded shape count across chunk sizes)."""
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclass
class FileResult:
    file_path: str
    score: int = 0
    total_bases: int = 0
    total_reads: int = 0
    chunks: int = 0
    seconds: float = 0.0
    failed_chunks: int = 0  # skipped per aligner.rs:284-287 semantics
    # wall seconds the host spent blocked reading the device accumulator
    # (each read waits for the device work queued before it)
    drain_seconds: float = 0.0
    # wall seconds blocked on the first result of each new batch shape
    warmup_seconds: float = 0.0


class AlignmentEngine:
    """Host-side orchestrator for alignment scoring on one device."""

    # Direct sw pairs above this length took the JAX package's strip
    # engine (ops/sw_long.py), which is not ported yet.
    LONG_PAIR_THRESHOLD = 2048

    def __init__(self, cfg: Config | None = None, mode: str | None = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg or Config(chunk_size_reads=10_000)
        self.mode = mode or self.cfg.mode
        if self.mode in ("sw-affine", "contiguous"):
            raise NotImplementedError(f"mode {self.mode!r} is not yet ported")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.cfg.mesh_shape:
            raise NotImplementedError(
                "device meshes (MPT_MESH_SHAPE) are not yet ported")
        self.device = require_cuda(device)
        # batch shapes whose first result has been awaited; that first wait
        # is charged to warmup_seconds instead of drain_seconds
        self._warm_shapes: set = set()

    # ------------------------------------------------------------------
    # 2-bit packed transfer path (ops/packed.py): 4x fewer H2D bytes,
    # bit-exact (exceptions restore non-ACGT bytes, pads refill from lens)
    # ------------------------------------------------------------------
    def _local_scores(self, kind: str, a, b, la, lb) -> torch.Tensor:
        """Per-pair device scores for already-unpacked operands."""
        if kind == "sw":
            return sw_score_batch_best(a, b)
        return kadane.kadane_score_batch(a, b, la, lb)

    def _packed_fn(self, kind: str, shape: str):
        """Scorer over packed device operands.

        shape="self": one packed batch scored against itself (sum scalar).
        shape="pair": two packed batches, per-pair scores (B,).
        """
        def self_fn(pk, ec, ev, ln):
            a = packedmod.unpack_device(pk, ec, ev, ln, int(encode.PAD_A))
            b = (packedmod.unpack_device(pk, ec, ev, ln, int(encode.PAD_B))
                 if kind == "sw" else a)
            return self._local_scores(kind, a, b, ln, ln).sum()

        def pair_fn(pka, eca, eva, lna, pkb, ecb, evb, lnb):
            a = packedmod.unpack_device(pka, eca, eva, lna, int(encode.PAD_A))
            b = packedmod.unpack_device(pkb, ecb, evb, lnb, int(encode.PAD_B))
            return self._local_scores(kind, a, b, lna, lnb)

        return self_fn if shape == "self" else pair_fn

    def _packed_self_sum(self, kind: str, arr: np.ndarray,
                         lens: np.ndarray) -> torch.Tensor:
        """Pack a self-alignment batch and queue its device score sum."""
        pb = packedmod.pack_batch(arr, lens)
        return self._packed_fn(kind, "self")(
            *packedmod.device_args(pb, self.device))

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------
    # Core batched primitives
    # ------------------------------------------------------------------
    def score_read_batch(self, reads_a: list[bytes], reads_b: list[bytes],
                         defer: bool = False):
        """Per-pair scores for two read lists (same length), one device call.

        defer=True returns the device tensor without copying it to the host."""
        pad = _bucket(
            max(max((len(r) for r in reads_a), default=1),
                max((len(r) for r in reads_b), default=1)),
            floor=self.cfg.read_pad,
        )
        check_device_budget(2 * len(reads_a) * pad, self.device)
        arr_a, len_a = encode.pad_batch(reads_a, pad_to=pad, pad_value=int(encode.PAD_A))
        arr_b, len_b = encode.pad_batch(reads_b, pad_to=pad, pad_value=int(encode.PAD_B))
        return self._score_pair_arrays(arr_a, len_a, arr_b, len_b, pad, defer)

    def _score_pair_arrays(self, arr_a, len_a, arr_b, len_b, pad, defer):
        if self.cfg.packed_transfer and pad % 4 == 0:
            pa = packedmod.pack_batch(arr_a, len_a)
            pb = packedmod.pack_batch(arr_b, len_b)
            out = self._packed_fn(self.mode, "pair")(
                *packedmod.device_args(pa, self.device),
                *packedmod.device_args(pb, self.device))
        else:
            out = self._local_scores(
                self.mode, self._to_device(arr_a), self._to_device(arr_b),
                self._to_device(len_a), self._to_device(len_b))
        return out if defer else out.cpu().numpy()

    def _score_concat_pair(self, concat1: bytes, concat2: bytes) -> int:
        """Parity path for a direct pair: gpu_align(seq1, seq2)
        (aligner.rs:392-394)."""
        pad = _bucket(max(len(concat1), len(concat2), 1))
        arr_a, la = encode.pad_batch([concat1], pad_to=pad, pad_value=int(encode.PAD_A))
        arr_b, lb = encode.pad_batch([concat2], pad_to=pad, pad_value=int(encode.PAD_B))
        out = kadane.kadane_score_batch(
            self._to_device(arr_a), self._to_device(arr_b),
            self._to_device(la), self._to_device(lb))
        return int(out[0])

    # ------------------------------------------------------------------
    # CLI-facing modes
    # ------------------------------------------------------------------
    def score_strings(self, s1: str | bytes, s2: str | bytes) -> int:
        """Direct two-string mode (main.rs:183-191)."""
        if isinstance(s1, str):
            s1 = s1.encode("ascii")
        if isinstance(s2, str):
            s2 = s2.encode("ascii")
        if self.mode == "sw":
            if max(len(s1), len(s2)) > self.LONG_PAIR_THRESHOLD:
                raise NotImplementedError(
                    f"sw pairs longer than {self.LONG_PAIR_THRESHOLD} bases "
                    "(the long-pair strip engine) are not yet ported")
            return sw.sw_score_pair(s1, s2, self.device)
        n = min(len(s1), len(s2))
        if not kadane.degenerate_regime(n):
            # exact strided emulation for absurdly long inputs (host)
            return kadane.reference_align_score(s1, s2)
        return self._score_concat_pair(s1, s2) if n else 0

    def self_align_file(
        self,
        path: str,
        progress=None,
        on_chunk=None,
        device_batch_chunks: int = 8,
        resume=None,
        checkpoint_every: int = 0,
        on_checkpoint=None,
    ) -> FileResult:
        """--full-wgs per-file loop: chunked self-alignment
        (aligner.rs:262-295), several chunk-concats per device call.

        Chunk-level resume: ``resume`` is any object with
        ``chunks_done/score/total_bases/total_reads`` — the first
        ``chunks_done`` chunks are skipped and the partial totals seeded.
        ``checkpoint_every`` > 0 drains the device accumulator every N
        chunks and calls ``on_checkpoint(res)``. Chunk scores are
        independent sums, so skip+seed is bit-exact.
        """
        res = FileResult(file_path=path)
        start_chunk = 0
        prior_seconds = 0.0
        if resume is not None:
            start_chunk = int(getattr(resume, "chunks_done", 0))
            res.score = resume.score
            res.total_bases = resume.total_bases
            res.total_reads = resume.total_reads
            res.chunks = start_chunk
            # per-file time covers every attempt, not just the last one
            ms = getattr(resume, "processing_time_ms", None)
            prior_seconds = (ms / 1000.0 if ms is not None
                             else getattr(resume, "seconds", 0.0))
        t0 = time.perf_counter()
        pending: list[np.ndarray] = []
        # acc = [device int64 scalar, score-magnitude bound]: every score
        # here is in [0, 2*bases]; the host total stays exact by folding
        # the device scalar in before the bound could reach _ACC_LIMIT.
        # Nothing blocks on the device until a checkpoint or file end.
        acc: list = [None, 0]

        def drain():
            if acc[0] is not None:
                td = time.perf_counter()
                res.score += int(acc[0].item())
                res.drain_seconds += time.perf_counter() - td
            acc[0], acc[1] = None, 0

        def enqueue(val: torch.Tensor, bound: int):
            if acc[0] is not None and acc[1] + bound > _ACC_LIMIT:
                drain()  # rare overflow-safety fold
            acc[0] = val if acc[0] is None else acc[0] + val
            acc[1] += bound

        def warm(key, val: torch.Tensor) -> torch.Tensor:
            """First result of a new batch shape: wait for it now and charge
            the wait to warmup_seconds, so drain_seconds stays steady-state."""
            if key not in self._warm_shapes:
                tw = time.perf_counter()
                val.item()
                res.warmup_seconds += time.perf_counter() - tw
                self._warm_shapes.add(key)
            return val

        def dispatch(batch: list[np.ndarray]) -> torch.Tensor:
            """Queue one device call scoring a batch of chunk-concats;
            returns the deferred per-batch score sum."""
            # a fixed row count keeps the last batch on the same shape
            batch = batch + [_EMPTY] * (device_batch_chunks - len(batch))
            pad = _bucket(max(len(c) for c in batch))
            check_device_budget(len(batch) * pad, self.device)
            arr, lens = encode.pad_batch(
                batch, pad_to=pad, pad_value=int(encode.PAD_A))
            key = ("concat", "kadane", pad, len(batch))
            if self.cfg.packed_transfer and pad % 4 == 0:
                return warm(key, self._packed_self_sum("kadane", arr, lens))
            a, ln = self._to_device(arr), self._to_device(lens)
            return warm(key, kadane.kadane_score_batch(a, a, ln, ln).sum())

        def skip_failed(e: Exception):
            # reference semantics (aligner.rs:284-287): log the per-chunk
            # failure and keep going — the chunk scores 0
            res.failed_chunks += 1
            if progress is not None:
                progress(f"    Alignment failed for chunk: {e}")

        def flush():
            if not pending:
                return
            batch, pending[:] = list(pending), []
            try:
                enqueue(dispatch(batch), 2 * sum(len(c) for c in batch))
            except Exception:
                # batch failed (e.g. one oversized chunk blew the device
                # budget): retry chunk by chunk so only the bad ones skip
                for c in batch:
                    try:
                        enqueue(dispatch([c]), 2 * len(c))
                    except Exception as e1:
                        skip_failed(e1)

        def maybe_checkpoint():
            if not (checkpoint_every and on_checkpoint):
                return
            if res.chunks % checkpoint_every:
                return
            flush()
            drain()
            res.seconds = prior_seconds + (time.perf_counter() - t0)
            on_checkpoint(res)

        # flat (bytes, offsets) chunks, decoded on a producer thread that
        # overlaps pad/pack/dispatch and stops when this loop ends
        with fastq.prefetch(fastq.iter_flat_chunks(
                path, self.cfg.chunk_size_reads, progress=progress)) as chunks_it:
            for idx, (flat, offs) in enumerate(chunks_it):
                if idx < start_chunk:  # resume: already scored in a prior run
                    continue
                n_reads = len(offs) - 1
                res.total_reads += n_reads
                res.chunks += 1
                res.total_bases += int(flat.size)
                if self.mode == "sw":
                    self._self_align_reads(flat, offs, n_reads, enqueue, warm,
                                           skip_failed)
                elif flat.size >= MIN_SELF_CHUNK_BASES:  # aligner.rs:366-368
                    # the flat buffer IS the chunk-concat (reads back to back)
                    pending.append(flat)
                    if len(pending) >= device_batch_chunks:
                        flush()
                if on_chunk is not None:
                    on_chunk(res)
                maybe_checkpoint()
        flush()
        drain()  # one blocking read of the device total per file
        res.seconds = prior_seconds + (time.perf_counter() - t0)
        return res

    def _self_align_reads(self, flat, offs, n_reads, enqueue, warm,
                          skip_failed) -> None:
        """sw mode: queue one chunk's reads, each against itself."""
        pad = _bucket(int(np.diff(offs).max()) if n_reads else 1,
                      floor=self.cfg.read_pad)
        # bucket the ROW count too, so the final partial chunk reuses the
        # full chunks' shape (zero-length pad rows score 0 by the
        # PAD_A-vs-PAD_B sentinel contract)
        Bp = (n_reads if n_reads >= self.cfg.chunk_size_reads
              else min(self.cfg.chunk_size_reads, _bucket(n_reads, floor=128)))
        key = ("reads", self.mode, pad, Bp)
        try:
            arr_a, la = encode.pad_batch_flat(
                flat, offs, pad_to=pad, pad_value=int(encode.PAD_A),
                rows_to=Bp)
            bound = 2 * int(flat.size)
            if self.cfg.packed_transfer and pad % 4 == 0:
                enqueue(warm(key, self._packed_self_sum(self.mode, arr_a, la)),
                        bound)
            else:
                arr_b = np.where(
                    np.arange(pad, dtype=np.int32)[None, :] < la[:, None],
                    arr_a, encode.PAD_B)
                scores = sw_score_batch_best(self._to_device(arr_a),
                                             self._to_device(arr_b))
                enqueue(warm(key, scores.sum()), bound)
        except Exception as e:
            skip_failed(e)

    def pair_align_files(self, file1: str, file2: str, progress=None):
        """--files pair mode (aligner.rs:376-407)."""
        raise NotImplementedError("pair-file mode (--files) is not yet ported")
