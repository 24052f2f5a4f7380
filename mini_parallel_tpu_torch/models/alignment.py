"""Alignment engine: the counterpart of mini_parallel_tpu/models/alignment.py.

Maps the reference orchestration (`smith_waterman/src/aligner.rs`) onto
batched device calls: chunks are staged into padded uint8 buckets, scores
are summed on the device, and the host reads the running total only at
checkpoints and at file end.

Scoring modes:
- ``kadane`` (default): bit-parity with the reference's live kernel
  (ops/kadane.py). Self-alignment chunks score 2 (>= 1000 bases) or 0.
- ``sw``: true Smith-Waterman; each read is scored against itself through
  the CUDA kernel on the card (ops/sw_cuda.py), 2 * len per read; pair
  mode aligns mate reads r1[i] x r2[i].
- ``sw-affine``: the same with affine gaps (``cfg.gap_open``,
  ``cfg.gap_extend``), through the affine CUDA kernel.
- ``contiguous``: contiguous Kadane, exact via the segment monoid.

Direct pairs longer than LONG_PAIR_THRESHOLD take the column-strip engine
(ops/sw_long.py).

With a device mesh (``mesh=``, parallel/mesh.py) the self-alignment sums
and the per-pair scores of packed batches shard data-parallel: rows are
padded to the shard count with zero-length rows (which score 0 by the
sentinel and min-length contracts), each shard runs the same scorer on its
device, and the sums merge in shard order (parallel/collectives.py).
Without a mesh the same path runs on a mesh of one shard, the engine's
device.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from mini_parallel_tpu_torch.device import require_cuda
from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.ops import encode, kadane, sw, sw_long
from mini_parallel_tpu_torch.ops import packed as packedmod
from mini_parallel_tpu_torch.ops.sw_cuda import (
    sw_affine_batch_best,
    sw_score_batch_best,
)
from mini_parallel_tpu_torch.parallel import collectives
from mini_parallel_tpu_torch.parallel.mesh import (
    engine_mesh,
    mesh_device,
    put_sharded,
)
from mini_parallel_tpu_torch.utils import spans
from mini_parallel_tpu_torch.utils.config import Config
from mini_parallel_tpu_torch.utils.system_info import get_system_info

MIN_SELF_CHUNK_BASES = 1000  # aligner.rs:366-368: skip chunks < 1000 bases
# The device-side score accumulator is int64 (torch sums int32 scores into
# int64). It is still folded into the exact host total before its tracked
# magnitude bound could leave int64 range, as the JAX package folds its
# int32 accumulator at 1 << 30.
_ACC_LIMIT = 1 << 62
_EMPTY = np.empty(0, np.uint8)  # zero-length batch-pad row (scores 0)
MODES = ("kadane", "sw", "sw-affine", "contiguous")
TWO_SIDED = ("sw", "sw-affine")  # modes that align reads, not concats


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
    # (each read waits for the device work queued before it): the
    # align.drain.sync spans
    drain_seconds: float = 0.0
    # wall seconds blocked on the first result of each new batch shape:
    # the align.warm.sync spans
    warmup_seconds: float = 0.0


@dataclass
class PairResult:
    score: int
    processing_time_ms: float
    device: str  # the card's name, or "cpu"
    bases1: int = 0
    bases2: int = 0


class AlignmentEngine:
    """Host-side orchestrator for alignment scoring on one device, or on
    the shards of a device mesh."""

    # Direct sw / sw-affine pairs above this length take the column-strip
    # engine (ops/sw_long.py): exact scores, O(M+N) memory, no launch-size
    # cap. Read-scale pairs stay on the batched kernels at B = 1.
    LONG_PAIR_THRESHOLD = 2048

    def __init__(self, cfg: Config | None = None, mode: str | None = None,
                 device: torch.device | str | None = None, mesh=None):
        self.cfg = cfg or Config(chunk_size_reads=10_000)
        self.mode = mode or self.cfg.mode
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        # read batches shard data-parallel over the mesh's first axis (no
        # mesh: one shard, the device); everything unsharded runs on its
        # first device
        self.device = require_cuda(mesh_device(mesh, device))
        self.mesh = engine_mesh(mesh, self.device)
        # batch shapes whose first result has been awaited; that first wait
        # is charged to warmup_seconds instead of drain_seconds
        self._warm_shapes: set = set()

    @property
    def _read_floor(self) -> int:
        """The read-width floor: ``cfg.read_pad`` rounded up to a multiple
        of 4, so that every power-of-two bucket above it packs 4 bases a
        byte."""
        return -(-self.cfg.read_pad // 4) * 4

    # ------------------------------------------------------------------
    # Read batches cross to the device 2-bit packed (ops/packed.py): 4x
    # fewer H2D bytes, bit-exact (exceptions restore non-ACGT bytes, pads
    # refill from lens)
    # ------------------------------------------------------------------
    def _local_scores(self, kind: str, a, b, la, lb) -> torch.Tensor:
        """Per-pair device scores for already-unpacked operands."""
        if kind == "sw":
            return sw_score_batch_best(a, b)
        if kind == "sw-affine":
            return self._affine(a, b)
        if kind == "contiguous":
            return kadane.kadane_contiguous_batch(a, b, la, lb)
        return kadane.kadane_score_batch(a, b, la, lb)

    def _affine(self, a, b) -> torch.Tensor:
        """Affine-gap scores honouring the config's gap costs."""
        return sw_affine_batch_best(a, b, gap_open=self.cfg.gap_open,
                                    gap_extend=self.cfg.gap_extend)

    def _packed_fn(self, kind: str, shape: str):
        """Scorer over packed device operands.

        shape="self": one packed batch scored against itself (sum scalar).
        shape="pair": two packed batches, per-pair scores (B,).
        """
        def self_fn(pk, ec, ev, ln):
            a = packedmod.unpack_device(pk, ec, ev, ln, int(encode.PAD_A))
            b = (packedmod.unpack_device(pk, ec, ev, ln, int(encode.PAD_B))
                 if kind in TWO_SIDED else a)
            return self._local_scores(kind, a, b, ln, ln).sum()

        def pair_fn(pka, eca, eva, lna, pkb, ecb, evb, lnb):
            a = packedmod.unpack_device(pka, eca, eva, lna, int(encode.PAD_A))
            b = packedmod.unpack_device(pkb, ecb, evb, lnb, int(encode.PAD_B))
            return self._local_scores(kind, a, b, lna, lnb)

        return self_fn if shape == "self" else pair_fn

    def _packed_self_sum(self, kind: str, arr: np.ndarray,
                         lens: np.ndarray) -> torch.Tensor:
        """Pack a self-alignment batch and queue its device score sum."""
        with spans.span("align.pack"):
            pb = packedmod.pack_batch(arr, lens)
        with spans.span("align.put"):
            shards = put_sharded(pb, self.mesh)
        fn = self._packed_fn(kind, "self")
        with spans.span("align.launch"):
            return collectives.merge_scores([fn(*args) for args in shards])

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
            floor=self._read_floor,
        )
        check_device_budget(2 * len(reads_a) * pad, self.device)
        arr_a, len_a = encode.pad_batch(reads_a, pad_to=pad, pad_value=int(encode.PAD_A))
        arr_b, len_b = encode.pad_batch(reads_b, pad_to=pad, pad_value=int(encode.PAD_B))
        return self._score_pair_arrays(arr_a, len_a, arr_b, len_b, defer)

    def _score_pair_arrays(self, arr_a, len_a, arr_b, len_b, defer):
        pa = packedmod.pack_batch(arr_a, len_a)
        pb = packedmod.pack_batch(arr_b, len_b)
        fn = self._packed_fn(self.mode, "pair")
        # each shard's scores, gathered in row order; the pad rows past B
        # are cut off
        out = collectives.concat_rows([
            fn(*sa, *sb) for sa, sb in zip(put_sharded(pa, self.mesh),
                                           put_sharded(pb, self.mesh))
        ])[:pa.batch]
        return out if defer else out.cpu().numpy()

    def _score_flat_pairs(self, f1, o1, f2, o2) -> torch.Tensor:
        """Deferred per-pair scores for two flat chunks (same device steps
        as score_read_batch, no per-read Python objects)."""
        m1 = int(np.diff(o1).max()) if len(o1) > 1 else 1
        m2 = int(np.diff(o2).max()) if len(o2) > 1 else 1
        pad = _bucket(max(m1, m2), floor=self._read_floor)
        check_device_budget(2 * (len(o1) - 1) * pad, self.device)
        arr_a, la = encode.pad_batch_flat(
            f1[: int(o1[-1])], o1, pad_to=pad, pad_value=int(encode.PAD_A))
        arr_b, lb = encode.pad_batch_flat(
            f2[: int(o2[-1])], o2, pad_to=pad, pad_value=int(encode.PAD_B))
        return self._score_pair_arrays(arr_a, la, arr_b, lb, True)

    def _concat_kind(self) -> str:
        return "contiguous" if self.mode == "contiguous" else "kadane"

    def _score_concat_pair(self, concat1: bytes, concat2: bytes) -> int:
        """Parity path for a direct pair or one pair-mode chunk pair:
        gpu_align(chunk1.concat, chunk2.concat) (aligner.rs:392-394)."""
        pad = _bucket(max(len(concat1), len(concat2), 1))
        arr_a, la = encode.pad_batch([concat1], pad_to=pad, pad_value=int(encode.PAD_A))
        arr_b, lb = encode.pad_batch([concat2], pad_to=pad, pad_value=int(encode.PAD_B))
        out = self._local_scores(
            self._concat_kind(), self._to_device(arr_a),
            self._to_device(arr_b), self._to_device(la), self._to_device(lb))
        return int(out[0])

    def _pair_batch_fn(self, kind: str):
        """Scorer of one packed chunk1 against a packed batch of chunk2
        concats: chunk1 is unpacked once and broadcast on the device."""
        def fn(pk1, ec1, ev1, ln1, pk2, ec2, ev2, ln2):
            a1 = packedmod.unpack_device(pk1, ec1, ev1, ln1, int(encode.PAD_A))
            b = packedmod.unpack_device(pk2, ec2, ev2, ln2, int(encode.PAD_B))
            a = a1.expand(b.shape)
            la = ln1.expand(ln2.shape)
            return self._local_scores(kind, a, b, la, ln2).sum()

        return fn

    def _score_concat_pair_group(self, concat1: bytes, concats2: list[bytes],
                                 group: int = 8,
                                 c1_cache: dict | None = None) -> torch.Tensor:
        """Deferred score sum of chunk1 vs a group of chunk2 concats in ONE
        device call (empty pad concats score 0 by min-length masking),
        instead of the reference's launch per chunk pair
        (aligner.rs:390-398). ``c1_cache`` (keyed by pad bucket, scoped to
        one outer chunk) avoids re-packing and re-sending chunk1."""
        concats2 = concats2 + [b""] * (group - len(concats2))
        pad = _bucket(max(len(concat1), max(len(c) for c in concats2), 1))
        check_device_budget((1 + len(concats2)) * pad, self.device)
        if c1_cache is None or pad not in c1_cache:
            arr1, l1 = encode.pad_batch(
                [concat1], pad_to=pad, pad_value=int(encode.PAD_A))
            args1 = packedmod.device_args(packedmod.pack_batch(arr1, l1),
                                          self.device)
            if c1_cache is not None:
                c1_cache[pad] = args1
        else:
            args1 = c1_cache[pad]
        arr2, l2 = encode.pad_batch(concats2, pad_to=pad,
                                    pad_value=int(encode.PAD_B))
        p2 = packedmod.pack_batch(arr2, l2)
        return self._pair_batch_fn(self._concat_kind())(
            *args1, *packedmod.device_args(p2, self.device))

    # ------------------------------------------------------------------
    # CLI-facing modes
    # ------------------------------------------------------------------
    def score_strings(self, s1: str | bytes, s2: str | bytes) -> int:
        """Direct two-string mode (main.rs:183-191)."""
        if isinstance(s1, str):
            s1 = s1.encode("ascii")
        if isinstance(s2, str):
            s2 = s2.encode("ascii")
        long_pair = max(len(s1), len(s2)) > self.LONG_PAIR_THRESHOLD
        # rows run along the longer side (fewer, fuller strips)
        a, b = (s1, s2) if len(s1) >= len(s2) else (s2, s1)
        if self.mode == "sw":
            if long_pair:
                return sw_long.sw_score_long(a, b, self.device)
            return sw.sw_score_pair(s1, s2, self.device)
        if self.mode == "sw-affine":
            if long_pair:
                return sw_long.sw_affine_score_long(
                    a, b, self.device, gap_open=self.cfg.gap_open,
                    gap_extend=self.cfg.gap_extend)
            return int(self._affine(*sw.pair_tensors(s1, s2, self.device))[0])
        n = min(len(s1), len(s2))
        if self.mode == "contiguous":
            return self._score_concat_pair(s1, s2) if n else 0
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
        chunk_stride: tuple[int, int] | None = None,
    ) -> FileResult:
        """--full-wgs per-file loop: chunked self-alignment
        (aligner.rs:262-295), several chunk-concats per device call.

        Chunk-level resume: ``resume`` is any object with
        ``chunks_done/score/total_bases/total_reads`` — the first
        ``chunks_done`` chunks are skipped and the partial totals seeded.
        ``checkpoint_every`` > 0 drains the device accumulator every N
        chunks and calls ``on_checkpoint(res)``. Chunk scores are
        independent sums, so skip+seed is bit-exact.

        ``chunk_stride=(p, n)``: the shared-file mode of
        parallel/distributed.py — this process scores only the chunks
        whose index is p mod n (the stripes of n processes merge exactly),
        and ``chunks_done`` of a resume counts OWNED chunks.
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
                with spans.timed("align.drain.sync") as sync:
                    res.score += int(acc[0].item())
                res.drain_seconds += sync.seconds
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
                with spans.timed("align.warm.sync") as sync:
                    val.item()
                res.warmup_seconds += sync.seconds
                self._warm_shapes.add(key)
            return val

        def dispatch(batch: list[np.ndarray]) -> torch.Tensor:
            """Queue one device call scoring a batch of chunk-concats;
            returns the deferred per-batch score sum."""
            # a fixed row count keeps the last batch on the same shape
            batch = batch + [_EMPTY] * (device_batch_chunks - len(batch))
            pad = _bucket(max(len(c) for c in batch))
            check_device_budget(len(batch) * pad, self.device)
            with spans.span("align.pad"):
                arr, lens = encode.pad_batch(
                    batch, pad_to=pad, pad_value=int(encode.PAD_A))
            kind = self._concat_kind()
            key = ("concat", kind, pad, len(batch))
            return warm(key, self._packed_self_sum(kind, arr, lens))

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
        # overlaps pad/pack/dispatch and stops when this block ends
        with spans.span("align.file"), fastq.prefetch(fastq.iter_flat_chunks(
                path, self.cfg.chunk_size_reads,
                progress=progress)) as chunks_it:
            for idx, (flat, offs) in enumerate(chunks_it):
                if chunk_stride is not None:
                    p, n = chunk_stride
                    if idx % n != p or idx // n < start_chunk:
                        continue
                elif idx < start_chunk:  # resume: scored in a prior run
                    continue
                n_reads = len(offs) - 1
                res.total_reads += n_reads
                res.chunks += 1
                res.total_bases += int(flat.size)
                if self.mode in TWO_SIDED:
                    self._self_align_reads(flat, offs, n_reads, enqueue, warm,
                                           skip_failed, idx)
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
                          skip_failed, chunk: int) -> None:
        """sw / sw-affine mode: queue one chunk's reads, each against
        itself, in the span ``align.chunk`` (``chunk``: its index in the
        file's stream)."""
        with spans.span("align.chunk", chunk):
            pad = _bucket(int(np.diff(offs).max()) if n_reads else 1,
                          floor=self._read_floor)
            # bucket the ROW count too, so the final partial chunk reuses the
            # full chunks' shape (zero-length pad rows score 0 by the
            # PAD_A-vs-PAD_B sentinel contract)
            Bp = (n_reads if n_reads >= self.cfg.chunk_size_reads
                  else min(self.cfg.chunk_size_reads,
                           _bucket(n_reads, floor=128)))
            key = ("reads", self.mode, pad, Bp)
            try:
                with spans.span("align.pad"):
                    arr_a, la = encode.pad_batch_flat(
                        flat, offs, pad_to=pad, pad_value=int(encode.PAD_A),
                        rows_to=Bp)
                val = self._packed_self_sum(self.mode, arr_a, la)
                enqueue(warm(key, val), 2 * int(flat.size))
            except Exception as e:
                skip_failed(e)

    def pair_align_files(self, file1: str, file2: str,
                         progress=None) -> PairResult:
        """--files pair mode (aligner.rs:376-407).

        kadane/contiguous: the reference's exact cross-product semantics —
        every chunk of file1 scored against every chunk of file2 (file2
        re-streamed per outer chunk, aligner.rs:390-398).
        sw/sw-affine: mate-pair alignment — reads zipped r1[i] x r2[i] and
        summed, stopping at the shorter file; the cross product is
        meaningless under true DP and O(C1*C2*L^2).
        """
        t0 = time.perf_counter()
        bases1 = fastq.count_bases(file1, self.cfg.chunk_size_reads)
        bases2 = fastq.count_bases(file2, self.cfg.chunk_size_reads)
        deferred: list[torch.Tensor] = []
        if self.mode in TWO_SIDED:
            with contextlib.ExitStack() as stack:
                it1, it2 = (stack.enter_context(fastq.prefetch(
                    fastq.iter_flat_chunks(f, self.cfg.chunk_size_reads)))
                    for f in (file1, file2))
                for (f1, o1), (f2, o2) in zip(it1, it2):
                    n = min(len(o1), len(o2)) - 1
                    if n:
                        deferred.append(self._score_flat_pairs(
                            f1, o1[: n + 1], f2, o2[: n + 1]).sum())
        else:
            # the cross product, chunk2s scored in groups of 8 per device
            # call with a single deferred drain
            for c1 in fastq.iter_read_chunks(file1, self.cfg.chunk_size_reads):
                concat1 = b"".join(c1)
                c1_cache: dict = {}
                group: list[bytes] = []
                for c2 in fastq.iter_read_chunks(file2,
                                                 self.cfg.chunk_size_reads):
                    group.append(b"".join(c2))
                    if len(group) == 8:
                        deferred.append(self._score_concat_pair_group(
                            concat1, group, c1_cache=c1_cache))
                        group = []
                if group:
                    deferred.append(self._score_concat_pair_group(
                        concat1, group, c1_cache=c1_cache))
        # one read of the device total
        total = (int(torch.stack(deferred).to(torch.int64).sum())
                 if deferred else 0)
        ms = (time.perf_counter() - t0) * 1000
        return PairResult(score=total, processing_time_ms=ms,
                          device=get_system_info(self.device).device_kind,
                          bases1=bases1, bases2=bases2)
