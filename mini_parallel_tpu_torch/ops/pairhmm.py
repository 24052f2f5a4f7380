"""Pair-HMM forward algorithm: P(read | haplotype) for genotype likelihoods.
The counterpart of mini_parallel_tpu/ops/pairhmm.py (the constants, the
float64 oracle and the genotype model, copied) and of the host side of
mini_parallel_tpu/ops/pairhmm_pallas.py (the batched forward and
``pairhmm_log10_batch``).

States M (match/mismatch), I (insertion in the read), D (deletion from the
read):

    M[i,j] = prior(i,j) * (tMM*M[i-1,j-1] + tIM*I[i-1,j-1] + tDM*D[i-1,j-1])
    I[i,j] = tMI*M[i-1,j] + tII*I[i-1,j]
    D[i,j] = tMD*M[i,j-1] + tDD*D[i,j-1]

with prior = 1-err if read[i-1] == hap[j-1] else err/3 (err from the
base's Phred quality), transitions from gap-open/extend Phreds (tMM=1-2δ,
tMI=tMD=δ, tII=tDD=ε, tIM=tDM=1-ε), a free start anywhere on the haplotype
through the boundary row D[0,j] = 1/hap_len, and a free end:
P(read|hap) = Σ_j M[m,j] + I[m,j].

- :func:`pairhmm_forward_numpy` is the float64 golden oracle (a Python
  double loop: tests only).
- :func:`pairhmm_batch` is the plain batched forward in torch ops, an
  anti-diagonal sweep: in float32 with the 2^120 scale it computes what the
  TPU kernel computes; in float64 unscaled, the oracle's value.
- :func:`pairhmm_batch_best` routes by device: CPU tensors to the plain
  version, CUDA tensors to ``csrc/pairhmm.cu`` (ops/pairhmm_cuda.py).
- :func:`pairhmm_log10_padded` is the engine's batch: float32 first, then
  the float64 forward on the lanes that underflowed, gathered on the device.
  :func:`pairhmm_log10_batch` is the JAX package's host API over it.
- :func:`make_pairhmm_sharded` splits a batch's lanes over the data axis
  of a device mesh, each shard's lanes through the same forward on its
  device; likelihoods are per lane, so nothing merges but the gather.
  Both batch APIs take ``mesh=`` (the float64 recompute is sharded too);
  without one they run on a mesh of one shard, the operands' device.

A float32 lane counts as underflowed when its scaled total is below the
smallest normal float32 (FLT_MIN): its log10 then never rests on a
denormal, whether or not the platform flushes denormals (XLA on the CPU and
the TPU do; nvcc and PyTorch do not). The lane's scaled log10 floor is
log10(FLT_MIN) - 120 log10(2) ~ -74.06.
"""

from __future__ import annotations

import numpy as np
import torch

from mini_parallel_tpu_torch.device import require_cuda
from mini_parallel_tpu_torch.ops import encode
from mini_parallel_tpu_torch.parallel import collectives
from mini_parallel_tpu_torch.parallel.mesh import (
    engine_mesh,
    mesh_device,
    pad_to_shards,
    shard_batch,
)

DEFAULT_GAP_OPEN_PHRED = 45.0
DEFAULT_GAP_EXT_PHRED = 10.0
SCALE_LOG2 = 120.0  # fp32 initial-condition scale, 2**120
LOG10_2 = float(np.log10(2.0))
# scaled fp32 totals below FLT_MIN count as underflowed: the log10 floor
FP32_FLOOR_LOG10 = float(np.log10(np.finfo(np.float32).tiny)) - SCALE_LOG2 * LOG10_2


def transition_probs(gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                     gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED):
    """(tMM, tMI, tII, tIM) with tMD=tMI and tDD=tII, tDM=tIM."""
    delta = 10.0 ** (-gap_open_phred / 10.0)
    eps = 10.0 ** (-gap_ext_phred / 10.0)
    return 1.0 - 2.0 * delta, delta, eps, 1.0 - eps


def pairhmm_forward_numpy(read: bytes, qual_phred: np.ndarray, hap: bytes,
                          gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                          gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED,
                          ) -> float:
    """Golden float64 oracle. Returns log10 P(read | hap).

    ``qual_phred``: per-base Phred scores (ints or floats, len == len(read)).
    """
    m, n = len(read), len(hap)
    if m == 0 or n == 0:
        return float("-inf")
    tMM, tMI, tII, tIM = transition_probs(gap_open_phred, gap_ext_phred)
    tMD, tDD, tDM = tMI, tII, tIM
    err = 10.0 ** (-np.asarray(qual_phred, np.float64) / 10.0)

    M = np.zeros((m + 1, n + 1))
    I = np.zeros((m + 1, n + 1))
    D = np.zeros((m + 1, n + 1))
    D[0, :] = 1.0 / n
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            prior = 1.0 - err[i - 1] if read[i - 1] == hap[j - 1] \
                else err[i - 1] / 3.0
            M[i, j] = prior * (tMM * M[i - 1, j - 1]
                               + tIM * I[i - 1, j - 1]
                               + tDM * D[i - 1, j - 1])
            I[i, j] = tMI * M[i - 1, j] + tII * I[i - 1, j]
            D[i, j] = tMD * M[i, j - 1] + tDD * D[i, j - 1]
    total = float(M[m, 1:].sum() + I[m, 1:].sum())
    return float(np.log10(total)) if total > 0 else float("-inf")


LL_FLOOR = -300.0  # per-read log10 floor: even float64 can underflow to -inf
# (a read mismatching both haplotypes badly enough); flooring keeps the
# genotype algebra finite — a read that explains NEITHER haplotype carries
# no genotype information, so the exact value below the floor is irrelevant


def genotype_likelihoods(read_ll_ref: np.ndarray, read_ll_alt: np.ndarray,
                         ) -> tuple[float, float, float]:
    """Diploid genotype log10-likelihoods (RR, RA, AA) from per-read
    log10 P(read|ref-hap) and P(read|alt-hap) (GATK's model: each read drawn
    from one of the two genotype haplotypes with probability 1/2)."""
    ref = np.maximum(np.asarray(read_ll_ref, np.float64), LL_FLOOR)
    alt = np.maximum(np.asarray(read_ll_alt, np.float64), LL_FLOOR)
    rr = float(ref.sum())
    aa = float(alt.sum())
    # log10((10^ref + 10^alt) / 2) per read, summed — stable via max-factoring
    hi = np.maximum(ref, alt)
    lo = np.minimum(ref, alt)
    ra = float((hi + np.log10(1.0 + 10.0 ** (lo - hi)) - LOG10_2).sum())
    return rr, ra, aa


def _scalar(x: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-d CPU tensor: ``x`` rounded to ``dtype`` once, as the TPU kernel
    rounds its Python-float constants to float32."""
    return torch.tensor(x, dtype=dtype)


def scale_log2_of(dtype: torch.dtype) -> float:
    """log2 of the initial-condition scale: 2^120 in float32 (the TPU
    kernel's), none in float64."""
    return 0.0 if dtype == torch.float64 else SCALE_LOG2


def pairhmm_batch(reads: torch.Tensor, err: torch.Tensor, haps: torch.Tensor,
                  read_lens: torch.Tensor, hap_lens: torch.Tensor, *,
                  dtype: torch.dtype = torch.float32,
                  gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                  gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED
                  ) -> torch.Tensor:
    """Plain batched Pair-HMM forward on the tensors' device.

    reads (B, M) uint8 padded with PAD_A, err (B, M) per-base error
    probabilities (zero past each read), haps (B, N) uint8 padded with
    PAD_B, read_lens/hap_lens (B,) int32 -> (B,) ``dtype`` log10
    P(read | hap), -inf on empty lanes and on lanes whose total is below
    the smallest normal of ``dtype``.

    The sweep is the TPU kernel's (``_pairhmm_kernel_factory``): diagonal d
    holds cell (i, d - i) of every read row i; M, I and D of the two
    previous diagonals carry the dependencies; the boundary row D[0, j] =
    scale / hap_len (:func:`scale_log2_of`) shifts in at row 0; the final
    read row's M + I is summed in hap-column order. Every operation runs in
    ``dtype``, with the mismatch prior ``err * (1/3)`` and the transitions
    rounded to ``dtype`` once."""
    scale_log2 = scale_log2_of(dtype)
    B, M = reads.shape
    N = haps.shape[1]
    dev = reads.device
    if B == 0 or M == 0 or N == 0:
        return torch.full((B,), float("-inf"), dtype=dtype, device=dev)
    tMM, tMI, tII, tIM = (_scalar(t, dtype) for t in
                          transition_probs(gap_open_phred, gap_ext_phred))
    tMD, tDD, tDM = tMI, tII, tIM
    one, third = _scalar(1.0, dtype), _scalar(1.0 / 3.0, dtype)
    e = err.to(dtype)
    match_p, mis_p = one - e, e * third
    a = reads.to(torch.int32)
    la1 = read_lens.to(torch.int64) - 1
    lb = hap_lens.to(torch.int64)
    scale = _scalar(2.0 ** scale_log2, dtype)
    drow = (scale / lb.clamp_min(1).to(dtype))[:, None]
    zero_col = torch.zeros((B, 1), dtype=dtype, device=dev)
    zeros = torch.zeros((B, M), dtype=dtype, device=dev)
    w = torch.full((B, M), int(encode.PAD_B), dtype=torch.int32, device=dev)
    m1, i1, d1, ms2, is2 = zeros, zeros, zeros, zeros, zeros
    ds2 = torch.cat([drow, zeros[:, 1:]], dim=1)  # cell (0, 0)'s boundary
    acc = torch.zeros(B, dtype=dtype, device=dev)
    last = la1.clamp_min(0)[:, None]
    pad_b = torch.full((B, 1), int(encode.PAD_B), dtype=torch.int32,
                       device=dev)
    for d in range(M + N - 1):
        new = haps[:, d:d + 1].to(torch.int32) if d < N else pad_b
        w = torch.cat([new, w[:, :-1]], dim=1)
        prior = torch.where(a == w, match_p, mis_p)
        mnew = prior * ((tMM * ms2 + tIM * is2) + tDM * ds2)
        sh_m = torch.cat([zero_col, m1[:, :-1]], dim=1)
        sh_i = torch.cat([zero_col, i1[:, :-1]], dim=1)
        inew = tMI * sh_m + tII * sh_i
        dnew = tMD * m1 + tDD * d1
        sh_d = torch.cat([drow, d1[:, :-1]], dim=1)
        j = d - la1  # the final row's hap column on this diagonal
        valid = (la1 >= 0) & (j >= 0) & (j < lb)
        cell = (mnew + inew).gather(1, last)[:, 0]
        acc = acc + torch.where(valid, cell, 0)
        m1, i1, d1, ms2, is2, ds2 = mnew, inew, dnew, sh_m, sh_i, sh_d
    ok = acc >= torch.finfo(dtype).tiny  # false for NaN
    ll = torch.log10(torch.where(ok, acc, 1)) - scale_log2 * LOG10_2
    return torch.where(ok, ll, float("-inf"))


def pairhmm_batch_best(reads: torch.Tensor, err: torch.Tensor,
                       haps: torch.Tensor, read_lens: torch.Tensor,
                       hap_lens: torch.Tensor,
                       gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                       gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED
                       ) -> torch.Tensor:
    """The Pair-HMM forward on the operands' device, in ``err``'s dtype:
    float32 scaled by 2^120 (the TPU kernel's numbers) or float64 unscaled.
    CPU tensors go to :func:`pairhmm_batch`, CUDA tensors to the kernel (or
    an error)."""
    if reads.device.type == "cpu":
        return pairhmm_batch(reads, err, haps, read_lens, hap_lens,
                             dtype=err.dtype, gap_open_phred=gap_open_phred,
                             gap_ext_phred=gap_ext_phred)
    # the wrappers' module imports this one for its constants
    from mini_parallel_tpu_torch.ops import pairhmm_cuda

    kernel = (pairhmm_cuda.pairhmm_f64_batch_cuda
              if err.dtype == torch.float64
              else pairhmm_cuda.pairhmm_batch_cuda)
    return kernel(reads, err, haps, read_lens, hap_lens, gap_open_phred,
                  gap_ext_phred)


def make_pairhmm_sharded(mesh, data_axis: str | None = None,
                         gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                         gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED):
    """The sharded forward: fn(reads, err, haps, read_lens, hap_lens) ->
    (B,) log10 likelihoods in ``err``'s dtype, on the mesh's first device.
    The lanes split into contiguous blocks over ``data_axis`` (default:
    the mesh's first axis), each run by :func:`pairhmm_batch_best` on its
    shard's device. B must divide by the shard count."""

    def fn(reads, err, haps, read_lens, hap_lens) -> torch.Tensor:
        return collectives.concat_rows([
            pairhmm_batch_best(*shard, gap_open_phred, gap_ext_phred)
            for shard in shard_batch(mesh, (reads, err, haps, read_lens,
                                            hap_lens), data_axis)])

    return fn


def _forward(reads, err, haps, read_lens, hap_lens, gaps: tuple,
             mesh) -> torch.Tensor:
    """The sharded forward on ``mesh``, the lanes padded by empty ones to
    a multiple of the shard count (an empty lane is -inf; the pads are cut
    off)."""
    B = reads.shape[0]
    n = len(mesh.axis_devices())
    extra = pad_to_shards(max(B, 1), n) - B

    def pad(x: torch.Tensor, value) -> torch.Tensor:
        if not extra:
            return x
        return torch.cat([x, x.new_full((extra, *x.shape[1:]), value)])

    return make_pairhmm_sharded(mesh, None, *gaps)(
        pad(reads, int(encode.PAD_A)), pad(err, 0),
        pad(haps, int(encode.PAD_B)), pad(read_lens, 0), pad(hap_lens, 0))[:B]


def pairhmm_log10_padded(reads: torch.Tensor, err64: torch.Tensor,
                         haps: torch.Tensor, read_lens: torch.Tensor,
                         hap_lens: torch.Tensor,
                         gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                         gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED,
                         mesh=None) -> tuple[torch.Tensor, int]:
    """(B,) float64 log10 P(read | hap) of a padded batch on its device, and
    the number of lanes recomputed in float64.

    ``err64`` is the (B, M) float64 error of each base (zero past the
    read). The float32 forward runs on ``err64`` rounded to float32; the
    lanes it leaves at -inf that have a read and a haplotype are gathered
    on the device and recomputed by the float64 forward, which is exact at
    any quality (the JAX package recomputes them with the Python oracle).
    Both passes shard their lanes over the data axis of ``mesh`` (None: a
    mesh of one shard, the operands' device; :func:`make_pairhmm_sharded`)
    and the result is on its first device."""
    gaps = (gap_open_phred, gap_ext_phred)
    mesh = engine_mesh(mesh, reads.device)
    ll = _forward(reads, err64.to(torch.float32), haps, read_lens, hap_lens,
                  gaps, mesh).to(torch.float64)
    redo = torch.nonzero(torch.isinf(ll) & (read_lens.to(ll.device) > 0)
                         & (hap_lens.to(ll.device) > 0))[:, 0]
    n = int(redo.numel())
    if n:
        ll[redo] = _forward(*(x[redo.to(x.device)] for x in (
            reads, err64, haps, read_lens, hap_lens)), gaps, mesh).to(
                ll.device)
    return ll, n


def phred_error(phreds: torch.Tensor) -> torch.Tensor:
    """Per-base error probability 10^(-q/10), in float64."""
    return torch.pow(10.0, -phreds.to(torch.float64) / 10.0)


def pairhmm_log10_batch(reads: list[bytes], quals: list, haps: list[bytes],
                        gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                        gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED,
                        device: torch.device | str | None = None,
                        mesh=None) -> np.ndarray:
    """Host-facing batch API, the JAX package's contract: ``quals`` are
    Phred+33 ASCII bytes or numeric Phred arrays, one per read; an empty
    batch gives an empty array; the per-base error is computed in float64
    and the float32 forward sees it rounded. Lanes that underflow float32
    are recomputed in float64 (:func:`pairhmm_log10_padded`). Runs on the
    card unless ``device`` is the CPU; with ``mesh``, on the mesh's data
    shards."""
    if not reads:
        return np.empty(0, np.float64)
    dev = require_cuda(mesh_device(mesh, device))
    arr_r, la = encode.pad_batch(reads, pad_value=int(encode.PAD_A))
    arr_h, lb = encode.pad_batch(haps, pad_value=int(encode.PAD_B))
    phred = np.zeros(arr_r.shape, np.float64)
    for i, q in enumerate(quals):
        p = (np.frombuffer(q, np.uint8).astype(np.float64) - 33.0
             if isinstance(q, (bytes, bytearray)) else np.asarray(q, np.float64))
        phred[i, :len(p)] = p[:phred.shape[1]]
    col = np.arange(arr_r.shape[1])[None, :]
    err = phred_error(torch.from_numpy(phred))
    err = torch.where(torch.from_numpy(col < la[:, None]), err, 0)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    ll, _ = pairhmm_log10_padded(put(arr_r), err.to(dev), put(arr_h), put(la),
                                 put(lb), gap_open_phred, gap_ext_phred,
                                 mesh=mesh)
    return ll.cpu().numpy()
