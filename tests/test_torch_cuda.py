"""The port's CUDA kernels on the card: each kernel vs its plain PyTorch
version (exact integer equality), the wrappers' refusals, and the
engine's launches. Every test needs a CUDA card and skips without one.

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed; there, skip the repo's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.ops import encode, pileup_cuda, sw, sw_cuda, sw_long
from mini_parallel_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(rng, B, max_len):
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    return [rng.choice(alphabet, size=int(rng.integers(0, max_len + 1))).tobytes()
            for _ in range(B)]


@pytest.mark.parametrize("B,M,N", [(1000, 152, 152), (37, 96, 64),
                                   (3, 600, 120), (1, 2048, 2048),
                                   (5, 1, 7)])
def test_kernel_matches_plain(cuda_device, B, M, N):
    rng = np.random.default_rng(B + M + N)
    a, _ = encode.pad_batch(_rows(rng, B, M), pad_to=M, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(_rows(rng, B, N), pad_to=N, pad_value=int(encode.PAD_B))
    ta, tb = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    launches = sw_cuda.sw_score_batch_cuda.launches
    got = sw_cuda.sw_score_batch_best(ta, tb)
    torch.cuda.synchronize()
    assert sw_cuda.sw_score_batch_cuda.launches == launches + 1
    assert torch.equal(got, sw.sw_score_batch(ta, tb))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    a = torch.zeros((4, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        sw_cuda.sw_score_batch_cuda(a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError, match="uint8"):
        sw_cuda.sw_score_batch_cuda(a.int(), a.int())
    with pytest.raises(ValueError, match="batch sizes"):
        sw_cuda.sw_score_batch_cuda(a, a[:3])
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_score_batch_cuda(a.cpu(), a)
    assert sw_cuda.sw_score_batch_cuda(a[:0], a[:0]).shape == (0,)


@pytest.mark.parametrize("read_pad", [152, 62])
def test_engine_sw_launches_once_per_chunk(tmp_path, cuda_device, read_pad):
    rng = np.random.default_rng(1)
    reads = _rows(rng, 23, 151)
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    # 62 rounds up to 64 and buckets the 151 bp reads to 256 columns
    cfg = Config(chunk_size_reads=5, read_pad=read_pad)
    launches = sw_cuda.sw_score_batch_cuda.launches
    res = AlignmentEngine(cfg, mode="sw", device=cuda_device).self_align_file(path)
    assert sw_cuda.sw_score_batch_cuda.launches == launches + res.chunks == launches + 5
    assert res.failed_chunks == 0
    assert res.score == 2 * sum(map(len, reads))
    cpu = AlignmentEngine(cfg, mode="sw", device=torch.device("cpu")).self_align_file(path)
    assert (res.score, res.total_bases, res.total_reads) == \
        (cpu.score, cpu.total_bases, cpu.total_reads)


@pytest.mark.parametrize("B,M,N,gap_open,gap_extend", [
    (1000, 152, 152, -2, -1), (37, 96, 64, -5, -1), (21, 600, 120, -3, -2),
    (1, 2048, 2048, -2, -1), (5, 1, 7, 0, -2)])
def test_affine_kernel_matches_plain(cuda_device, B, M, N, gap_open,
                                     gap_extend):
    rng = np.random.default_rng(B + M + N)
    a, _ = encode.pad_batch(_rows(rng, B, M), pad_to=M, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(_rows(rng, B, N), pad_to=N, pad_value=int(encode.PAD_B))
    ta, tb = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    launches = sw_cuda.sw_affine_batch_cuda.launches
    got = sw_cuda.sw_affine_batch_best(ta, tb, gap_open, gap_extend)
    torch.cuda.synchronize()
    assert sw_cuda.sw_affine_batch_cuda.launches == launches + 1
    assert torch.equal(got, sw.sw_affine_batch(ta, tb, gap_open, gap_extend))
    if (gap_open, gap_extend) == (0, -2):
        assert torch.equal(got, sw_cuda.sw_score_batch_cuda(ta, tb))
    with pytest.raises(ValueError, match="gap costs"):
        sw_cuda.sw_affine_batch_cuda(ta, tb, 1, -1)


@pytest.mark.parametrize("M,W", [(1, 16), (300, 32), (3000, 512),
                                 (5000, 8192)])
def test_long_strip_kernels_match_plain(cuda_device, M, W):
    rng = np.random.default_rng(M + W)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    a = torch.from_numpy(rng.choice(alphabet, M)).to(cuda_device)
    b = torch.from_numpy(rng.choice(alphabet, W)).to(cuda_device)
    lh = torch.from_numpy(rng.integers(0, 60, M).astype(np.int32)).to(cuda_device)
    lf = torch.from_numpy(rng.integers(-70, 50, M).astype(np.int32)).to(cuda_device)
    n0 = sw_long.sw_strip_cuda.launches
    got = sw_long.strip_best(False, cuda_device)(a, b, lh)
    torch.cuda.synchronize()
    assert sw_long.sw_strip_cuda.launches == n0 + 1
    assert all(torch.equal(x, y) for x, y in zip(got, sw_long.sw_strip(a, b, lh)))
    got = sw_long.strip_best(True, cuda_device)(a, b, lh, lf, -3, -1)
    torch.cuda.synchronize()
    want = sw_long.sw_affine_strip(a, b, lh, lf, -3, -1)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_long_pair_host_loop_on_the_card(cuda_device):
    rng = np.random.default_rng(7)
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000)
    b = rng.choice(np.frombuffer(b"ACGT", np.uint8), 2500)
    b[900:1300] = a[700:1100]  # a shared segment across strip edges
    for width in (64, 1024, 8192):
        assert sw_long.sw_score_long(a, b, cuda_device, strip_width=width) == \
            sw_long.sw_score_numpy_blocked(a, b)
        assert sw_long.sw_affine_score_long(
            a, b, cuda_device, strip_width=width) == \
            sw_long.sw_affine_numpy_blocked(a, b)
    with pytest.raises(ValueError, match="multiple"):
        sw_long.sw_strip_cuda(torch.from_numpy(a).to(cuda_device),
                              torch.from_numpy(b[:20]).to(cuda_device),
                              torch.zeros(3000, dtype=torch.int32,
                                          device=cuda_device))


def _vs_ref_operands(rng, B, M, N, device):
    """Reads cut from a reference with a repeated segment, all-pad rows
    and all-N rows."""
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), N)
    seg = min(60, N // 8)
    ref[N // 2:N // 2 + seg] = ref[10:10 + seg]
    rows = []
    for k in range(B):
        n = int(rng.integers(1, min(M, N - 1) + 1))
        s = int(rng.integers(0, N - n))
        rows.append([b"", b"N" * n, ref[s:s + n].tobytes(),
                     ref[10:10 + min(n, seg)].tobytes()][k % 4])
    reads, _ = encode.pad_batch(rows, pad_to=M, pad_value=int(encode.PAD_A))
    return (torch.from_numpy(reads).to(device),
            torch.from_numpy(ref).to(device))


@pytest.mark.parametrize("B,M,N", [(256, 152, 20_000), (37, 37, 3000),
                                   (9, 300, 4000), (3, 1, 50)])
def test_vs_ref_kernel_matches_plain(cuda_device, B, M, N):
    rng = np.random.default_rng(B + M + N)
    reads, ref = _vs_ref_operands(rng, B, M, N, cuda_device)
    launches = sw_cuda.sw_vs_ref_batch_cuda.launches
    got = sw_cuda.sw_vs_ref_batch_best(reads, ref)
    torch.cuda.synchronize()
    assert sw_cuda.sw_vs_ref_batch_cuda.launches == launches + 1
    want = sw.sw_vs_ref_batch(reads, ref)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[0][0]) == 0 and int(got[1][0]) == -1  # the all-pad row


def _vs_ref_edge_cases(rng):
    """(name, reads, ref) cases of the segment split: a read twice in the
    reference (equal best in two segments: the smaller end wins), a copy
    across a segment edge with a 3-base gap, all-pad and all-N reads, rows
    past one stripe (M = 300), and N not a multiple of any segment."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, 1001)
    read = rng.choice(acgt, 20)
    ref[100:120] = read
    ref[700:720] = read
    ref[400:430] = ord("N")
    copy = ref[226:286].copy()  # across column 256
    cases = [("ties in two segments, an edge-crossing copy, all-pad, all-N",
              [read.tobytes(), b"", np.concatenate([copy[:25], copy[28:]]
                                                   ).tobytes(),
               b"N" * 20, read[:7].tobytes()], 64, ref)]
    rows = []
    for k in range(9):
        n = int(rng.integers(1, 301))
        s = int(rng.integers(0, ref.size - n))
        rows.append([ref[s:s + n].tobytes(), b"", b"N" * n][k % 3])
    cases.append(("rows past one stripe", rows, 300, ref))
    out = []
    for name, rows, M, r in cases:
        reads, _ = encode.pad_batch(rows, pad_to=M, pad_value=int(encode.PAD_A))
        out.append((name, reads, r))
    return out


@pytest.mark.parametrize("segment", [16, 32, 48, 0])
def test_vs_ref_segments_match_plain(cuda_device, segment):
    """The kernel at narrow segment widths (and its default) == plain
    sw_vs_ref_batch == the plain segment mirror, on ties and edges."""
    rng = np.random.default_rng(segment)
    for name, reads, ref in _vs_ref_edge_cases(rng):
        tr, tf = (torch.from_numpy(x).to(cuda_device) for x in (reads, ref))
        launches = sw_cuda.sw_vs_ref_batch_cuda.launches
        got = sw_cuda.sw_vs_ref_batch_cuda(tr, tf, segment)
        torch.cuda.synchronize()
        assert sw_cuda.sw_vs_ref_batch_cuda.launches == launches + 1
        want = sw.sw_vs_ref_batch(tr, tf)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        mirror = sw.sweep_segments(tr.cpu(), tf.cpu(), segment or 64)
        assert all(torch.equal(g.cpu(), m) for g, m in zip(got, mirror)), name
    scores, ends = (t.cpu() for t in got)
    assert int(scores[1]) == 0 and int(ends[1]) == -1


def test_vs_ref_tie_keeps_the_smaller_end(cuda_device):
    name, reads, ref = _vs_ref_edge_cases(np.random.default_rng(0))[0]
    tr, tf = (torch.from_numpy(x).to(cuda_device) for x in (reads, ref))
    for segment in (16, 100, 0):
        scores, ends = sw_cuda.sw_vs_ref_batch_cuda(tr, tf, segment)
        assert (int(scores[0]), int(ends[0])) == (40, 119)


@pytest.mark.parametrize("B,M,N", [(20_000, 300, 4_742_164),
                                   (20_000, 4_000, 4_742_164),
                                   (5, 300, 1_001), (20_000, 152, 4_742_164)])
def test_vs_ref_scratch_is_bounded(cuda_device, B, M, N):
    """Past one stripe the scratch holds one row of min(segment + 2M, N)
    values per warp, never more rows than B x segments (rounded up to a
    block of 4 warps) nor more than 256 MB beyond one block's rows; within
    one stripe there is none."""
    lib = sw_cuda._vs_ref_kernel_lib()
    with torch.cuda.device(cuda_device):
        n = lib.sw_vs_ref_scratch(B, M, N, 0)
        seg = lib.sw_vs_ref_default_segment(M)
    if M <= 256:
        assert n == 0
        return
    row = min(seg + 2 * M, N)
    assert 0 < n and n % (4 * row) == 0
    assert n <= -(-B * -(-N // seg) // 4) * 4 * row
    assert 4 * n <= (1 << 28) + 4 * 4 * row


def _group_operands(rng, M, Wtot, device):
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    a = rng.choice(alphabet, M)
    b = rng.choice(alphabet, Wtot)
    b[Wtot // 3:Wtot // 3 + min(M, Wtot) // 2] = a[:min(M, Wtot) // 2]
    lh = rng.integers(0, 60, M).astype(np.int32)
    lf = rng.integers(-70, 50, M).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (a, b, lh, lf)]


GROUP_CASES = ["second wave", "M not a chunk multiple", "M below one chunk",
               "one strip", "ragged last strip", "multi-warp strips"]


def _group_shape(case, device):
    """(M, W, Wtot) of a strip-group case."""
    M, W, Wtot = {"M not a chunk multiple": (1000, 64, 64 * 20),
                  "M below one chunk": (7, 32, 32 * 9),
                  "one strip": (3000, 512, 512),
                  "ragged last strip": (700, 512, 512 * 3 + 48),
                  "multi-warp strips": (500, 2048, 2048 * 3 + 1024),
                  "second wave": (45, 16, 0)}[case]
    if case == "second wave":  # more strips than the card holds blocks
        Wtot = 16 * (max(sw_long.resident_blocks(16, False, device),
                         sw_long.resident_blocks(16, True, device)) + 37)
    return M, W, Wtot


@pytest.mark.parametrize("case", GROUP_CASES)
def test_strip_group_kernel_matches_plain_group(cuda_device, case):
    """The strip-group kernel == the plain group (sw_strip_group /
    sw_affine_strip_group) on best and the carried-out column(s), from
    random carried-in columns."""
    M, W, Wtot = _group_shape(case, cuda_device)
    rng = np.random.default_rng(M + W + Wtot)
    a, b, lh, lf = _group_operands(rng, M, Wtot, cuda_device)
    cpu = [t.cpu() for t in (a, b, lh, lf)]
    for affine in (False, True):
        kernel = sw_long.sw_affine_strip_cuda if affine else sw_long.sw_strip_cuda
        n0 = kernel.launches
        if affine:
            got = kernel(a, b, lh, lf, -3, -1, strip_width=W)
            want = sw_long.sw_affine_strip_group(*cpu, -3, -1, strip_width=W)
        else:
            got = kernel(a, b, lh, strip_width=W)
            want = sw_long.sw_strip_group(*cpu[:3], strip_width=W)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), \
            (case, affine)


@pytest.mark.parametrize("case", GROUP_CASES)
def test_strip_group_kernel_band_rows_match_plain_group(cuda_device, case):
    """The band contract of csrc/sw_long.cu: from random carried-in
    columns and a random row above (top_h with its corner, and top_e), the
    kernel == the plain group on best, the carried-out column(s) and the
    bottom row(s), exactly; and the true edge given as explicit rows
    (zeros, NEG) == the null top, bit for bit."""
    M, W, Wtot = _group_shape(case, cuda_device)
    rng = np.random.default_rng(M + W + Wtot + 1)
    a, b, lh, lf = _group_operands(rng, M, Wtot, cuda_device)
    th = torch.from_numpy(rng.integers(0, 60, Wtot + 1).astype(np.int32))
    te = torch.from_numpy(rng.integers(-70, 50, Wtot).astype(np.int32))
    cpu = [t.cpu() for t in (a, b, lh, lf)]
    for affine in (False, True):
        kernel = (sw_long.sw_affine_strip_cuda if affine
                  else sw_long.sw_strip_cuda)
        n0 = kernel.launches
        if affine:
            tops = dict(top_h=th, top_e=te)
            got = kernel(a, b, lh, lf, -3, -1, strip_width=W,
                         **{k: v.to(cuda_device) for k, v in tops.items()})
            want = sw_long.sw_affine_strip_group(*cpu, -3, -1, strip_width=W,
                                                 **tops)
            edge = kernel(a, b, lh, lf, -3, -1, strip_width=W)
            top_h, top_e = sw_long.default_top(Wtot, True, cuda_device)
            edge_rows = kernel(a, b, lh, lf, -3, -1, strip_width=W,
                               top_h=top_h, top_e=top_e)
        else:
            got = kernel(a, b, lh, strip_width=W, top_h=th.to(cuda_device))
            want = sw_long.sw_strip_group(*cpu[:3], strip_width=W, top_h=th)
            edge = kernel(a, b, lh, strip_width=W)
            (top_h,) = sw_long.default_top(Wtot, False, cuda_device)
            edge_rows = kernel(a, b, lh, strip_width=W, top_h=top_h)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 3
        assert len(got) == len(want) == len(edge) + 1 + affine
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), \
            (case, affine)
        assert all(torch.equal(e, r) for e, r in zip(edge, edge_rows)), \
            (case, affine)


def test_long_pair_bands_on_the_card(cuda_device):
    """The banded host loop on a seq mesh of 1, 2, 3 and 4 shards of the
    one card == the one-device host loop == the goldens, a match run
    crossing every band and strip boundary; every band launches the
    kernel."""
    from mini_parallel_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(10)
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), 2500)
    b = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000)
    b[800:2600] = a[300:2100]
    b[1500:1503] = ord("A")
    lin, aff = (sw_long.sw_score_numpy_blocked(a, b),
                sw_long.sw_affine_numpy_blocked(a, b))
    for C in (1, 2, 3, 4):
        mesh = make_mesh((1, C), devices=[cuda_device] * C)
        for width, per_group in ((64, 5), (512, None)):
            n0 = sw_long.sw_strip_cuda.launches
            assert sw_long.sw_score_long_sharded(
                a, b, mesh, strip_width=width,
                strips_per_group=per_group) == lin
            strips = -(-3008 // width)
            assert sw_long.sw_strip_cuda.launches - n0 == \
                C * -(-strips // (per_group or strips))
            assert sw_long.sw_affine_score_long_sharded(
                a, b, mesh, strip_width=width,
                strips_per_group=per_group) == aff
    assert sw_long.sw_score_long(a, b, cuda_device) == lin


def test_long_host_loop_in_groups_on_the_card(cuda_device):
    """The host loop at several group sizes == the blocked goldens."""
    rng = np.random.default_rng(9)
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), 2500)
    b = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000)
    b[1000:1600] = a[300:900]
    lin, aff = (sw_long.sw_score_numpy_blocked(a, b),
                sw_long.sw_affine_numpy_blocked(a, b))
    for width, per_group in ((16, 7), (64, 1), (512, 2), (512, None)):
        n0 = sw_long.sw_strip_cuda.launches
        assert sw_long.sw_score_long(a, b, cuda_device, strip_width=width,
                                     strips_per_group=per_group) == lin
        strips = -(-3008 // width)
        assert sw_long.sw_strip_cuda.launches - n0 == \
            -(-strips // (per_group or strips))
        assert sw_long.sw_affine_score_long(
            a, b, cuda_device, strip_width=width,
            strips_per_group=per_group) == aff


def _moves_operands(rng, B, M, N, device):
    """Reads cut from their windows with substitutions and a gap, some
    unrelated, some empty."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rows_a, rows_b = [], []
    for k in range(B):
        win = rng.choice(acgt, N)
        n = int(rng.integers(1, min(M, N - 8) + 1))
        s = int(rng.integers(0, N - n))
        read = win[s:s + n].copy()
        read[rng.random(n) < 0.05] = ord("T")
        read = np.concatenate([read[:n // 2], read[n // 2 + 3:]])
        rows_a.append([read.tobytes(), b"", rng.choice(acgt, n).tobytes(),
                       read.tobytes()][k % 4])
        rows_b.append(win.tobytes())
    a, _ = encode.pad_batch(rows_a, pad_to=M, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(rows_b, pad_to=N, pad_value=int(encode.PAD_B))
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


@pytest.mark.parametrize("B,M,N", [(1000, 152, 184), (33, 37, 50),
                                   (21, 300, 200), (5, 1, 9), (1, 152, 184),
                                   (3, 200, 1500)])
@pytest.mark.parametrize("gaps", [None, (-2, -1), (-3, 0)])
def test_moves_kernels_match_plain(cuda_device, B, M, N, gaps):
    """best, bd, bi, positions and the move of every cell: moves kept in
    shared memory (M <= 256), rows past one stripe and windows too long
    for shared memory (moves in device memory), a last block of one pair,
    a batch of one."""
    from mini_parallel_tpu_torch.ops import sw_traceback as tb
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    rng = np.random.default_rng(B * M + N)
    a, b = _moves_operands(rng, B, M, N, cuda_device)
    if gaps is None:
        kernel = tbc.sw_moves_batch_cuda
        got = kernel(a, b, return_moves=True)
        best, bd, bi, moves = tb.sw_moves_batch(a, b)
        pos = tb._positions_walk(best, bd, bi, moves)
    else:
        kernel = tbc.sw_affine_moves_batch_cuda
        got = kernel(a, b, *gaps, return_moves=True)
        best, bd, bi, moves = tb.sw_affine_moves_batch(a, b, *gaps)
        pos = tb._affine_walk(best, bd, bi, moves)
    torch.cuda.synchronize()
    for g, w in zip(got[:4], (best, bd, bi, pos)):
        assert torch.equal(g, w)
    assert torch.equal(tbc.moves_to_cells(got[4], M, N, gaps is not None),
                       tb.plain_moves_to_cells(moves, N))
    n0 = kernel.launches
    routed = (tb.sw_positions_batch_best(a, b) if gaps is None
              else tb.sw_affine_positions_batch_best(a, b, *gaps))
    assert kernel.launches == n0 + 1
    assert torch.equal(routed[0], best) and torch.equal(routed[1], pos)


@pytest.mark.parametrize("B,M,N", [(300, 152, 184), (21, 300, 200),
                                   (3, 200, 1500)])
@pytest.mark.parametrize("gaps", [None, (-3, -1)])
def test_align_batch_on_the_card_matches_plain(cuda_device, B, M, N, gaps):
    """sw_align_batch / sw_affine_align_batch on CUDA tensors: one kernel
    launch with its moves out, moves in shared memory (152 x 184) and in
    device memory (rows past one stripe, 1,500-column windows); every
    Alignment equals the plain route's on the CPU, and the golden's on a
    few pairs."""
    import dataclasses

    from mini_parallel_tpu_torch.ops import sw_traceback as tb
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    rng = np.random.default_rng(B * M + N + 1)
    a, b = _moves_operands(rng, B, M, N, cuda_device)
    if gaps is None:
        kernel, align = tbc.sw_moves_batch_cuda, tb.sw_align_batch
        golden = tb.sw_align_numpy
    else:
        kernel = tbc.sw_affine_moves_batch_cuda
        align = lambda x, y: tb.sw_affine_align_batch(x, y, *gaps)  # noqa: E731
        golden = lambda x, y: tb.sw_affine_align_numpy(x, y, *gaps)  # noqa: E731
    n0 = kernel.launches
    got = align(a, b)
    assert kernel.launches == n0 + 1
    fields = lambda alns: [dataclasses.astuple(x) for x in alns]  # noqa: E731
    assert fields(got) == fields(align(a.cpu(), b.cpu()))
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    for p in range(min(B, 3)):
        qa = a_np[p][a_np[p] != encode.PAD_A].tobytes()
        qb = b_np[p][b_np[p] != encode.PAD_B].tobytes()
        assert fields([got[p]]) == fields([golden(qa, qb)])


@pytest.mark.parametrize("capacity", [1 << 20, 3000])
def test_kmer_codec_on_the_card(cuda_device, capacity):
    """The accumulator on the card drains (spilled or not) what it drains
    on the CPU, and plane_pack of the card's store decodes to it."""
    from mini_parallel_tpu_torch.native import kmer_store
    from mini_parallel_tpu_torch.ops import kmer

    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    batches = []
    for _ in range(6):
        reads = [rng.choice(acgt, int(rng.integers(10, 121))).tobytes()
                 for _ in range(200)]
        arr, lens = encode.pad_batch(reads, pad_to=128,
                                     pad_value=int(encode.PAD_A))
        batches.append((torch.from_numpy(arr), torch.from_numpy(lens)))

    def accumulate(device):
        acc = kmer.DeviceKmerAccumulator(capacity=capacity, staging_batches=2)
        for arr, lens in batches:
            keys, counts, _ = kmer.unique_counts_batch(
                encode.ascii_to_code(arr.to(device)), lens.to(device), k=15)
            acc.add(keys, counts)
        return acc

    want = accumulate(torch.device("cpu"))
    acc = accumulate(cuda_device)
    acc.flush()
    if acc._store is not None:
        planes, kp, cp, key0 = kmer.plane_pack(*acc._store)
        assert planes.is_cuda
        keys, counts = kmer_store.decode_planes_native(
            planes.cpu().numpy(), acc._store[0].numel(), kp, cp, key0)
        assert np.array_equal(keys, acc._store[0].cpu().numpy())
        assert np.array_equal(counts, acc._store[1].cpu().numpy())
    assert acc.spilled == want.spilled == (capacity == 3000)
    got, want = acc.drain(), want.drain()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_get_devices_lists_the_cards(cuda_device):
    from mini_parallel_tpu_torch import device

    devs = device.get_devices()
    assert device.is_accelerator_available()
    assert len(devs) == torch.cuda.device_count()
    assert devs[0].name == torch.cuda.get_device_name(0)
    assert devs[0].platform == "gpu" and devs[0].memory_gb > 1


@pytest.mark.parametrize("kw", [dict(gapped=True, rescue=True),
                                dict(gapped=True, gap_model="affine"),
                                dict(min_base_quality=10)])
def test_variant_prep_on_the_card_matches_cpu(tmp_path, cuda_device, kw):
    """A 2-contig sample with planted variants: the card's pileup, counts,
    candidates (and SAM bytes, gapped) equal the plain versions' on the
    CPU; the path's kernels launched."""
    from mini_parallel_tpu_torch.models import variant_prep as vp
    from mini_parallel_tpu_torch.ops import sw_traceback_cuda as tbc

    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    contigs = {"c1": rng.choice(acgt, 5000).tobytes(),
               "c2": rng.choice(acgt, 3000).tobytes()}
    donor = bytearray(contigs["c1"])
    for p in range(200, 4800, 300):
        donor[p] = ord("A") if donor[p] != ord("A") else ord("C")
    del donor[2500:2503]
    reads, quals = [], []
    for k in range(400):
        s = int(rng.integers(0, len(donor) - 150))
        r = bytes(donor[s:s + 150])
        if k % 9 == 0:  # kill every probed seed: only rescue maps it
            r = bytearray(r)
            for m in (7, 24, 41, 58, 91, 108, 125, 142):
                r[m] = ord("G") if r[m] != ord("G") else ord("T")
            r = bytes(r)
        reads.append(r)
        quals.append("".join(rng.choice(["#", "I"], 150, p=[0.05, 0.95])))
    path = str(tmp_path / "lane.fastq.gz")
    import gzip
    with gzip.open(path, "wb") as f:
        for i, (r, q) in enumerate(zip(reads, quals)):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, q.encode()))
    cfg = Config(chunk_size_reads=128)
    counters = (sw_cuda.sw_vs_ref_batch_cuda, tbc.sw_moves_batch_cuda,
                tbc.sw_affine_moves_batch_cuda,
                pileup_cuda.pileup_positions_cuda)
    before = [fn.launches for fn in counters]
    out = []
    for k, dev in enumerate((cuda_device, torch.device("cpu"))):
        eng = vp.VariantPrepEngine(contigs, cfg, device=dev, **kw)
        sam = str(tmp_path / f"{k}.sam") if kw.get("gapped") else None
        res = eng.process_file(path, sam_out=sam)
        out.append((res, open(sam, "rb").read() if sam else None))
    (gpu, gsam), (cpu, csam) = out
    assert np.array_equal(gpu.pileup, cpu.pileup)
    assert (gpu.total_reads, gpu.mapped_reads) == (cpu.total_reads,
                                                   cpu.mapped_reads)
    assert gpu.candidates == cpu.candidates and gsam == csam
    moved = [fn.launches - b for fn, b in zip(counters, before)]
    chunks = 4  # 400 reads in chunks of 128
    assert moved[3] == chunks  # the pileup kernel, ungapped or gapped
    if kw.get("rescue"):
        assert moved[0] == chunks and moved[1] == chunks
        assert gpu.mapped_reads >= 390
    elif kw.get("gapped"):
        assert moved[2] == chunks
    else:
        assert moved[:3] == [0, 0, 0]


def _pileup_case(rng, B, L, G, dtype):
    """(codes, positions, qual_ok) numpy arrays like a traceback's: runs
    of positions with deletions (jumps of 2-4), insertions (-1 runs that
    do not advance), soft clips at both ends, some rows with no aligned
    base, rows from 0 and rows running to and past G, negative positions
    other than -1, and row 3 (where there is one) with a deletion site at
    G and an insertion after G - 1."""
    start = rng.integers(-L // 4, G - L // 2, B)
    start[::5] = rng.integers(G - L, G + 3, len(start[::5]))
    start[1::11] = 0
    ins = rng.random((B, L)) < 0.05
    dl = np.where(rng.random((B, L)) < 0.04, rng.integers(1, 4, (B, L)), 0)
    adv = np.where(ins, 0, 1 + dl)
    pos = start[:, None] + np.cumsum(adv, 1) - adv[:, :1]
    pos[ins] = -1
    col = np.arange(L)[None, :]
    pos[col < rng.integers(0, 6, B)[:, None]] = -1
    pos[col >= L - rng.integers(0, 6, B)[:, None]] = -1
    pos[6::7] = -1  # no aligned base: an unmapped row
    low = pos < -1
    pos[low] = rng.choice([-1, -3], int(low.sum()))
    if B > 3 and L > 30:
        pos[3, 10], pos[3, 11] = G - 1, G + 1
        pos[3, 20], pos[3, 21], pos[3, 22] = G - 1, -1, G
    codes = rng.integers(0, 6, (B, L)).astype(np.uint8)
    return codes, pos.astype(dtype), rng.random((B, L)) < 0.9


@pytest.mark.parametrize("B", [1, 10_000])
@pytest.mark.parametrize("L", [62, 152, 300])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_pileup_kernel_matches_plain(cuda_device, B, L, dtype):
    """Two batches into one accumulator, with and then without a quality
    mask: the kernel's counts equal the plain route's on the card bit for
    bit, its trash slot stays 0, and each call is one launch."""
    from mini_parallel_tpu_torch.models import variant_prep as vp

    rng = np.random.default_rng(B + L)
    G = 50_000 if B > 1 else 2000
    got = vp._new_pileup(G, cuda_device)
    want = vp._new_pileup(G, cuda_device)
    for with_qual in (True, False):
        codes, pos, qual = (torch.from_numpy(x).to(cuda_device)
                            for x in _pileup_case(rng, B, L, G, dtype))
        q = qual if with_qual else None
        launches = pileup_cuda.pileup_positions_cuda.launches
        view = vp._pileup_positions(codes, pos, G, q, acc=got)
        torch.cuda.synchronize()
        assert pileup_cuda.pileup_positions_cuda.launches == launches + 1
        assert view.data_ptr() == got.data_ptr()
        vp._pileup_positions_plain(codes, pos, G, q, want)
        assert torch.equal(vp.pileup_view(got), vp.pileup_view(want))
        assert int(got[-1]) == 0
    counts = vp.pileup_view(got)
    assert int(counts[:, :4].sum()) > 0
    if B > 1:
        assert int(counts[:, 5].sum()) > 0 and int(counts[:, 6].sum()) > 0


def test_pileup_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """On the card (the CPU test of the same name covers the formats): CPU
    positions beside a card accumulator raise, and an empty batch returns
    the accumulator untouched without a launch."""
    G = 10
    codes = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    pos = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    acc = torch.zeros(G * 7 + 1, dtype=torch.int32, device=cuda_device)
    run = pileup_cuda.pileup_positions_cuda
    with pytest.raises(ValueError, match="CUDA"):
        run(codes, pos.cpu(), G, None, acc)
    launches = run.launches
    assert run(codes[:0], pos[:0], G, None, acc) is acc
    assert run.launches == launches and int(acc.sum()) == 0


def test_ungapped_pileup_on_the_card_matches_cpu(cuda_device):
    """The ungapped pileup (anchors, lengths, quality mask) through the
    kernel equals the CPU's counts, with no gap event."""
    from mini_parallel_tpu_torch.models import variant_prep as vp

    rng = np.random.default_rng(3)
    B, L, G = 3000, 152, 20_000
    args = [torch.from_numpy(rng.integers(0, 6, (B, L)).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, L + 1, B).astype(np.int32)),
            torch.from_numpy(rng.integers(-20, G, B).astype(np.int32)),
            torch.from_numpy(rng.random(B) < 0.8)]
    qual = torch.from_numpy(rng.random((B, L)) < 0.9)
    launches = pileup_cuda.pileup_positions_cuda.launches
    got = vp._pileup_batch(*(t.to(cuda_device) for t in args), G,
                           qual.to(cuda_device))
    assert pileup_cuda.pileup_positions_cuda.launches == launches + 1
    want = vp._pileup_batch(*args, G, qual)
    assert torch.equal(got.cpu(), want)
    assert int(want[:, 5:].sum()) == 0 and int(want[:, :4].sum()) > 0


def test_reference_index_on_the_card_matches_cpu(cuda_device):
    """The seed index of a 4.74 Mbp two-contig reference with N runs and
    IUPAC letters, built on the card, equals the CPU build element for
    element, and its tensors live on the card."""
    from mini_parallel_tpu_torch.models import variant_prep as vp

    rng = np.random.default_rng(2024)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    chrom = rng.choice(acgt, 4_641_652)
    chrom[rng.integers(0, chrom.size, 2000)] = ord("N")
    chrom[rng.integers(0, chrom.size, 500)] = ord("R")
    chrom[1_000_000:1_000_300] = ord("N")
    plasmid = rng.choice(np.frombuffer(b"acgt", np.uint8), 100_000)
    ref, *_ = vp.concat_contigs({"chr": chrom.tobytes(),
                                 "plasmid": plasmid.tobytes()})
    gpu = vp.ReferenceIndex(ref, cuda_device)
    cpu = vp.ReferenceIndex(ref, torch.device("cpu"))
    for name in ("sorted_keys", "sorted_pos", "ref_ascii_dev"):
        g, c = getattr(gpu, name), getattr(cpu, name)
        assert g.device.type == "cuda" and g.dtype == c.dtype
        assert torch.equal(g.cpu(), c), name
    assert np.array_equal(gpu.ref_codes, cpu.ref_codes)
    assert 4_600_000 < len(gpu) < len(ref)


@pytest.mark.parametrize("mode", ["sw-affine", "contiguous"])
def test_engine_new_modes_on_the_card(tmp_path, cuda_device, mode):
    rng = np.random.default_rng(2)
    reads = _rows(rng, 23, 151)
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=5)
    launches = sw_cuda.sw_affine_batch_cuda.launches
    res = AlignmentEngine(cfg, mode=mode, device=cuda_device).self_align_file(path)
    cpu = AlignmentEngine(cfg, mode=mode, device=torch.device("cpu")).self_align_file(path)
    assert (res.score, res.total_bases, res.failed_chunks) == \
        (cpu.score, cpu.total_bases, 0)
    if mode == "sw-affine":
        assert sw_cuda.sw_affine_batch_cuda.launches == launches + 5
        assert res.score == 2 * sum(map(len, reads))


def _pairhmm_lanes(rng, B, M, N):
    """Reads cut from their haplotypes with substitutions (some longer
    than the haplotype), unrelated reads and empty lanes; Q5-Q40."""
    from mini_parallel_tpu_torch.ops import pairhmm

    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads, haps = [], []
    for k in range(B):
        hap = rng.choice(acgt, int(rng.integers(1, N + 1)))
        m = int(rng.integers(1, M + 1))
        s = int(rng.integers(0, max(hap.size - m, 0) + 1))
        read = np.concatenate([hap[s:s + m], rng.choice(acgt, m)])[:m]
        read[rng.random(m) < 0.03] = ord("A")
        reads.append([read.tobytes(), b"", rng.choice(acgt, m).tobytes(),
                      read.tobytes()][k % 4])
        haps.append(hap.tobytes() if k % 7 != 6 else b"")
    arr_r, la = encode.pad_batch(reads, pad_to=M, pad_value=int(encode.PAD_A))
    arr_h, lb = encode.pad_batch(haps, pad_to=N, pad_value=int(encode.PAD_B))
    q = torch.from_numpy(rng.integers(5, 41, (B, M)).astype(np.float64))
    err = torch.where(torch.arange(M)[None, :] < torch.from_numpy(la)[:, None],
                      pairhmm.phred_error(q), 0)
    return (torch.from_numpy(arr_r), err, torch.from_numpy(arr_h),
            torch.from_numpy(la), torch.from_numpy(lb))


@pytest.mark.parametrize("B,M,N", [(1000, 152, 101), (37, 300, 120),
                                   (64, 40, 200), (5, 1, 7), (1, 152, 101),
                                   (33, 170, 80)])
@pytest.mark.parametrize("f64", [False, True])
def test_pairhmm_kernel_matches_plain(cuda_device, B, M, N, f64):
    """csrc/pairhmm.cu vs the plain pairhmm_batch on the card: the same
    -inf lanes; |Δlog10| <= 1e-4 in float32 (log10f against torch's log10
    at most), <= 1e-9 in float64. Two lanes share a warp, so the cases
    hold lanes of different lengths (and empty ones) side by side, a last
    warp of one lane (odd B), a batch of one and two stripes (M > 160)."""
    from mini_parallel_tpu_torch.ops import pairhmm, pairhmm_cuda

    rng = np.random.default_rng(B + M + N)
    reads, err, haps, la, lb = (t.to(cuda_device) for t in
                                _pairhmm_lanes(rng, B, M, N))
    dtype = torch.float64 if f64 else torch.float32
    kernel = (pairhmm_cuda.pairhmm_f64_batch_cuda if f64
              else pairhmm_cuda.pairhmm_batch_cuda)
    launches = kernel.launches
    got = pairhmm.pairhmm_batch_best(reads, err.to(dtype), haps, la, lb)
    want = pairhmm.pairhmm_batch(reads, err.to(dtype), haps, la, lb,
                                 dtype=dtype)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert got.dtype == dtype
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    if bool(fin.any()):  # a batch of one may hold a single -inf lane
        assert float((got[fin] - want[fin]).abs().max()) <= \
            (1e-9 if f64 else 1e-4)


@pytest.mark.parametrize("f64", [False, True])
def test_pairhmm_kernel_mixed_lanes_in_a_warp(cuda_device, f64):
    """Neighbouring lanes (one warp) of very different read and haplotype
    lengths, empty reads and empty haplotypes beside full ones: each lane
    equals the plain version exactly."""
    from mini_parallel_tpu_torch.ops import pairhmm, pairhmm_cuda

    rng = np.random.default_rng(31)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    shapes = [(150, 101), (1, 1), (3, 200), (150, 101), (0, 50), (150, 7),
              (40, 0), (150, 101), (2, 160), (150, 3), (299, 101)]
    reads = [rng.choice(acgt, m).tobytes() for m, _ in shapes]
    haps = [rng.choice(acgt, n).tobytes() for _, n in shapes]
    arr_r, la = encode.pad_batch(reads, pad_to=300, pad_value=int(encode.PAD_A))
    arr_h, lb = encode.pad_batch(haps, pad_to=200, pad_value=int(encode.PAD_B))
    q = torch.from_numpy(rng.integers(5, 41, arr_r.shape).astype(np.float64))
    err = torch.where(torch.arange(300)[None, :] < torch.from_numpy(la)[:, None],
                      pairhmm.phred_error(q), 0)
    dtype = torch.float64 if f64 else torch.float32
    args = [torch.from_numpy(arr_r), err.to(dtype), torch.from_numpy(arr_h),
            torch.from_numpy(la), torch.from_numpy(lb)]
    args = [t.to(cuda_device) for t in args]
    kernel = (pairhmm_cuda.pairhmm_f64_batch_cuda if f64
              else pairhmm_cuda.pairhmm_batch_cuda)
    got = kernel(*args)
    want = pairhmm.pairhmm_batch(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_pairhmm_log10_padded_on_the_card_matches_cpu(cuda_device):
    """The engine's batch (float32, then float64 on the underflowed lanes)
    on the card == on the CPU within 1e-4, with one launch of each."""
    from mini_parallel_tpu_torch.ops import pairhmm, pairhmm_cuda

    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    src = rng.choice(acgt, 400)
    reads = [src[25 + o:175 + o].tobytes() for o in range(0, 150, 3)]
    args = _pairhmm_lanes(rng, 60, 152, 101)
    arr_r, la = encode.pad_batch(reads, pad_to=152, pad_value=int(encode.PAD_A))
    hap = np.full((len(reads), 101), encode.PAD_B, np.uint8)
    hap[:] = src[150:251]
    err = torch.full((len(reads), 152), 1e-3, dtype=torch.float64)
    args = [torch.cat([a, b]) for a, b in zip(args, (
        torch.from_numpy(arr_r), err, torch.from_numpy(hap),
        torch.from_numpy(la), torch.full((len(reads),), 101,
                                         dtype=torch.int32)))]
    before = (pairhmm_cuda.pairhmm_batch_cuda.launches,
              pairhmm_cuda.pairhmm_f64_batch_cuda.launches)
    got, n = pairhmm.pairhmm_log10_padded(*(a.to(cuda_device) for a in args))
    want, n_cpu = pairhmm.pairhmm_log10_padded(*args)
    assert n == n_cpu > 0
    assert (pairhmm_cuda.pairhmm_batch_cuda.launches,
            pairhmm_cuda.pairhmm_f64_batch_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    got = got.cpu()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-4


@pytest.mark.parametrize("shape,chain", [((2048, 512), 64), ((3, 5), 2048),
                                         ((1000,), 0)])
def test_roofline_chain_kernel_matches_plain(cuda_device, shape, chain):
    """csrc/roofline.cu == the plain chain exactly."""
    from mini_parallel_tpu_torch.tools import roofline

    rng = np.random.default_rng(len(shape) + chain)
    a = torch.from_numpy(rng.integers(-3, 3, shape, np.int32)).to(cuda_device)
    b = torch.from_numpy(rng.integers(-100, 100, shape, np.int32)).to(cuda_device)
    launches = roofline.roofline_chain_cuda.launches
    got = roofline.roofline_chain_cuda(a, b, chain)
    torch.cuda.synchronize()
    assert roofline.roofline_chain_cuda.launches == launches + 1
    assert torch.equal(got, roofline.roofline_chain(a, b, chain))


def test_genotype_on_the_card_matches_cpu(tmp_path, cuda_device):
    """--genotype's engine on the card == on the CPU: the same calls, GT
    and GQ, GL within 1e-3, through both Pair-HMM precisions."""
    from mini_parallel_tpu_torch.models import variant_prep as vp
    from mini_parallel_tpu_torch.ops import pairhmm_cuda

    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, 3000).tobytes()
    hap = bytearray(ref)
    for p in (500, 1500, 2500):
        hap[p] = ord("A") if ref[p] != ord("A") else ord("C")
    del hap[2000]
    reads = [bytes(hap[s:s + 150]) for s in rng.integers(0, 2800, 400)]
    path = str(tmp_path / "gt.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=64)
    runs = []
    before = pairhmm_cuda.pairhmm_f64_batch_cuda.launches
    for dev in (cuda_device, torch.device("cpu")):
        eng = vp.VariantPrepEngine(ref, cfg, gapped=True, min_depth=3,
                                   device=dev)
        runs.append(eng.genotype_candidates(path, eng.process_file(path)))
    got, want = runs
    assert pairhmm_cuda.pairhmm_f64_batch_cuda.launches == before + 1
    assert [(c.pos, c.alt_base, c.gt, c.gq) for c in got.candidates] == \
        [(c.pos, c.alt_base, c.gt, c.gq) for c in want.candidates]
    for g, w in zip(got.candidates, want.candidates):
        if w.gl is not None:
            np.testing.assert_allclose(g.gl, w.gl, rtol=0, atol=1e-3)
    assert sum(c.gt == "1/1" for c in got.candidates) >= 3
