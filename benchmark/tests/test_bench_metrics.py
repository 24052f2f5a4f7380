"""The trace reduction and each per-layer metric's arithmetic, on a
synthetic trace."""

import pytest

from benchmark import card, run, work
from benchmark.trace import JOB_SPAN, Trace

H100 = card.peaks("NVIDIA H100 80GB HBM3")


def chrome():
    """A 10 ms job: two sw_score kernels (1 ms each, overlapping a copy),
    a copy, a set, a host op, and events outside the window."""
    us = 1000.0
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": JOB_SPAN,
         "ts": 100 * us, "dur": 10 * us},
        {"ph": "X", "cat": "gpu_user_annotation", "name": JOB_SPAN,
         "ts": 100 * us, "dur": 10 * us},
        {"ph": "X", "cat": "kernel", "name": "void sw_score_kernel<5>()",
         "ts": 101 * us, "dur": 1 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 101.5 * us, "dur": 1 * us},
        {"ph": "X", "cat": "kernel", "name": "void sw_score_kernel<5>()",
         "ts": 105 * us, "dur": 1 * us},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset",
         "ts": 108 * us, "dur": 0.5 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::where",
         "ts": 103 * us, "dur": 1.5 * us},
        {"ph": "X", "cat": "user_annotation", "name": "process_file",
         "ts": 100 * us, "dur": 10 * us},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 50 * us,
         "dur": 1 * us},
    ]
    return ev


def test_trace_reduction():
    t = Trace.from_chrome(chrome())
    assert t.window_s == pytest.approx(0.010)
    assert t.launches() == 4
    # union: [1, 2.5) + [5, 6) + [8, 8.5) ms
    assert t.busy_s() == pytest.approx(0.003)
    assert t.kernel_s("sw_score_kernel") == pytest.approx(0.002)
    assert t.kernel_s() == pytest.approx(0.002)
    gaps = t.gaps()
    assert [round(b - a, 6) for a, b in gaps] == [0.001, 0.0025, 0.002,
                                                  0.0015]
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["void sw_score_kernel<5>()",
                                   pytest.approx(0.002)]
    labels = dict(bd["idle_gaps"])
    assert labels["process_file > aten::where"] == pytest.approx(0.0025)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_trace_needs_one_job_span():
    with pytest.raises(ValueError):
        Trace.from_chrome([e for e in chrome() if e["name"] != JOB_SPAN])


def context(**kw):
    ctx = run.Context(trace=Trace.from_chrome(chrome()),
                      traced={"reads": 2000, "chunks": 4, "wall": 0.01},
                      jobs=[{"wall": 2.0, "reads": 1000,
                             "spans": {"genotype_candidates": 0.5}},
                            {"wall": 4.0, "reads": 1400,
                             "spans": {"genotype_candidates": 1.0}}],
                      decode_s=1.5, card=H100, cells=10_000 * 150 * 150)
    for k, v in kw.items():
        setattr(ctx, k, v)
    return ctx


def metric(name):
    return run.metric_reader(name)


def test_each_metric_on_the_synthetic_trace():
    ctx = context()
    assert metric("genotype_ratio")(ctx) == pytest.approx(1.5 / 6.0)
    assert metric("decode_floor_ratio")(ctx) == pytest.approx(1.5 / 3.0)
    assert metric("launches_per_chunk")(ctx) == pytest.approx(1.0)
    # a quantity split by the metric it moves reads as the quantity
    assert metric("launches_per_chunk.card")(ctx) == pytest.approx(1.0)
    assert metric("job_reads_per_s")(ctx) == pytest.approx(2400 / 6.0)
    assert metric("kernel_ms_per_mreads")(ctx) == pytest.approx(
        2.0 / 0.002)
    assert metric("device_idle_share")(ctx) == pytest.approx(0.7)
    least = 10_000 * 150 * 150 * 2 / (132 * 64 * 2 * 1980e6)
    assert metric("sw_score_roofline")(ctx) == pytest.approx(
        100 * least / 0.002)


def test_readers_return_nothing_without_their_source():
    assert metric("genotype_ratio")(context(jobs=[{"wall": 1.0,
                                                   "spans": {}}])) is None
    assert metric("decode_floor_ratio")(context(decode_s=None)) is None
    assert metric("job_reads_per_s")(context(jobs=[])) is None
    none = context(trace=None)
    for name in ("launches_per_chunk", "kernel_ms_per_mreads",
                 "device_idle_share", "sw_score_roofline"):
        assert metric(name)(none) is None
    assert metric("sw_score_roofline")(context(card=None)) is None


def test_the_roofline_peak_bounds_any_implementation():
    # 16x2 lanes at the boost clock; two three-input instructions a cell
    assert card.int16x2_ops_per_s(H100) == pytest.approx(33.45e12, rel=1e-3)
    assert work.OPS_PER_CELL["sw_linear"] == 2
    assert work.self_alignment_cells([150, 100]) == 150**2 + 100**2
