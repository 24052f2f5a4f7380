"""The readers of the program's spans (program_spans.py and the five
metrics that use it) on synthetic traces with known spans and on a real
CPU trace of a tiny job, and a run without tracing leaving the program's
span recorder off."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import program_spans, run, traffic
from benchmark.tests.tiny import CPU, run_tiny, tiny
from benchmark.trace import JOB_SPAN, Trace
from mini_parallel_tpu_torch.utils import spans

MS = 1000.0  # trace units (us) per ms


def _chrome(spans_ms):
    """A 10 ms job: ``(name, start ms, duration ms)`` annotations, and a
    torch op inside the first launch."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": JOB_SPAN,
           "ts": 100 * MS, "dur": 10 * MS},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add",
           "ts": 103.6 * MS, "dur": 0.1 * MS}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n,
            "ts": (100 + s) * MS, "dur": d * MS} for n, s, d in spans_ms]
    return ev


WGS = [("process_full_wgs_dataset", 0.0, 10.0),  # the benchmark's own
       ("align.file", 0.5, 9.0),
       ("fastq.wait", 0.5, 2.0),
       ("align.chunk", 2.5, 2.0),
       ("align.pad", 2.5, 0.5), ("align.pack", 3.0, 0.2),
       ("align.put", 3.2, 0.3), ("align.launch", 3.5, 0.5),
       ("align.warm.sync", 4.0, 0.4),
       ("fastq.wait", 4.5, 1.0),
       ("align.chunk", 5.5, 1.0),
       ("align.pad", 5.5, 0.3), ("align.launch", 5.8, 0.4),
       ("align.drain.sync", 8.0, 1.0)]

PREP = [("VariantPrepEngine", 0.0, 2.0),  # the benchmark's own
        ("fasta.read", 0.0, 0.5),
        ("variant.engine_init", 0.5, 1.5), ("variant.index", 1.0, 1.0),
        ("process_file", 2.0, 3.0), ("variant.pass1", 2.0, 3.0),
        ("variant.chunk", 2.0, 1.0), ("variant.prep", 2.0, 0.25),
        ("variant.step", 2.25, 0.5),
        ("variant.drain.sync", 4.0, 0.5),
        ("genotype_candidates", 5.0, 4.0), ("genotype", 5.0, 4.0),
        ("genotype.remap", 5.0, 3.0),
        ("genotype.map", 5.0, 1.0), ("genotype.map.sync", 6.0, 0.5),
        ("genotype.assign", 6.5, 0.5),
        ("genotype.pairhmm", 8.0, 0.5), ("genotype.pairhmm.sync", 8.25, 0.25)]


def _ctx(spans_ms, chunks=2):
    return run.Context(trace=Trace.from_chrome(_chrome(spans_ms)),
                       traced={"reads": 1000, "chunks": chunks,
                               "wall": 0.01})


def metric(name):
    return run.metric_reader(name)


def test_program_spans_are_told_from_the_benchmarks():
    for name in ("process_full_wgs_dataset", "VariantPrepEngine",
                 "process_file", "genotype_candidates",
                 "write_candidates_vcf", JOB_SPAN, "aten::add"):
        assert not program_spans.is_program(name)
    for name in ("genotype", "genotype.remap", "fastq.wait", "vcf.write",
                 "fasta.read", "wgs.checkpoint", "align.warm.sync"):
        assert program_spans.is_program(name)


def test_totals_nest_by_interval_and_keep_self_times():
    tot = program_spans.totals(Trace.from_chrome(_chrome(WGS)))
    assert "process_full_wgs_dataset" not in tot and "aten::add" not in tot
    assert tot["fastq.wait"]["count"] == 2
    assert tot["fastq.wait"]["seconds"] == pytest.approx(0.003)
    assert tot["align.chunk"]["self_seconds"] == pytest.approx(0.0004)
    # the file's self time: its 9 ms less its children's 2 + 2 + 1 + 1 + 1
    assert tot["align.file"]["self_seconds"] == pytest.approx(0.002)
    assert sum(t["self_seconds"] for t in tot.values()) == pytest.approx(
        tot["align.file"]["seconds"])


def test_each_reader_on_known_spans():
    wgs, prep = _ctx(WGS), _ctx(PREP)
    assert metric("decode_wait_share")(wgs) == pytest.approx(0.3)
    assert metric("device_wait_share")(wgs) == pytest.approx(0.14)
    # (2.0 - 0.4 + 1.0) ms of the two chunks' own spans
    assert metric("chunk_host_ms")(wgs) == pytest.approx(1.3)
    assert metric("decode_wait_share")(prep) == 0.0
    assert metric("device_wait_share")(prep) == pytest.approx(0.125)
    # variant.chunk 1.0 ms (pass 1) + map 1.0 + assign 0.5 (pass 2)
    assert metric("chunk_host_ms")(prep) == pytest.approx(1.25)
    assert metric("genotype_remap_share")(prep) == pytest.approx(0.3)
    assert metric("engine_init_share")(prep) == pytest.approx(0.2)


NAMES = ("decode_wait_share", "device_wait_share", "chunk_host_ms",
         "genotype_remap_share", "engine_init_share")


@pytest.mark.parametrize("name", NAMES)
def test_readers_return_nothing_without_the_programs_spans(name):
    bench_only = [s for s in WGS + PREP
                  if not program_spans.is_program(s[0])]
    assert metric(name)(_ctx(bench_only)) is None
    assert metric(name)(run.Context()) is None


@pytest.mark.parametrize("workload", ["wgs_sw.lanes_gz",
                                      "ecoli_prep.control_30x"])
def test_readers_find_the_programs_spans_in_a_real_trace(workload,
                                                         tmp_path):
    """A tiny job of the cell under the CPU profiler, as trace.traced
    runs one on the card: every reader listed for the cell reads a
    value."""
    parts = tiny(workload)
    config = parts["config"]
    entry_mod = run.load_file(parts["entry"], f"spans_{config['entry']}")
    inputs = traffic.generate(config["sample"], parts["traffic"], 987654321,
                              str(tmp_path / "inputs"))
    entry = entry_mod.Entry(config, inputs, CPU, 987654321)
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(JOB_SPAN):
            out = entry.job(str(tmp_path / "job"))
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = Trace.from_chrome(json.load(f)["traceEvents"])
    ctx = run.Context(trace=trace, traced={"reads": entry.reads(out),
                                           "chunks": entry.chunks(out)[0]})
    listed = {m["name"] for m in parts["per_layer"]}
    for name in NAMES:
        if name in listed:
            value = metric(name)(ctx)
            assert value is not None and value >= 0, name
            if name != "chunk_host_ms":
                assert value <= 1.0, name
    tot = program_spans.totals(trace)
    chunk_names = [n for n in program_spans.CHUNK_SPANS if n in tot]
    assert chunk_names
    assert sum(tot[n]["count"] for n in ("align.chunk", "variant.chunk",
                                         "genotype.map")
               if n in tot) == entry.chunks(out)[0]


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_never_starts_the_recorder(monkeypatch, trace):
    def refuse():
        raise AssertionError("the benchmark started the span recorder")

    monkeypatch.setattr(spans, "start", refuse)
    res = run_tiny("wgs_sw.lanes_gz", trace=trace)
    assert res["correct"]
    assert spans._buffer is None
