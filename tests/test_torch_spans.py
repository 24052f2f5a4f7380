"""The port's span recorder (utils/spans.py) on the CPU: off, it is one
shared no-op that reads no clock; on, the --full-wgs chunk path, the
prefetch queue and the genotyper record nested spans that share chunk
ids, whose self times add up to their roots; under a torch profiler the
spans sit in its trace, and the decoder thread's spans are placed on the
trace's clock by the anchor."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mini_parallel_tpu_torch.io import fastq
from mini_parallel_tpu_torch.models import variant_prep as vp
from mini_parallel_tpu_torch.models.alignment import AlignmentEngine
from mini_parallel_tpu_torch.utils import spans
from mini_parallel_tpu_torch.utils.config import Config
from tests.conftest import random_dna

CPU = torch.device("cpu")
CHUNK_READS = 5
CONSUMER_PER_CHUNK = ("align.chunk", "align.pad", "align.pack", "align.put",
                      "align.launch")


@pytest.fixture
def recorder():
    """Stops the recorder whatever the test left on."""
    yield spans
    if spans._buffer is not None:
        spans.stop()


def _lane(tmp_path, rng, n_reads=17):
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, [random_dna(rng, int(rng.integers(30, 61)))
                             for _ in range(n_reads)])
    return path


def _engine():
    return AlignmentEngine(Config(chunk_size_reads=CHUNK_READS, read_pad=64),
                           mode="sw", device=CPU)


def _subtree(rec, root_id):
    """The spans under ``root_id`` (itself included)."""
    ids, out = {root_id}, []
    for s in sorted(rec.spans, key=lambda s: s.start_ns):
        if s.id in ids or s.parent in ids:
            ids.add(s.id)
            out.append(s)
    return out


def test_recorder_off_is_one_shared_noop(monkeypatch):
    def clock_read():
        raise AssertionError("a span read the clock with the recorder off")

    assert spans._buffer is None and not spans._profiling()
    with monkeypatch.context() as m:
        m.setattr(spans.time, "perf_counter_ns", clock_read)
        a, b = spans.span("align.pad", 3), spans.span("fastq.wait")
        with a:
            spans.count("fastq.chunks")
        with b:
            pass
    assert a is b is spans._NOOP
    with spans.timed("align.drain.sync") as t:
        sum(range(1000))
    assert t.seconds > 0  # a timed span reads the clock all the same


def test_spans_of_the_chunk_path_nest_and_add_up(tmp_path, rng, recorder):
    path = _lane(tmp_path, rng)
    eng = _engine()
    recorder.start()
    res = eng.self_align_file(path)
    rec = recorder.stop()
    n_chunks = -(-17 // CHUNK_READS)
    assert res.chunks == n_chunks >= 3
    # the lane is one gzip member, which the reader inflates itself
    assert rec.counters == {"fastq.chunks": n_chunks, "fastq.members": 1,
                            "fastq.members_ahead": 0,
                            "fastq.split_rejected": 0}
    main = threading.get_native_id()
    by_id = {s.id: s for s in rec.spans}
    (root,) = [s for s in rec.spans if s.name == "align.file"]
    assert root.thread == main and root.parent is None
    for c in range(n_chunks):
        decode = [s for s in rec.spans
                  if s.name == "fastq.decode" and s.chunk == c]
        assert len(decode) == 1 and decode[0].thread != main
        assert rec.threads[decode[0].thread] == "mptt-prefetch"
        for name in CONSUMER_PER_CHUNK:
            mine = [s for s in rec.spans if s.name == name and s.chunk == c]
            assert len(mine) == 1 and mine[0].thread == main, (name, c)
            # chunk -> file; pad, pack, put, launch -> chunk
            up = by_id[mine[0].parent]
            assert up.name == ("align.file" if name == "align.chunk"
                               else "align.chunk")
    for s in rec.spans:  # a parent is open around its child, on its thread
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    under = _subtree(rec, root.id)
    assert {s.thread for s in under} == {main}
    # every consumer span of the recording is under the file's root
    assert len(under) == sum(s.thread == main for s in rec.spans)
    tot = spans.Recording(under, {}, {}).totals()
    assert all(t["self_seconds"] >= 0 for t in tot.values())
    assert sum(t["self_seconds"] for t in tot.values()) == pytest.approx(
        tot["align.file"]["seconds"], rel=1e-9)
    assert tot["align.file"]["count"] == 1
    assert tot["align.chunk"]["count"] == n_chunks


def test_file_timings_are_their_sync_spans(tmp_path, rng, recorder):
    path = _lane(tmp_path, rng)
    off = _engine().self_align_file(path)
    assert off.drain_seconds > 0 and off.warmup_seconds > 0
    eng = _engine()
    recorder.start()
    res = eng.self_align_file(path)
    tot = recorder.stop().totals()
    assert res.drain_seconds == pytest.approx(
        tot["align.drain.sync"]["seconds"], rel=1e-12)
    assert res.warmup_seconds == pytest.approx(
        tot["align.warm.sync"]["seconds"], rel=1e-12)
    assert tot["align.drain.sync"]["count"] == 1
    assert res.score == off.score


def test_spans_sit_in_the_profiler_trace(tmp_path, rng, recorder):
    path = _lane(tmp_path, rng)
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recorder.start()
        eng.self_align_file(path)
        rec = recorder.stop()
    assert rec.anchor_ns is not None
    trace_path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace_path)
    added = spans.append_to_chrome_trace(trace_path, rec)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ann = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    main = threading.get_native_id()
    names = {e["name"] for e in ann if e["tid"] == main}
    assert {"align.file", spans.ANCHOR, *CONSUMER_PER_CHUNK} <= names
    decode = [e for e in ann if e["name"] == "fastq.decode"]
    assert decode and all(e["tid"] != main for e in decode)
    assert added == sum(s.thread != main for s in rec.spans)
    (root,) = [e for e in ann if e["name"] == "align.file"]
    slack = 1000.0  # us
    for e in decode:
        assert root["ts"] - slack <= e["ts"]
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + slack
    counters = {e["name"]: e["args"]["value"] for e in events
                if e.get("ph") == "C"}
    assert counters == {"fastq.chunks": -(-17 // CHUNK_READS),
                        "fastq.members": 1, "fastq.members_ahead": 0,
                        "fastq.split_rejected": 0}


def test_variant_prep_job_records_its_stages_in_order(tmp_path, recorder):
    rng = np.random.default_rng(0)
    ref = random_dna(rng, 2000)
    pos = 600
    alt = b"A" if ref[pos:pos + 1] != b"A" else b"C"
    hap = ref[:pos] + alt + ref[pos + 1:]
    reads = [(hap if i % 2 else ref)[pos - 20 - (i % 10):pos + 40 - (i % 10)]
             for i in range(40)]
    path = str(tmp_path / "gt.fastq.gz")
    fastq.write_fastq(path, reads)
    recorder.start()
    eng = vp.VariantPrepEngine(ref, Config(chunk_size_reads=16, read_pad=64),
                               min_depth=3, gapped=True, gap_model="affine",
                               device=CPU)
    res = eng.genotype_candidates(path, eng.process_file(path))
    vp.write_candidates_vcf(str(tmp_path / "c.vcf"), res)
    rec = recorder.stop()
    assert any(c.gt for c in res.candidates)
    first = {}
    for s in sorted(rec.spans, key=lambda s: s.start_ns):
        first.setdefault(s.name, s)
    order = ["variant.engine_init", "variant.pass1", "genotype.remap",
             "genotype.pairhmm", "vcf.write"]
    starts = [first[n].start_ns for n in order]
    assert starts == sorted(starts)
    by_id = {s.id: s for s in rec.spans}
    assert by_id[first["variant.index"].parent].name == "variant.engine_init"
    assert rec.counters["variant.index.seeds"] == len(eng.index) > 0
    syncs = [s for s in rec.spans if s.name == "genotype.map.sync"]
    assert len(syncs) == -(-40 // 16)
    assert {by_id[s.parent].name for s in syncs} == {"genotype.remap"}
    assert sorted(s.chunk for s in syncs) == [0, 1, 2]
    pair_sync = first["genotype.pairhmm.sync"]
    assert by_id[pair_sync.parent].name == "genotype.pairhmm"
    assert by_id[first["genotype.remap"].parent].name == "genotype"
    steps = [s for s in rec.spans if s.name == "variant.step"]
    assert sorted(s.chunk for s in steps) == [0, 1, 2]


def test_pileup_events_are_counted_once_a_job(tmp_path, recorder):
    """``variant.pileup.events``, taken at the drain, is the pileup's total:
    two jobs in one recording count both totals, each once; the recorder
    says it is on only between start and stop, the only time the total is
    summed."""
    rng = np.random.default_rng(1)
    ref = random_dna(rng, 1500)
    reads = [ref[s:s + 60] for s in rng.integers(0, 1440, 30).tolist()]
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=16, read_pad=64)
    assert not recorder.recording()
    recorder.start()
    assert recorder.recording()
    totals = []
    for gapped in (True, False):
        eng = vp.VariantPrepEngine(ref, cfg, gapped=gapped, device=CPU)
        totals.append(int(eng.process_file(path).pileup.sum()))
    rec = recorder.stop()
    assert not recorder.recording()
    drains = [s for s in rec.spans if s.name == "variant.drain.sync"]
    assert len(drains) == 2 and totals[0] > 0
    assert rec.counters["variant.pileup.events"] == sum(totals)



@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for the rescue's tests: the CPU rescue is many
    small torch ops, and with a thread per core in each of the suite's
    workers every op waits for threads the other workers hold (about 20x
    slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def isolate(tmp_path_factory, one_thread):
    """A small isolate with absent and diverged reads (the benchmark's
    ``ecoli_rescue`` cut small) and its plain reference, every
    seed-missed read swept."""
    from benchmark.tests.rescue_tiny import tiny_entry

    entry = tiny_entry(str(tmp_path_factory.mktemp("isolate") / "in"))
    ref = entry.reference()
    ref.rescue(np.flatnonzero(~ref.seed_mapped))
    return entry, ref


def _rescue_engine(entry):
    from mini_parallel_tpu_torch.io import fasta

    p = entry.p
    return vp.VariantPrepEngine(
        fasta.read_fasta(entry.inputs.reference), entry.cfg,
        min_depth=p["min_depth"], alt_fraction=p["alt_fraction"],
        gapped=True, rescue=True, rescue_min_frac=p["rescue_min_frac"],
        gap_model=p["gap_model"], device=CPU)


def test_rescue_counts_its_rows_and_rescued_reads(isolate, recorder):
    """Each pass over the reads (the pileup's and the genotyper's) sweeps
    both strands of every read the plain seed mapper misses and rescues
    the reads the plain sweep rescues; ``variant.rescue`` runs inside each
    chunk's step."""
    entry, ref = isolate
    eng = _rescue_engine(entry)
    recorder.start()
    res = eng.genotype_candidates(entry.files, eng.process_file(entry.files))
    rec = recorder.stop()
    assert any(c.gt for c in res.candidates)
    missed = int((~ref.seed_mapped).sum())
    assert missed > 0 and ref.rescued().size > 0
    assert rec.counters["variant.rescue.rows"] == 2 * 2 * missed
    assert rec.counters["variant.rescue.rescued"] == 2 * ref.rescued().size
    by_id = {s.id: s for s in rec.spans}
    parents = [by_id[s.parent].name for s in rec.spans
               if s.name == "variant.rescue"]
    chunks = sum(-(-s.shape[0] // entry.cfg.chunk_size_reads)
                 for s in entry.inputs.seqs)
    assert sorted(parents) == (["genotype.map"] * chunks
                               + ["variant.step"] * chunks)


def test_the_sam_pass_records_its_spans(isolate, recorder, tmp_path):
    """``process_file(sam_out=...)`` records the first pass's spans: each
    chunk's step, its copies to the host and its SAM write inside
    ``variant.chunk`` (with the chunk's id), inside ``variant.pass1``."""
    entry, ref = isolate
    eng = _rescue_engine(entry)
    recorder.start()
    res = eng.process_file(entry.files, sam_out=str(tmp_path / "a.sam"))
    rec = recorder.stop()
    assert res.mapped_reads > 0
    by_id = {s.id: s for s in rec.spans}
    chunks = sum(-(-s.shape[0] // entry.cfg.chunk_size_reads)
                 for s in entry.inputs.seqs)
    for name in ("variant.prep", "variant.sam.step", "variant.sam.sync",
                 "variant.sam.write"):
        mine = [s for s in rec.spans if s.name == name]
        assert sorted(s.chunk for s in mine) == list(range(chunks))
        assert {by_id[s.parent].name for s in mine} == {"variant.chunk"}
    steps = [s for s in rec.spans if s.name == "variant.chunk"]
    assert sorted(s.chunk for s in steps) == list(range(chunks))
    assert {by_id[s.parent].name for s in steps} == {"variant.pass1"}
    assert {by_id[s.parent].name for s in rec.spans
            if s.name == "variant.rescue"} == {"variant.sam.step"}
    assert rec.counters["variant.rescue.rescued"] == ref.rescued().size


def test_rescue_counters_cost_nothing_unrecorded(isolate, monkeypatch,
                                                recorder):
    """With the recorder off the rescue's counters are not computed (no
    device sync is added); on, they are, once a chunk."""
    entry, _ = isolate
    calls = []
    inner = vp._count_rescue
    monkeypatch.setattr(vp, "_count_rescue",
                        lambda *a: calls.append(1) or inner(*a))
    eng = _rescue_engine(entry)
    eng.process_file(entry.files)
    assert calls == []
    recorder.start()
    eng.process_file(entry.files)
    recorder.stop()
    assert len(calls) == sum(-(-s.shape[0] // entry.cfg.chunk_size_reads)
                             for s in entry.inputs.seqs)


def test_threads_record_without_losing_a_span_or_a_count(recorder):
    """More threads than cores open nested spans and count at once, with a
    short switch interval: every span and count is kept, and each span's
    parent is its own thread's."""
    n_threads, n_spans = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        recorder.start()

        def work(t):
            for i in range(n_spans):
                with spans.span("stress.outer", t):
                    with spans.span("stress.inner"):
                        spans.count("stress.n")

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        rec = recorder.stop()
    finally:
        sys.setswitchinterval(old)
    assert rec.counters == {"stress.n": n_threads * n_spans}
    tot = rec.totals()
    assert tot["stress.outer"]["count"] == n_threads * n_spans
    assert tot["stress.inner"]["count"] == n_threads * n_spans
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == 2 * n_threads * n_spans
    for s in rec.spans:
        if s.name == "stress.inner":
            outer = by_id[s.parent]
            assert outer.name == "stress.outer"
            assert outer.thread == s.thread and outer.chunk == s.chunk
    assert len(rec.threads) == n_threads


def test_a_span_open_across_recordings_closes_cleanly(recorder):
    """A span opened in one recording and closed in the next leaves both
    intact: it is in neither, and the next one's nesting is its own."""
    recorder.start()
    outer = spans.span("left.open")
    outer.__enter__()
    first = recorder.stop()
    recorder.start()
    with spans.span("next.one", 7):
        pass
    outer.__exit__(None, None, None)
    with spans.span("next.two"):
        pass
    second = recorder.stop()
    assert first.spans == []
    assert [(s.name, s.parent, s.chunk) for s in second.spans] == [
        ("next.one", None, 7), ("next.two", None, None)]
