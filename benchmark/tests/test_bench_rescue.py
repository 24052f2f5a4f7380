"""``ecoli_rescue.accessory_3x``: the cell resolves and its readers load;
each isolate's inputs hold the absent share and the islands' divergence
they state; a run turns through its isolates and holds each to its own
reference;
the two controls (the rescue sweep saturating at 8 bits, the Pair-HMM in
bfloat16) and a timed path broken underneath (rescue off, a SAM placement
moved) come out not correct, while the program on the same inputs is correct."""

import os

import numpy as np
import pytest
import torch

from benchmark import run, traffic
from benchmark.tests.rescue_tiny import WORKLOAD, tiny_rescue
from mini_parallel_tpu_torch.models import variant_prep

CPU = torch.device("cpu")
SEED = 2147483659


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the CPU routes here are many small torch ops,
    and with a thread per core in each of several test workers every op
    waits for threads the others hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_cell_resolves_and_its_readers_load():
    parts = run.resolve(run.load_spec(), WORKLOAD)
    assert parts["cell"]["chips"] == 1
    assert parts["config"]["engine"]["rescue"] is True
    assert [m["name"] for m in parts["end_to_end"]] == [
        "setup_s", "card_ms_per_mreads"]
    names = [m["name"] for m in parts["per_layer"]]
    assert names == ["launches_per_chunk.card", "job_reads_per_s",
                     "sw_vs_ref_roofline", "rescue_card_share"]
    for name in names:
        assert callable(run.metric_reader(name))
    entry = run.load_file(parts["entry"], "entry_variant_rescue")
    assert callable(entry.Entry.cells)


def _entry(parts, tmp_path, seed=SEED, device=CPU):
    config = parts["config"]
    inputs = traffic.generate(config["sample"], parts["traffic"], seed,
                              str(tmp_path / "in"))
    return run.load_file(parts["entry"], "entry").Entry(config, inputs,
                                                        device, seed)


def test_the_inputs_hold_the_absent_share_and_the_islands(tmp_path):
    """Each isolate of a run: exactly the configuration's absent share;
    the islands differ from the sample's contig at their divergence and
    nowhere else; the lanes on disk are the reads the truth describes; each
    absent read is drawn from the absent contig, on either strand. The
    isolates share the reads of the present contigs and differ in their
    islands, their absent contig and their files."""
    from benchmark.reference import variant as plain_prep
    from mini_parallel_tpu_torch.io import fastq

    parts = tiny_rescue()
    sample = parts["config"]["sample"]
    sample.update(reads_per_file=900)
    sample["absent"]["reads_per_file"] = 100
    entry = _entry(parts, tmp_path)
    original = traffic.generate(sample, parts["traffic"], SEED,
                                str(tmp_path / "again"))
    before = np.frombuffer(original.contigs[0][1], np.uint8)
    assert len(entry.isolates) == sample["isolates"] == 2
    for iso in entry.isolates:
        truth = iso.inputs.truth
        n = sum(s.shape[0] for s in iso.inputs.seqs)
        assert truth["absent_rows"].size / n == 0.1
        after = np.frombuffer(iso.inputs.contigs[0][1], np.uint8)
        inside = np.zeros(before.size, bool)
        for _, s, e in truth["islands"]:
            inside[s:e] = True
        assert inside.sum() == round(0.125 * before.size)
        assert not (before != after)[~inside].any()
        assert abs((before != after)[inside].mean() - 0.1) < 1e-3
        for path, seqs in zip(iso.files, iso.inputs.seqs):
            flat, offs = next(fastq.iter_flat_chunks(path, 10**6))
            assert (flat.reshape(-1, 150) == seqs).all()
        acc = truth["absent"][0][1]
        seqs = np.concatenate(iso.inputs.seqs)[truth["absent_rows"]]
        assert all(s.tobytes() in acc
                   or plain_prep.COMP[s][::-1].tobytes() in acc
                   for s in seqs)
    a, b = (iso.inputs for iso in entry.isolates)
    assert a.truth["islands"] != b.truth["islands"]
    assert a.truth["absent"] != b.truth["absent"]
    assert not set(a.files + [a.reference]) & set(b.files + [b.reference])

    def present(inp):
        return np.delete(np.concatenate(inp.seqs), inp.truth["absent_rows"],
                         0)

    assert (present(a) == present(b)).all()


def test_the_window_turns_through_the_isolates_from_the_first(tmp_path,
                                                               monkeypatch):
    """The warm-up job runs the last isolate, the window's jobs the first,
    the second, the first..., so that a traced run traces the first."""
    entry = _entry(tiny_rescue(), tmp_path)
    monkeypatch.setattr(type(entry.isolates[0]), "job",
                        lambda self, jobdir: {"ran": self.k})
    outs = [entry.job(str(tmp_path / f"j{k}")) for k in range(4)]
    assert [o["isolate"] for o in outs] == [1, 0, 1, 0]
    assert all(o["ran"] == o["isolate"] for o in outs)


def test_a_check_holds_each_isolate_to_its_own_reference(tmp_path,
                                                         monkeypatch):
    """Each isolate's jobs go to its own reference; the numbers add up
    over the isolates, but ``gl_gap``, which is the largest."""
    entry = _entry(tiny_rescue(), tmp_path)

    def check(self, outs, ref):
        assert ref == f"ref{self.k}"
        assert all(o["isolate"] == self.k for o in outs)
        return [("sam_off", len(outs) * (self.k + 1), 0),
                ("gl_gap", 0.1 * (self.k + 1), 0.01)]

    monkeypatch.setattr(type(entry.isolates[0]), "check", check)
    outs = [{"isolate": k} for k in (0, 1, 0)]
    refs = ["ref0", "ref1"]
    assert entry.check(outs, refs) == [("sam_off", 4, 0),
                                       ("gl_gap", 0.2, 0.01)]
    assert entry.check(outs[:1], refs) == [("sam_off", 1, 0),
                                           ("gl_gap", 0.1, 0.01)]


def _failing(checks):
    return [n for n, v, lim in checks if v > lim]


def test_the_control_fails_sam_off_and_the_program_passes(tmp_path):
    parts = tiny_rescue()
    entry = _entry(parts, tmp_path)
    out = entry.job(str(tmp_path / "job"))
    ref = entry.reference()
    assert _failing(entry.check([out], ref)) == []
    sweep, hmm = entry.control(ref, str(tmp_path / "control"), [out])
    for ctl, fails in ((sweep, "sam_off"), (hmm, "gl_gap")):
        checks = {n: (v, lim) for n, v, lim in entry.check([ctl], ref)}
        assert checks[fails][0] > checks[fails][1]
        assert checks["reads_gap"][0] == checks["mapped_gap"][0] == 0
    assert _failing(entry.check([hmm], ref)) == ["gl_gap"]


def rescue_off(monkeypatch):
    monkeypatch.setattr(
        variant_prep, "_rescue_unmapped",
        lambda codes, rc, lens, ref, starts, mapped, frac:
        (codes, starts, mapped, torch.zeros_like(mapped)))


def placement_moved(monkeypatch):
    inner = variant_prep._write_sam_batch

    def moved(f, flat, offs, positions, *rest):
        return inner(f, flat, offs, np.where(positions >= 0, positions + 1,
                                             positions), *rest)

    monkeypatch.setattr(variant_prep, "_write_sam_batch", moved)


@pytest.mark.parametrize("fault,numbers", [
    (rescue_off, ("sam_off", "rows_off")),
    (placement_moved, ("sam_off",)),
])
def test_a_broken_timed_path_is_not_correct(fault, numbers, monkeypatch):
    fault(monkeypatch)
    res = run.run_cell(tiny_rescue(), 123456789012, 0.2, False, CPU)[0]
    assert not res["correct"]
    assert any(res["checks"][n]["value"] > res["checks"][n]["limit"]
               for n in numbers)


@pytest.mark.cuda
def test_the_control_fails_on_the_card(cuda_device, tmp_path):
    """At the cell's own size: the program correct, the 8-bit sweep's
    control not on sam_off, the bfloat16 Pair-HMM's not on gl_gap."""
    parts = run.resolve(run.load_spec(), WORKLOAD)
    entry = _entry(parts, tmp_path, 3, cuda_device)
    out = entry.job(str(tmp_path / "job"))
    ref = entry.reference()
    assert _failing(entry.check([out], ref)) == []
    sweep, hmm = entry.control(ref, str(tmp_path / "control"), [out])
    assert "sam_off" in _failing(entry.check([sweep], ref))
    assert _failing(entry.check([hmm], ref)) == ["gl_gap"]
    os.sync()


def test_the_rescue_reference_loads_nothing_of_the_program():
    from benchmark.tests.test_bench_imports import modules

    loaded = modules("import json, sys\n"
                     "from benchmark.reference import rescue\n"
                     "print(json.dumps(sorted(sys.modules)))")
    assert not [m for m in loaded
                if m.split(".")[0] in ("jax", "jaxlib",
                                       "mini_parallel_tpu",
                                       "mini_parallel_tpu_torch")]
