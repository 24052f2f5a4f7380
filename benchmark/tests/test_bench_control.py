"""The control (the plain reference in the precision below the one the
configuration states, in the program's place) comes out not correct,
while the program on the same inputs is correct."""

import os

import pytest

from benchmark import run, traffic
from benchmark.tests.tiny import CPU, tiny


def readings(workload, seed, device, tmp_path, parts=None):
    parts = parts or tiny(workload)
    config = parts["config"]
    entry = run.load_file(parts["entry"], "entry").Entry(
        config, traffic.generate(config["sample"], parts["traffic"], seed,
                                 str(tmp_path / "in")), device, seed)
    out = entry.job(str(tmp_path / "job"))
    ref = entry.reference()
    ctl = entry.control(ref, str(tmp_path / "control"), [out])
    return entry.check([out], ref), entry.check(ctl, ref)


def failing(checks):
    return [n for n, v, lim in checks if v > lim]


@pytest.mark.parametrize("workload,number", [
    ("wgs_sw.lanes_gz", "score_gap"),
    ("ecoli_prep.isolate_30x", "gl_gap"),
])
def test_control_fails_program_passes(workload, number, tmp_path):
    program, control = readings(workload, 77, CPU, tmp_path)
    assert failing(program) == []
    assert failing(control) == [number]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["wgs_sw.lanes_gz",
                                      "ecoli_prep.isolate_30x",
                                      "ecoli_prep.control_30x"])
def test_control_fails_on_the_card(workload, cuda_device, tmp_path):
    parts = run.resolve(run.load_spec(), workload)
    sample = parts["config"]["sample"]
    sample["reads_per_file"] = min(sample["reads_per_file"], 50_000)
    for seed in (1, 2, 3):
        program, control = readings(workload, seed, cuda_device,
                                    tmp_path / str(seed), parts)
        assert failing(program) == []
        assert failing(control)
        os.sync()
