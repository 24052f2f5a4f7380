"""One tiny run per configuration through its entry on the CPU, judged
by the plain reference, and the result's keys."""

import json

import pytest

from benchmark import run
from benchmark.tests.tiny import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
# what a run on the CPU can report: card_ms_per_mreads needs the card
ON_CPU = {"wgs_sw.lanes_gz": {"reads_per_s", "setup_s"},
          "wgs_sw.lanes_plain": {"setup_s"},
          "ecoli_prep.isolate_30x": {"setup_s"},
          "ecoli_prep.control_30x": {"reads_per_s", "setup_s"}}
TRACED_ON_CPU = {"ecoli_prep.isolate_30x": {"job_reads_per_s"},
                 "ecoli_prep.control_30x": {"genotype_ratio",
                                            "decode_floor_ratio"}}


@pytest.mark.parametrize("workload", sorted(ON_CPU))
def test_tiny_run_matches_the_reference(workload):
    res = run_tiny(workload)
    assert list(res) == KEYS  # the numbers compared come last
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == ON_CPU[workload]
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("workload", sorted(TRACED_ON_CPU))
def test_traced_run_reports_per_layer_metrics_only(workload):
    res = run_tiny(workload, trace=True)
    # no card: the trace readers find nothing; the host-clock ones do
    assert set(res["metrics"]) == TRACED_ON_CPU[workload]
    if "genotype_ratio" in res["metrics"]:
        assert 0 < res["metrics"]["genotype_ratio"]["value"] < 1
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["correct"]


def test_main_refuses_without_the_cards(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "wgs_sw.lanes_gz", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_main_refuses_four_chips_on_one_card(monkeypatch, capsys):
    import torch

    spec = run.load_spec()
    cell = dict(spec["workloads"][0], name="four_chips", chips=4)
    spec["workloads"].append(cell)
    monkeypatch.setattr(run, "load_spec", lambda: spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", "four_chips", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "4 CUDA card(s); 1 available" in out.err


@pytest.mark.cuda
def test_tiny_run_on_the_card(cuda_device):
    for workload in ("wgs_sw.lanes_gz", "ecoli_prep.isolate_30x"):
        res = run_tiny(workload, trace=True, device=cuda_device)
        assert res["correct"], res["checks"]
        assert res["device"]["busy_s"] > 0
        assert res["metrics"]
    res = run_tiny("wgs_sw.lanes_plain", device=cuda_device)
    assert res["correct"], res["checks"]
    assert res["metrics"]["card_ms_per_mreads"]["value"] > 0
