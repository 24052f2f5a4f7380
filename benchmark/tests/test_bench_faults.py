"""A run with the timed path broken underneath comes out not correct:
a step that returns its state unchanged, half of each batch left out, and
an answer altered where it is produced. (The cells run on one card, so
no exchange between cards can be left out.)"""

import numpy as np
import pytest
import torch

from benchmark.tests.tiny import run_tiny
from mini_parallel_tpu_torch.models import alignment, variant_prep


def wgs_unchanged(monkeypatch):
    monkeypatch.setattr(alignment.AlignmentEngine, "_packed_self_sum",
                        lambda self, kind, arr, lens: torch.zeros(
                            (), dtype=torch.int64))


def wgs_half(monkeypatch):
    inner = alignment.AlignmentEngine._self_align_reads

    def half(self, flat, offs, n_reads, *rest):
        h = n_reads // 2
        return inner(self, flat[: int(offs[h])], offs[: h + 1], h, *rest)

    monkeypatch.setattr(alignment.AlignmentEngine, "_self_align_reads", half)


def wgs_altered(monkeypatch):
    inner = alignment.AlignmentEngine.self_align_file

    def altered(self, *a, **kw):
        res = inner(self, *a, **kw)
        res.score += 1
        return res

    monkeypatch.setattr(alignment.AlignmentEngine, "self_align_file", altered)


def prep_unchanged(monkeypatch):
    monkeypatch.setattr(variant_prep, "_pileup_positions",
                        lambda codes, positions, G, qual_ok=None, acc=None:
                        variant_prep.pileup_view(acc))


def prep_half(monkeypatch):
    inner = variant_prep.VariantPrepEngine.process_flat_batch

    def half(self, flat, offs, acc):
        h = (len(offs) - 1) // 2
        return inner(self, flat[: int(offs[h])], offs[: h + 1], acc)

    monkeypatch.setattr(variant_prep.VariantPrepEngine, "process_flat_batch",
                        half)


def prep_altered(monkeypatch):
    inner = variant_prep.pairhmm.genotype_likelihoods

    def altered(ref, alt):
        rr, ra, aa = inner(ref, alt)
        return rr, ra, aa + 0.5

    monkeypatch.setattr(variant_prep.pairhmm, "genotype_likelihoods", altered)


@pytest.mark.parametrize("workload,fault,number", [
    ("wgs_sw.lanes_gz", wgs_unchanged, "score_gap"),
    ("wgs_sw.lanes_gz", wgs_half, "score_gap"),
    ("wgs_sw.lanes_gz", wgs_altered, "score_gap"),
    ("ecoli_prep.isolate_30x", prep_unchanged, "rows_off"),
    ("ecoli_prep.isolate_30x", prep_half, "mapped_gap"),
    ("ecoli_prep.isolate_30x", prep_altered, "gl_gap"),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, number,
                                            monkeypatch):
    fault(monkeypatch)
    res = run_tiny(workload)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"]
    assert np.isfinite(c["value"])
