"""The generator: deterministic per seed, different across seeds, the
stated shapes."""

import gzip

import numpy as np
import pytest

from benchmark import traffic
from benchmark.tests.tiny import tiny


def generate(workload, seed, tmp_path):
    parts = tiny(workload)
    return traffic.generate(parts["config"]["sample"], parts["traffic"],
                            seed, str(tmp_path / str(seed)))


def raw(path):
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if path.endswith(".gz") else data


@pytest.mark.parametrize("workload", ["wgs_sw.lanes_gz",
                                      "ecoli_prep.isolate_30x"])
def test_same_seed_same_bytes_other_seed_other_bytes(workload, tmp_path):
    a = generate(workload, 2**31 + 5, tmp_path / "a")
    b = generate(workload, 2**31 + 5, tmp_path / "b")
    c = generate(workload, 2**31 + 6, tmp_path / "c")
    for fa, fb, fc in zip(a.files, b.files, c.files):
        assert raw(fa) == raw(fb)
        assert raw(fa) != raw(fc)
        assert len(raw(fa)) == len(raw(fc))  # every seed the same sizes


@pytest.mark.parametrize("workload", ["wgs_sw.lanes_gz", "wgs_sw.lanes_plain",
                                      "ecoli_prep.isolate_30x"])
def test_records_are_casava_with_full_quality_lines(workload, tmp_path):
    inp = generate(workload, 11, tmp_path)
    gz = workload.endswith("gz") or workload.startswith("ecoli")
    assert all(f.endswith(".fastq.gz") == gz for f in inp.files)
    lines = raw(inp.files[0]).split(b"\n")[:-1]
    assert len(lines) == 4 * inp.seqs[0].shape[0]
    head = lines[0].split(b" ")
    assert head[0].startswith(b"@") and len(head[0].split(b":")) == 7
    assert head[1].startswith(b"1:N:0:")
    for seq, plus, qual in zip(lines[1::4], lines[2::4], lines[3::4]):
        assert len(seq) == len(qual) == 150 and plus == b"+"
        assert set(qual) <= set(b"#-8F")
    seqs = np.stack([np.frombuffer(s, np.uint8) for s in lines[1::4]])
    assert (seqs == inp.seqs[0]).all()


def test_isolate_plants_its_variants_and_control_none(tmp_path):
    iso = generate("ecoli_prep.isolate_30x", 3, tmp_path / "i")
    t = iso.truth
    assert (len(t["snps"]), len(t["deletions"]), len(t["insertions"])) == \
        (60, 8, 8)
    assert {c for c, _, _ in t["snps"]} == {0, 1}  # spread over contigs
    ctl = generate("ecoli_prep.control_30x", 3, tmp_path / "c")
    assert ctl.truth == {"snps": [], "deletions": [], "insertions": {}}
    assert [n for n, _ in ctl.contigs] == ["c1", "c2"]
    assert sum(len(s) for _, s in ctl.contigs) == 23000


def test_error_and_n_rates(tmp_path):
    lanes = generate("wgs_sw.lanes_gz", 4, tmp_path)
    share = np.mean(np.concatenate(lanes.seqs) == ord("N"))
    assert 0.0003 < share < 0.003
    q = np.concatenate(lanes.quals)
    assert 0.8 < np.mean(q == ord("F")) < 0.9
