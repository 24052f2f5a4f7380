"""Cells cut to sizes a CPU test run holds (the same files, smaller
samples)."""

import copy

import torch

from benchmark import run

CPU = torch.device("cpu")


def tiny(workload: str) -> dict:
    """The resolved cell with its sample cut: two files of 300 reads and
    128-read chunks for wgs_sw; two lanes of 1,500 reads over 23 kb and
    76 variants for ecoli_prep."""
    parts = copy.deepcopy(run.resolve(run.load_spec(), workload))
    sample = parts["config"]["sample"]
    if parts["config"]["entry"] == "full_wgs":
        sample.update(lanes=1, reads_per_lane=2, reads_per_file=300)
        parts["config"]["engine"]["chunk_size_reads"] = 128
    else:
        sample.update(reads_per_file=1500,
                      contigs=[["c1", 20000], ["c2", 3000]])
        if parts["traffic"]["variants"]:
            parts["traffic"]["variants"].update(snps=60, deletions=8,
                                                insertions=8)
    return parts


def run_tiny(workload: str, seed: int = 123456789012, trace: bool = False,
             device=CPU) -> dict:
    return run.run_cell(tiny(workload), seed, 0.2, trace, device)[0]
