"""Cells cut to sizes a CPU test run holds (the same files, smaller
samples)."""

import copy
from pathlib import Path

import torch

from benchmark import run

CPU = torch.device("cpu")
RANK_ENTRY = Path(__file__).resolve().parent / "rank_entry.py"


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


def on_ranks(parts: dict, world: int, fault: dict | None = None) -> dict:
    """A resolved ``wgs_sw`` cell on ``world`` chips through the test entry
    rank_entry.py (the port's multi-process ``--full-wgs``), with the test
    entry's ``fault``."""
    parts = copy.deepcopy(parts)
    parts["cell"].update(name=f"{parts['cell']['name']}.ranks{world}",
                         chips=world)
    parts["entry"] = RANK_ENTRY
    parts["config"].update(entry=RANK_ENTRY.stem, fault=fault)
    return parts


def tiny_ranks(world: int, files: int, fault: dict | None = None) -> dict:
    """``wgs_sw.lanes_gz`` cut as :func:`tiny` cuts it, with ``files``
    lanes of 300 reads, on ``world`` chips (:func:`on_ranks`)."""
    parts = on_ranks(tiny("wgs_sw.lanes_gz"), world, fault)
    parts["config"]["sample"].update(lanes=files, reads_per_lane=1)
    return parts


def run_tiny(workload: str, seed: int = 123456789012, trace: bool = False,
             device=CPU) -> dict:
    return run.run_cell(tiny(workload), seed, 0.2, trace, device)[0]
