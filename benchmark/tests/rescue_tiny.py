"""``ecoli_rescue.accessory_3x`` cut to a size a CPU test run holds: two
lanes of 180 reads of a 14 kb reference and 20 of a 2 kb absent contig,
one 1.5 kb island at 10 % divergence, 128-read chunks; two isolates a run,
as the cell has."""

import copy

from benchmark import run

WORKLOAD = "ecoli_rescue.accessory_3x"


def tiny_rescue() -> dict:
    parts = copy.deepcopy(run.resolve(run.load_spec(), WORKLOAD))
    config = parts["config"]
    config["engine"]["chunk_size_reads"] = 128
    sample = config["sample"]
    sample.update(reads_per_file=180, contigs=[["c1", 12000], ["c2", 2000]])
    sample["absent"] = {"contigs": [["acc", 2000]], "reads_per_file": 20}
    sample["islands"] = {"contig": "c1", "share": 0.125, "divergence": 0.1,
                         "length": [1500, 1500]}
    parts["traffic"]["variants"].update(snps=40, deletions=6, insertions=6)
    return parts


def tiny_entry(out_dir: str, seed: int = 2147483659, device=None):
    """The tiny cell's first isolate, alone in its run (its inputs, its
    job and its plain reference), on inputs generated under ``out_dir``."""
    import torch

    from benchmark import traffic

    parts = tiny_rescue()
    config = parts["config"]
    inputs = traffic.generate(config["sample"], parts["traffic"], seed,
                              out_dir)
    entry = run.load_file(parts["entry"], "entry_variant_rescue")
    return entry.Isolate(config, inputs, device or torch.device("cpu"),
                         seed)
