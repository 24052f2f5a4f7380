"""The readings the limits of ``correct`` are set from, on the card, at a
cell's own size: for each seed, one whole job of the program and the
control (the plain reference in the precision below the one the
configuration states, put in the program's place), both judged by the
plain reference as a run judges its jobs. The benchmark's own runs do not
run this.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed: {"seed", "program": {number: value},
"control": {number: value}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from benchmark import run, traffic


def readings(parts: dict, seed: int, device) -> dict:
    """The program's and the control's numbers on one seed."""
    config = parts["config"]
    entry_mod = run.load_file(parts["entry"], "benchmark_entry")
    with tempfile.TemporaryDirectory(prefix="benchmark-control-") as work:
        inputs = traffic.generate(config["sample"], parts["traffic"], seed,
                                  os.path.join(work, "inputs"))
        entry = entry_mod.Entry(config, inputs, device, seed)
        out = entry.job(os.path.join(work, "job"))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = entry.reference()
        ctl = entry.control(ref, os.path.join(work, "control"), [out])
        return {"seed": seed,
                "program": {n: v for n, v, _ in entry.check([out], ref)},
                "control": {n: v for n, v, _ in entry.check(ctl, ref)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    parts = run.resolve(run.load_spec(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(parts, seed, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
