"""What the harness runs loads neither JAX nor the JAX package (top-level
names compared whole), and the plain references load nothing of the
program."""

import json
import subprocess
import sys

from benchmark import run

HARNESS = """
import json, sys
from benchmark import run, traffic, trace, card, work, control
spec = run.load_spec()
for w in spec["workloads"]:
    parts = run.resolve(spec, w["name"])
    run.load_file(parts["entry"], "entry_" + parts["config"]["entry"])
    for m in parts["per_layer"]:
        run.metric_reader(m["name"])
from mini_parallel_tpu_torch.models import alignment, variant_prep, wgs
from mini_parallel_tpu_torch.io import fasta, fastq
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
from benchmark.reference import sw_self, variant
print(json.dumps(sorted(sys.modules)))
"""


def modules(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    loaded = modules(HARNESS)
    assert "mini_parallel_tpu_torch" in loaded
    assert [m for m in loaded if m.split(".")[0] in run.FORBIDDEN] == []


def test_reference_loads_nothing_of_the_program():
    loaded = modules(REFERENCE)
    assert [m for m in loaded
            if m.split(".")[0] in (*run.FORBIDDEN, "mini_parallel_tpu_torch")
            ] == []


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mini_parallel_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    found = run.forbidden_modules()
    assert "jaxlib.xla" in found and "mini_parallel_tpu_torch_x" not in found
