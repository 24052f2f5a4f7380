"""The port's measurement harness: one module for each of the JAX
package's root bench scripts, each run as
``python -m mini_parallel_tpu_torch.bench.<name>``.

- ``headline``: ``bench.py``, batched SW on BASELINE config 2 (GCUPS).
- ``workloads``: ``bench_workloads.py``, one reads/s row per engine.
- ``scaling``: ``bench_scaling.py``, the sharded WGS step at 1-8 shards
  and the long pair's row-band geometry.
- ``multiprocess``: ``bench_multiprocess.py``, ``--full-wgs`` in 1, 2 and
  4 processes over gloo.

Each prints JSON lines carrying the card's name and power limit and a
``correct`` flag, runs on the card unless given the CPU, and exits 1 when
a check fails (``_common.py``).
"""
