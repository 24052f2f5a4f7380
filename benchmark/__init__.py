"""The benchmark of mini_parallel_tpu_torch: one cell a run, driven by
``BENCHMARK.json`` and the data files under this folder.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the card it is started on (run.py).
A cell names a configuration (``configs/<config>.json``, whose ``entry``
names ``entries/<entry>.py``) and a traffic mix (``traffic/<mix>.json``,
read by the one generator in traffic.py); each per-layer metric is a
reader of its own, ``metrics/<metric>.py``. The plain references that
decide ``correct`` are under ``reference/`` and import nothing of the
program.
"""
