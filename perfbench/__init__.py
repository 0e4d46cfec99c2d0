"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell is made of is found by name: its
configuration under ``configs/``, its traffic mix under ``traffic/``,
each per-layer metric's reader under ``metrics/``, and the plain
reference a configuration names under ``reference/``. The general code
(traffic drivers, work counts, the table of peaks, the trace reader and
the comparison that decides ``correct``) is under ``lib/``.
"""
