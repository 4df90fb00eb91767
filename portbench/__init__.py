"""Benchmark of ``data_compression_tpu_torch`` on an NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of the repository's ``BENCHMARK.json`` and prints one JSON
result line.  Everything that belongs to one configuration, traffic mix,
timed loop or metric lives in a file of its own that the harness finds by
name (``configs/``, ``workloads/``, ``drivers/``, ``metrics/``); the plain
reference that decides ``correct`` is ``reference/`` and imports nothing of
the program.  README.md says how to run a cell and how to add one.
"""
