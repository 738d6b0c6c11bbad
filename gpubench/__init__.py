"""The benchmark of ``tpudash_torch`` on NVIDIA H100s: one cell of
``BENCHMARK.json`` a run (``python3 gpubench/run.py --workload NAME ...``).
See ``README.md``."""
