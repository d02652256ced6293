"""The port's benchmark: one run of one cell is ``python3 perfbench/run.py``
(see ``BENCHMARK.json`` at the root of the repository)."""
