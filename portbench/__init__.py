"""The port's benchmark: cells of ``BENCHMARK.json`` driven by data (see
``portbench/run.py``)."""
