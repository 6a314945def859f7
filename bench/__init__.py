"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
harness, its data (configurations, traffic mixes, cells), the metric
readers, the plain reference and the yardstick's arithmetic.  Run a cell
with ``python3 bench/run.py``."""
