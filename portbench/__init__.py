"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its
harness, traffic, configurations, per-layer readers, plain references
and tests.  ``portbench/run.py`` runs one cell; ``BENCHMARK.json`` at the
root of the repository lists the cells."""
