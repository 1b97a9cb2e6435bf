"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a harness
driven by ``BENCHMARK.json``, its configurations, traffic mixes, per-layer
metric readers, frozen counts and the plain reference that decides
``correct``. ``python3 bench/run.py --help`` runs one cell."""
