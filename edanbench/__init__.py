"""The benchmark of the EDAN engine's PyTorch and CUDA port
(``repro_torch``): ``run.py`` runs one cell of ``BENCHMARK.json``."""
