"""The benchmark of ``repro_torch``, driven by ``BENCHMARK.json``: one
command (``python3 bench/run.py``) runs one cell once."""
