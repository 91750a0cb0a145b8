"""The benchmark of the PyTorch port's ESD training step.

``python3 esdbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on a CUDA card
and prints one JSON line.  Configurations (``configs/``), traffic mixes
(``mixes/``) and per-layer metric readers (``metrics/``) are found by
the names ``BENCHMARK.json`` gives them.
"""
