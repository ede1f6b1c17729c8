"""The benchmark of the PyTorch and CUDA port (``threedhumangan_tpu_torch``).

``BENCHMARK.json`` at the repository root lists its cells; ``python3 -m
perfbench.run`` runs one (``run.py``).  Everything that measures lives here:
the harness (``harness.py``), the drivers that generate each traffic mix
(``drivers/``), the mixes (``traffic/``), the configurations (``configs/``),
the limits of each cell's comparison (``limits/``), one reader a metric
(``metrics/``), the trace reduction (``trace.py``), the operation and byte
counts and the card's peaks (``flops.py``) and the plain reference
(``reference/``).  ``calibrate.py`` reads what the limits are set from.
"""
