"""The benchmark of `normalizingflows_torch`, the PyTorch and CUDA port.

`run.py` runs one cell of `BENCHMARK.json` on one card. Everything the
yardstick needs lives here: the traffic generators (`drivers/`), the
configurations and mixes as data (`configs/`, `traffic/`, `limits/`), the
plain reference (`reference/`), the peaks, the work counts, the trace
reader and one reader per per-layer metric (`metrics/`). Only
`systems/` and the drivers import the program.
"""
