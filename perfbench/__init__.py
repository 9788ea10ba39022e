"""The benchmark of the PyTorch/CUDA port (``bndm_tpu_torch``): one cell a
run, cells, configurations, traffic and per-layer metrics found by name
from ``BENCHMARK.json``. ``python3 perfbench/run.py --help``."""
