#!/usr/bin/env python3
"""Run one cell of the benchmark of change3d_tpu_torch once, on the CUDA
devices of this machine, and print its result as the last line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the checkout's root and found by name under
``benchmark/``. Exits non-zero and prints no result without enough CUDA
devices or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.benchlib.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
