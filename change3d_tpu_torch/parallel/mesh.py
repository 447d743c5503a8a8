"""Device counts for data parallelism (counterpart of
``change3d_tpu/parallel/mesh.py``).

The JAX package lays one ``data`` mesh axis over every chip; the port runs
one process per card (``parallel/distributed.py``), so a run's data-parallel
width is its world size, and a ``--shard`` predictor's is the number of
local cards.
"""

from __future__ import annotations

import torch


def local_device_count() -> int:
    """CUDA cards this process sees (0 without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def multiple_of_devices(batch_size: int, n: int) -> int:
    """``batch_size`` rounded up to a multiple of ``n``."""
    return -(-batch_size // n) * n
