"""Shared helpers of the benchmark's CPU tests: cells of the manifest cut to
a size the CPU holds (widths as configured, fewer blocks, small images and
batches)."""

import pytest
import torch

from benchmark.benchlib.manifest import Cell


def small_cell(name: str, size: int = 32, **traffic) -> Cell:
    cell = Cell(name)
    cell.config.update(image_size=size, stage_depths=[2, 2, 3, 2])
    for key, value in {"batch": 4, "pool": 8, "batches": 2}.items():
        if key in cell.traffic:
            cell.traffic[key] = value
    if cell.traffic["driver"] == "open_serve":
        cell.traffic.update(rate_per_s=20, kept=8, senders=4)
    cell.traffic.update(traffic)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """Skips a test marked ``cuda`` where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
