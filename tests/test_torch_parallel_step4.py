"""The port's BCD train step in 4 gloo processes (one sample each) equals
the one-process step on the same global batch of 4, under the checks of
``tests/_torch_parallel_checks.py`` (``tests/test_torch_parallel_step.py``
holds 2 processes for every task). The one-process reference runs spawned
as well (``tests/_torch_parallel.reference_worker``)."""

import os

import pytest
import torch

from tests import _torch_parallel as tp
from tests._torch_parallel import few_threads  # noqa: F401 (autouse)
from tests import _torch_parallel_checks as checks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("steps4"))
    procs = tp.start_ranks(tp.step_worker, 4, ("bcd",), out)
    procs += tp.start_ranks(tp.reference_worker, 1, ("bcd",), out)
    tp.join_ok(procs, timeout=120)
    one = torch.load(os.path.join(out, "bcd-1-0.pt"))
    return one, [torch.load(os.path.join(out, f"bcd-4-{r}.pt")) for r in range(4)]


def test_loss_and_metrics_equal_one_process(runs):
    checks.check_loss_and_metrics(runs[1][0], runs[0])


def test_gradients_equal_one_process(runs):
    checks.check_gradients(runs[1][0], runs[0])


def test_state_after_the_step_equals_one_process(runs):
    checks.check_state_after_step(runs[1][0], runs[0])


def test_all_processes_hold_bit_equal_state(runs):
    checks.check_bit_equal_across_processes(runs[1])
