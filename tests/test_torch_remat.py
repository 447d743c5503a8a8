"""``X3DConfig.remat`` (block pairs recomputed in the backward,
``torch.utils.checkpoint``) on the CPU: one fp32 train step of the TINY
models with remat equals the step without (loss and count metrics equal,
gradients within 1e-5 relative in the 2-norm, the BN running statistics
within 1e-6, i.e. moved once though the paired blocks run their forward
twice); and in 2 gloo processes, where the recompute repeats BN's
global-batch all-reduces, each process's remat step equals its step
without and both processes hold bit-equal state
(``tests/_torch_parallel.py``)."""

import os

import pytest
import torch

from change3d_tpu_torch.models import x3d

from tests import _torch_parallel as tp
from tests import _torch_parallel_checks as checks
from tests._torch_parallel import few_threads  # noqa: F401 (autouse)


def _check_equal(got, want):
    checks.check_loss_and_metrics(got, want)
    checks.check_gradients(got, want)
    checks.check_state_after_step(got, want)


@pytest.mark.parametrize("task", ["bcd", "cc"])
def test_one_step_with_remat_equals_one_without(task, monkeypatch):
    runs = {}
    counts = {}
    forward = x3d.X3DResBlock.forward

    def counted(self, x):
        counts[id(self)] = counts.get(id(self), 0) + 1
        return forward(self, x)

    monkeypatch.setattr(x3d.X3DResBlock, "forward", counted)
    for remat in (False, True):
        counts.clear()
        runs[remat] = tp.one_step(task, remat=remat)
        runs[remat]["forwards"] = sorted(counts.values())
    _check_equal(runs[True], runs[False])
    # TINY: depths (2, 3, 3[, 3]); one pair in each stage of depth 3 runs twice.
    pairs = 2 + (task == "cc")
    assert runs[False]["forwards"] == [1] * len(runs[False]["forwards"])
    assert runs[True]["forwards"].count(2) == 2 * pairs


def test_two_process_remat_step_equals_the_step_without(tmp_path):
    out = str(tmp_path)
    tp.run_ok(tp.step_worker, 2, ("bcd",), out, None, (False, True), timeout=120)
    ranks = [{remat: torch.load(os.path.join(out, f"bcd-2-{r}{'-remat' * remat}.pt"))
              for remat in (False, True)} for r in range(2)]
    for rank in ranks:
        _check_equal(rank[True], rank[False])
    checks.check_bit_equal_across_processes([rank[True] for rank in ranks])
