"""The port's data-parallel train step in 2 gloo processes equals the
one-process step on the same global batch, for BCD, SCD, BDA and CC (dropout
on): each process takes its contiguous slice of a seeded global batch of 4
(``tests/_torch_parallel.one_step``: the TINY models, fp32, constant lr
1e-3, coupled decay 1e-4), under the checks of
``tests/_torch_parallel_checks.py``. The one-process reference runs in a
spawned process too (``tests/_torch_parallel.reference_worker``).

The BCD step starts from a seeded JAX variables tree, bridged, and is also
held against change3d_tpu's ``make_train_step`` on the whole global batch at
the tolerances of ``tests/test_torch_train_step.py``: the loss 1e-5
relative, the confusion matrix equal, the BN running statistics 1e-5, and
the parameters within 1e-2 * lr where Adam's first step is stable (the
elements whose gradient is nonzero and under 1e-6 of its tensor's largest
left out, under 0.1% of all)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.models.x3d import X3DConfig as JaxX3DConfig
from change3d_tpu.train.engine import TrainState, make_train_step
from change3d_tpu.train.optim import torch_adam as jax_torch_adam
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.models.x3d import X3DConfig

from tests import _torch_parallel as tp
from tests._torch_parallel import few_threads  # noqa: F401 (autouse)
from tests import _torch_parallel_checks as checks
from tests.test_torch_model import _random_vars

TASKS = ("bcd", "scd", "bda", "cc")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("steps"))
    jmodel = JaxChange3D(task=JaxTask.BCD, in_height=tp.HW, in_width=tp.HW,
                         backbone_cfg=JaxX3DConfig(**tp.TINY))
    z = jnp.zeros((1, tp.HW, tp.HW, 3), jnp.float32)
    variables = jax.device_get(_random_vars(jmodel, z, z, seed=5))
    paths = {"bcd": os.path.join(out, "bcd-init.pt")}
    torch.save(from_jax_variables(variables, X3DConfig(**tp.TINY)), paths["bcd"])
    procs = tp.start_ranks(tp.step_worker, 2, TASKS, out, paths)
    procs += tp.start_ranks(tp.reference_worker, 1, TASKS, out, paths)
    # The JAX reference runs here while the processes step.
    tx = jax_torch_adam(lambda _: tp.LR, weight_decay=tp.WD)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    batch = {k: jnp.asarray(v) for k, v in tp.global_batch("bcd").items()}
    state, metrics = make_train_step(jmodel, tx, donate=False)(state, batch,
                                                                 jax.random.PRNGKey(0))
    jax_run = {"variables": jax.device_get(state.variables), "metrics": jax.device_get(metrics)}
    tp.join_ok(procs, timeout=120)
    one = {task: torch.load(os.path.join(out, f"{task}-1-0.pt")) for task in TASKS}
    ranks = {task: [torch.load(os.path.join(out, f"{task}-2-{r}.pt")) for r in range(2)]
             for task in TASKS}
    return one, ranks, jax_run


@pytest.mark.parametrize("task", TASKS)
def test_loss_and_metrics_equal_one_process(runs, task):
    checks.check_loss_and_metrics(runs[1][task][0], runs[0][task])


@pytest.mark.parametrize("task", TASKS)
def test_gradients_equal_one_process(runs, task):
    checks.check_gradients(runs[1][task][0], runs[0][task])


@pytest.mark.parametrize("task", TASKS)
def test_state_after_the_step_equals_one_process(runs, task):
    checks.check_state_after_step(runs[1][task][0], runs[0][task])


@pytest.mark.parametrize("task", TASKS)
def test_both_processes_hold_bit_equal_state(runs, task):
    checks.check_bit_equal_across_processes(runs[1][task])


def test_bcd_loss_and_confusion_matrix_match_jax(runs):
    got, want = runs[1]["bcd"][0]["metrics"], runs[2]["metrics"]
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))


def test_bcd_batch_norm_stats_match_jax(runs):
    want = from_jax_variables({"batch_stats": runs[2]["variables"]["batch_stats"]},
                              X3DConfig(**tp.TINY))
    got = runs[1]["bcd"][0]["buffers"]
    assert len(want) > 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_bcd_parameters_after_the_step_match_jax(runs):
    want = from_jax_variables(runs[2]["variables"], X3DConfig(**tp.TINY))
    got = runs[1]["bcd"][0]
    unstable = total = 0
    for name, p in got["params"].items():
        g = got["grads"][name].abs()
        keep = (g >= 1e-6 * g.max()) | (g == 0)
        unstable += int((~keep).sum())
        total += keep.numel()
        np.testing.assert_allclose(p[keep].numpy(), want[name][keep].numpy(), rtol=0,
                                   atol=1e-2 * tp.LR, err_msg=name)
    assert unstable < 1e-3 * total
