"""SCD and BDA artifacts of the port (``export.py``) against the JAX
package's ``export_model`` artifacts on the CPU: bridged TINY weights,
fp32, one symbolic-batch artifact per task and package, run at batch 2 and
5. Every head within 3e-3 relative / 3e-4 absolute of JAX's (the live
models' parity tolerance, tests/test_torch_scd_bda_model.py) and within
1e-6 of the port's live forward; class maps come out as fp32 logits, as
JAX's do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.export import export_model as jax_export_model, load_exported as jax_load
from change3d_tpu_torch import export as ex
from change3d_tpu_torch.models.trainer import Task

from tests.test_torch_model import ATOL, RTOL
from tests.test_torch_scd_bda_model import CLASSES, HEADS, HW, _pair


@pytest.fixture(scope="module", params=[Task.SCD, Task.BDA], ids=["scd", "bda"])
def artifacts(request):
    task = request.param
    jmodel, variables, model = _pair(task, fused=True, seed=5)
    fn = ex.load_exported(ex.export_model(model, compute_dtype=torch.float32), device="cpu")
    jfn = jax_load(jax_export_model(jmodel, variables, compute_dtype=jnp.float32,
                                    platforms=("cpu",)))
    return task, model, fn, jfn


@pytest.mark.parametrize("batch", [2, 5])
def test_artifact_matches_jax_artifact_and_live_forward(artifacts, batch):
    task, model, fn, jfn = artifacts
    rs = np.random.RandomState(batch)
    pre, post = (rs.randn(batch, HW, HW, 3).astype(np.float32) for _ in range(2))
    got, want = fn(pre, post), jfn(pre, post)
    assert set(got) == set(want) == set(HEADS[task])
    with torch.no_grad():
        live = model(torch.from_numpy(pre), torch.from_numpy(post))
    for key, width in HEADS[task].items():
        assert got[key].dtype == torch.float32 and got[key].shape == (batch, HW, HW, width)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{task.value} {key}")
        np.testing.assert_allclose(got[key].numpy(), live[key].numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"{task.value} {key} live")
    assert CLASSES[task] in {w for w in HEADS[task].values()}
