"""The port's seeded SCD and BDA models against the JAX init, and their
device default (the card, or a raise without one)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig

from tests.test_torch_model import TINY, _cfgs
from tests.test_torch_scd_bda_model import CLASSES


@pytest.mark.parametrize("task", [Task.SCD, Task.BDA], ids=["scd", "bda"])
def test_seeded_init_follows_the_jax_distributions(task):
    """Every parameter of the JAX init, heads included, bridged onto the
    port's names with the same shape and distribution (the same constant,
    or a std within 20%)."""
    jcfg, cfg = _cfgs(False)
    jmodel = JaxChange3D(task=JaxTask(task.value), num_classes=CLASSES[task], in_height=16,
                         in_width=16, backbone_cfg=jcfg)
    z = jnp.zeros((1, 16, 16, 3), jnp.float32)
    want = from_jax_variables(jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), z, z)),
                              cfg)
    got = Change3D(task, num_classes=CLASSES[task], in_height=16, in_width=16, backbone_cfg=cfg,
                   device="cpu").state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if float(w.std()) == 0:
            assert torch.equal(g, w), k
        elif w.numel() >= 256:
            assert 0.8 < float(g.std() / w.std()) < 1.25, k


@pytest.mark.parametrize("task", [Task.SCD, Task.BDA], ids=["scd", "bda"])
def test_builds_on_the_card_by_default(task):
    kw = dict(num_classes=CLASSES[task], in_height=16, in_width=16,
              backbone_cfg=X3DConfig(**TINY))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Change3D(task, **kw)
    model = Change3D(task, device="cpu", **kw)
    assert model.encoder.perception_frames.device.type == "cpu"
