"""The port's BCD train and eval steps held against change3d_tpu's
make_train_step / make_eval_step on the bridged TINY Change3D, in fp32 on
the CPU: the same weights, batch and schedule (constant lr 1e-3, coupled
decay 1e-4).

Adam's first update is about lr * sign(g), so an element whose gradient is
near zero can move by 2 * lr on a sign flip between two correct
implementations; the parameter check leaves out the elements whose first JAX
gradient is nonzero but below 1e-6 of its tensor's largest, and asserts that
they are fewer than 0.1% of all (on this seed there are none)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.models.x3d import X3DConfig as JaxX3DConfig
from change3d_tpu.train.engine import (
    TrainState,
    _bcd_loss_metrics,
    _forward,
    make_eval_step,
    make_train_step,
)
from change3d_tpu.train.optim import torch_adam as jax_torch_adam
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.ops import fused_block as fb
from change3d_tpu_torch.train.engine import eval_step, train_step
from change3d_tpu_torch.train.optim import torch_adam

from tests.test_torch_model import TINY, _random_vars

HW, B, LR, WD = 32, 2, 1e-3, 1e-4
STEPS = 3


def _batch(seed):
    rs = np.random.RandomState(seed)
    pre, post = (rs.randn(B, HW, HW, 3).astype(np.float32) for _ in range(2))
    label = (rs.rand(B, HW, HW, 1) > 0.7).astype(np.int32)
    return {"pre": pre, "post": post, "label": label}


@pytest.fixture(scope="module")
def run():
    """JAX and the port, side by side: the first step's gradients and
    stats, then the state after STEPS steps on one batch."""
    cfg = X3DConfig(**TINY)
    jmodel = JaxChange3D(task=JaxTask.BCD, in_height=HW, in_width=HW,
                         backbone_cfg=JaxX3DConfig(**TINY))
    z = jnp.zeros((1, HW, HW, 3), jnp.float32)
    variables = jax.device_get(_random_vars(jmodel, z, z, seed=5))
    batch = _batch(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, _ = _forward(jmodel, {"params": params, "batch_stats": variables["batch_stats"]},
                          jbatch, train=True, mutable=True)
        return _bcd_loss_metrics(out, jbatch, True)[0]

    jgrads = jax.jit(jax.grad(loss_fn))(variables["params"])
    tx = jax_torch_adam(lambda _: LR, weight_decay=WD)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    jstep = make_train_step(jmodel, tx, donate=False)
    jstates, jmetrics = [], []
    for _ in range(STEPS):
        state, m = jstep(state, jbatch, jax.random.PRNGKey(0))
        jstates.append(jax.device_get(state.variables))
        jmetrics.append(jax.device_get(m))

    model = Change3D(Task.BCD, in_height=HW, in_width=HW, backbone_cfg=cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    opt = torch_adam(model.parameters(), weight_decay=WD)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics, grads, stats = [], None, None
    for k in range(STEPS):
        metrics.append(train_step(model, opt, lambda _: LR, tbatch, k))
        if k == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            stats = {n: b.clone() for n, b in model.named_buffers()}
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, jgrads=jgrads, jstates=jstates,
                jmetrics=jmetrics, model=model, metrics=metrics, grads=grads, stats=stats)


def test_train_step_loss_matches_jax(run):
    for got, want in zip(run["metrics"], run["jmetrics"]):
        assert got["loss"].dtype == torch.float32 and got["loss"].dim() == 0
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    # The steps learn something: the loss on the fixed batch falls.
    assert float(run["metrics"][-1]["loss"]) < float(run["metrics"][0]["loss"])


def test_train_step_gradients_match_jax(run):
    want = from_jax_variables({"params": jax.device_get(run["jgrads"])}, run["cfg"])
    assert set(want) == set(run["grads"])
    assert "encoder.perception_frames" in want
    for name, g in run["grads"].items():
        w = want[name].numpy()
        atol = 3e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=3e-3, atol=atol, err_msg=name)


def test_train_step_batch_norm_stats_match_jax(run):
    # The running stats after the first step.
    jvars = {"batch_stats": run["jstates"][0]["batch_stats"]}
    want = from_jax_variables(jvars, run["cfg"])
    assert set(want) == set(run["stats"]) and len(want) > 0
    for name, got in run["stats"].items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_parameters_after_three_steps_match_jax(run):
    want = from_jax_variables(run["jstates"][-1], run["cfg"])
    g0 = from_jax_variables({"params": jax.device_get(run["jgrads"])}, run["cfg"])
    got = run["model"].state_dict()
    unstable = total = 0
    for name, w in want.items():
        w, p = w.numpy(), got[name].numpy()
        keep = np.ones(w.shape, bool)
        if name in g0:
            g = np.abs(g0[name].numpy())
            # Exact zeros (dead ReLU units) stay in: their update is the
            # decay alone, with no sign to flip.
            keep = (g >= 1e-6 * g.max()) | (g == 0)
            unstable += int((~keep).sum())
            total += keep.size
        np.testing.assert_allclose(p[keep], w[keep], rtol=0, atol=1e-2 * LR, err_msg=name)
    print(f"sign-unstable elements left out: {unstable} of {total}")
    assert unstable < 1e-3 * total


def test_eval_step_with_padded_batch_matches_jax(run):
    """Eval through the fused-block path (its plain version on the CPU)
    against JAX's plain eval; the second sample is padding."""
    cfg = run["cfg"]
    model = Change3D(Task.BCD, in_height=HW, in_width=HW, backbone_cfg=cfg, device="cpu")
    model.load_state_dict(from_jax_variables(run["variables"], cfg))
    batch = dict(_batch(7), valid=np.array([True, False]))
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=run["variables"]["params"],
                        batch_stats=run["variables"]["batch_stats"], opt_state=None)
    want = jax.device_get(make_eval_step(run["jmodel"])(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    probs = np.asarray(run["jmodel"].apply(run["variables"], jnp.asarray(batch["pre"]),
                                           jnp.asarray(batch["post"]))["change"])
    assert np.abs(probs - 0.5).min() > 1e-4  # no pixel on the threshold: the CM is exact
    before = fb.fused_block_fwd.launches
    got = eval_step(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert fb.fused_block_fwd.launches == before  # CPU tensors take the plain version
    assert not model.training
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    assert float(got["cm"].sum()) == HW * HW  # the padded sample is masked out
