"""One fp32 CC train step of change3d_tpu_torch held against change3d_tpu's
make_train_step on the bridged TINY CC model (32², B = 2, dropout off on
both sides, constant lr 1e-3, coupled decay 1e-5, gradient values clipped
at CLIP, small enough that the clip bites): loss 1e-5 relative, top1
exact, BN running stats 1e-5, each gradient tensor within 1e-2 relative in
the 2-norm, and the parameters after the step within 1e-2 * lr where Adam's
first step is stable (the elements whose clipped, decayed gradients differ
by more than 1% between the packages, or are below 1e-6 of their tensor's
largest, are left out and must be under 1%). The optimizer comes from the
loop's ``_make_optimizer``: one learning rate, a separate encoder rate
(``per_subtree_lr``), or a frozen encoder (``freeze_subtree``).

JAX's position-encoding dropout is fixed at 0.1 whatever ``dropout`` is;
its flax Dropout is replaced by the identity for the JAX step here, and the
port's ``pe_dropout`` set to 0."""

import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.train import engine as jengine
from change3d_tpu.train.engine import TrainState, make_train_step
from change3d_tpu.train.optim import (
    freeze_subtree as jax_freeze_subtree,
    per_subtree_lr as jax_per_subtree_lr,
    torch_adam as jax_torch_adam,
)
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.train.caption_loop import CaptionRunConfig, _make_optimizer
from change3d_tpu_torch.train import engine
from change3d_tpu_torch.train.engine import train_step

from tests.test_torch_cc_model import captions, cc_pair, images

HW, B, LR, ENC_LR, WD, CLIP = 32, 2, 1e-3, 3e-4, 1e-5, 0.02
MODES = {"one_lr": dict(), "encoder_lr": dict(encoder_lr=ENC_LR),
         "frozen": dict(fine_tune_encoder=False)}


def _batch():
    pre, post = images(11)
    caps = captions(12, b=B, length=12)
    caps[1, 3] = 0  # a padding target inside the length: the loss skips it, top1 counts it
    lengths = np.asarray([int((c != 0).sum()) + (1 if i == 1 else 0) for i, c in enumerate(caps)],
                         np.int32)
    return {"pre": pre, "post": post, "caption": caps, "length": lengths}


def _jax_tx(mode):
    tx = jax_torch_adam(lambda _: LR, weight_decay=WD, grad_clip_value=CLIP)
    if mode == "encoder_lr":
        enc = jax_torch_adam(lambda _: ENC_LR, weight_decay=WD, grad_clip_value=CLIP)
        tx = jax_per_subtree_lr(enc, tx)
    if mode == "frozen":
        tx = jax_freeze_subtree(tx, "encoder")
    return tx


def make_run(mode):
    jmodel, variables, model = cc_pair(False, seed=9)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = _jax_tx(mode)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jstate, jmetrics = jax.device_get(make_train_step(jmodel, tx, donate=False)(
            state, jbatch, jax.random.PRNGKey(0)))

        def loss(p):
            out, _ = jengine._forward(jmodel, {"params": p, "batch_stats": variables[
                "batch_stats"]}, jbatch, train=True, mutable=True,
                rngs={"dropout": jax.random.PRNGKey(1)})
            return jengine._cc_loss_metrics(out, jbatch, True)[0]

        jgrads = jax.device_get(jax.jit(jax.grad(loss))(variables["params"]))

    model.decoder.pe_dropout = 0.0
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # The raw gradients, from a copy: the optimizer clips .grad in place.
    probe = copy.deepcopy(model).train()
    engine._cc_loss_metrics(engine._forward(probe, tbatch, None), tbatch)[0].backward()
    cfg = CaptionRunConfig(lr=LR, weight_decay=WD, grad_clip=CLIP, device="cpu", **MODES[mode])
    opt, schedule = _make_optimizer(cfg, model, steps_per_epoch=100)
    metrics = train_step(model, opt, schedule, tbatch, 0,
                         generator=torch.Generator().manual_seed(0))
    return dict(mode=mode, cfg=model.backbone_cfg, jstate=jstate, jmetrics=jmetrics,
                jgrads=jgrads, model=model, metrics=metrics, start=start,
                grads={n: p.grad.clone() for n, p in probe.named_parameters()},
                stepped={n for n, p in model.named_parameters() if p.grad is not None})


@pytest.fixture(scope="module")
def run():
    """One learning rate (the other modes: tests/test_torch_cc_step_groups.py)."""
    return make_run("one_lr")


def test_cc_step_loss_and_top1_match_jax(run):
    got, want = run["metrics"], run["jmetrics"]
    assert set(got) == set(want) == {"loss", "top1"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert float(got["top1"]) == pytest.approx(float(want["top1"]), rel=1e-6)


def test_cc_step_gradients_match_jax(run):
    want = from_jax_variables({"params": run["jgrads"]}, run["cfg"])
    assert set(want) == set(run["grads"])
    frozen = run["mode"] == "frozen"  # then no gradient flows into the encoder in the step
    assert run["stepped"] == {k for k in want if not (frozen and k.startswith("encoder."))}
    clipped = 0
    for name, g in run["grads"].items():
        w = want[name]
        rel = float((g - w).norm() / w.norm()) if float(w.norm()) > 0 else float(g.norm())
        assert rel <= 1e-2, (name, rel)
        clipped += int((w.abs() > CLIP).sum())
    assert clipped > 0  # the clip bites


def test_cc_step_state_matches_jax(run):
    want = from_jax_variables(run["jstate"].variables, run["cfg"])
    g_jax = from_jax_variables({"params": run["jgrads"]}, run["cfg"])
    got = run["model"].state_dict()
    unstable = total = 0
    for name, w in want.items():
        w, p = w.numpy(), got[name].numpy()
        if name not in g_jax:  # a BN running statistic: updated even when frozen
            np.testing.assert_allclose(p, w, rtol=1e-5, atol=1e-5, err_msg=name)
            continue
        if run["mode"] == "frozen" and name.startswith("encoder."):
            assert np.array_equal(p, run["start"][name].numpy()) and np.array_equal(p, w), name
            continue
        lr = ENC_LR if run["mode"] == "encoder_lr" and name.startswith("encoder.") else LR
        decay = WD * run["start"][name].numpy()
        g = np.clip(g_jax[name].numpy(), -CLIP, CLIP) + decay
        g_port = np.clip(run["grads"][name].numpy(), -CLIP, CLIP) + decay
        keep = (np.abs(g) >= 1e-6 * np.abs(g).max()) & (np.abs(g_port - g) <= 1e-2 * np.abs(g))
        unstable += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(p[keep], w[keep], rtol=0, atol=1e-2 * lr, err_msg=name)
        moved = np.abs(p - run["start"][name].numpy()).max()
        assert moved == pytest.approx(lr, rel=1e-2) or moved < lr, name
    assert unstable < 1e-2 * total
