"""The port's training pieces held against change3d_tpu on the same inputs:
train-mode BatchNorm, bce_dice_loss, the lr schedules and torch-Adam."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from change3d_tpu.ops.norm import BatchNorm as JaxBatchNorm
from change3d_tpu.train import losses as jlosses
from change3d_tpu.train import lr as jlr
from change3d_tpu.train.optim import torch_adam as jax_torch_adam
from change3d_tpu_torch.ops.norm import BatchNorm
from change3d_tpu_torch.train import losses, lr
from change3d_tpu_torch.train.optim import set_lr, torch_adam

BF16_ULP = 2.0 ** -7


def _bn_case(seed, dtype):
    rs = np.random.RandomState(seed)
    c = 6
    x = (0.5 + rs.randn(2, 3, 5, 4, c)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rs.randn(c)).astype(np.float32),
         "bias": (0.1 * rs.randn(c)).astype(np.float32)}
    s = {"mean": (0.1 * rs.randn(c)).astype(np.float32),
         "var": (1 + 0.5 * rs.rand(c)).astype(np.float32)}
    cot = rs.randn(*x.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)

    def f(xx):
        y, upd = JaxBatchNorm().apply({"params": p, "batch_stats": s}, xx,
                                      use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd["batch_stats"])

    (_, (want_y, want_s)), want_g = jax.value_and_grad(f, has_aux=True)(jx)

    bn = BatchNorm(c).train()
    with torch.no_grad():
        for k, v in {**p, **s}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = bn(tx)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    return (y, bn, tx.grad), (np.asarray(want_y.astype(jnp.float32)), want_s,
                              np.asarray(want_g.astype(jnp.float32)))


def test_train_batch_norm_fp32_matches_jax():
    (y, bn, g), (want_y, want_s, want_g) = _bn_case(0, torch.float32)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), want_s["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), want_s["var"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)


def test_train_batch_norm_bf16_input_matches_jax():
    (y, bn, _), (want_y, want_s, _) = _bn_case(1, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    got = y.detach().float().numpy()
    ulps = BF16_ULP * np.exp2(np.floor(np.log2(np.maximum(np.abs(want_y), 1.0))))
    assert np.all(np.abs(got - want_y) <= 2 * ulps)
    np.testing.assert_allclose(bn.mean.numpy(), want_s["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), want_s["var"], rtol=1e-6, atol=1e-6)


def test_batch_norm_running_stats_move_only_in_train_mode():
    bn = BatchNorm(4)
    x = torch.randn(3, 2, 2, 4, generator=torch.Generator().manual_seed(0)) + 1.0
    bn.eval()(x)
    assert torch.equal(bn.mean, torch.zeros(4)) and torch.equal(bn.var, torch.ones(4))
    bn.train()(x)
    n = x.numel() // 4
    want_mean = 0.1 * x.mean((0, 1, 2))
    want_var = 0.9 + 0.1 * x.var((0, 1, 2), unbiased=False) * n / (n - 1)
    torch.testing.assert_close(bn.mean, want_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.var, want_var, rtol=1e-5, atol=1e-6)
    assert not bn.mean.requires_grad and not bn.var.requires_grad


def test_bce_dice_loss_and_gradient_match_jax():
    rs = np.random.RandomState(2)
    probs = rs.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    probs[0, 0, :2, 0] = [0.0, 1.0]  # the clip at 1e-7
    label = (rs.rand(2, 8, 8, 1) > 0.6).astype(np.float32)
    want, want_g = jax.value_and_grad(jlosses.bce_dice_loss)(jnp.asarray(probs), jnp.asarray(label))
    tp = torch.from_numpy(probs).requires_grad_(True)
    got = losses.bce_dice_loss(tp, torch.from_numpy(label))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)


SPE, MAX_ITER = 250, 1000


@pytest.mark.parametrize("step", [0, 1, 199, 200, SPE - 1, SPE, MAX_ITER - 1])
def test_lr_schedules_match_jax(step):
    poly, jpoly = (m.poly_warmup_schedule(2e-4, MAX_ITER, SPE) for m in (lr, jlr))
    assert np.float32(poly(step)) == np.float32(jpoly(step))
    # Warmup that ends with epoch 0, before step 200.
    short, jshort = (m.poly_warmup_schedule(2e-4, MAX_ITER, 150) for m in (lr, jlr))
    assert np.float32(short(step)) == np.float32(jshort(step))
    st, jst = (m.step_schedule(2e-4, 100, 2) for m in (lr, jlr))
    assert np.float32(st(step)) == np.float32(jst(step))


def test_torch_adam_matches_jax_over_five_steps():
    rs = np.random.RandomState(3)
    shapes = [(4, 5), (7,), (2, 3, 3)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes] for _ in range(5)]
    schedule = lr.poly_warmup_schedule(1e-3, 20, 3)

    tx = jax_torch_adam(jlr.poly_warmup_schedule(1e-3, 20, 3), weight_decay=1e-4)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = torch_adam(tp, weight_decay=1e-4)
    for k, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        set_lr(opt, schedule(k))
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
