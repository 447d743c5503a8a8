"""The checks of ``tests/test_torch_parallel_step*.py``: a data-parallel
train step (``tests/_torch_parallel.one_step`` in N processes) against the
one-process step on the same global batch.

- the loss within 1e-6 relative, the count metrics equal;
- the whole gradient within 1e-5 relative in the 2-norm, and each of Adam's
  moments likewise (they are the decayed gradient and its square);
- the BN running statistics within 1e-6;
- the parameters within 1e-6 where Adam's first update is well
  conditioned: that update is lr * m / (|m| + eps) of the decayed gradient
  m = g + wd * p, whose relative slope eps / (|m| + eps) reaches 1 as m
  goes to 0, so an element whose m is rounding noise (an attention key
  bias, a gradient that the decay cancels) moves by up to lr on either
  side. An element is held where the one-process |m| is at least 100 eps
  (the slope under 1%) or where the two runs' m agree within 0.1% (the
  update then moves less than 1e-3 * lr); the others are left out, and
  must be under 1% of all;
- every process's parameters, buffers and Adam state bit-equal to process
  0's."""

import math

import numpy as np
import torch

B1, EPS = 0.9, 1e-8  # the optimizer's (train/optim.torch_adam)


def _rel_2norm(got, want):
    diff = math.sqrt(sum(float((got[k] - w).double().norm()) ** 2 for k, w in want.items()))
    norm = math.sqrt(sum(float(w.double().norm()) ** 2 for w in want.values()))
    return diff / norm


def check_loss_and_metrics(got, want):
    assert set(got["metrics"]) == set(want["metrics"])
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(want["metrics"]["loss"]),
                               rtol=1e-6)
    for key in set(want["metrics"]) - {"loss"}:
        np.testing.assert_array_equal(got["metrics"][key].numpy(), want["metrics"][key].numpy(),
                                      err_msg=key)


def check_gradients(got, want):
    assert set(got["grads"]) == set(want["grads"])
    assert _rel_2norm(got["grads"], want["grads"]) <= 1e-5


def check_state_after_step(got, want):
    for name, w in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][name].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for key in ("exp_avg", "exp_avg_sq"):
        moments = lambda run: {i: st[key] for i, st in run["adam"].items()}
        assert _rel_2norm(moments(got), moments(want)) <= 1e-5, key
    unstable = total = 0
    for i, (name, w) in enumerate(want["params"].items()):
        m = want["adam"][i]["exp_avg"] / (1 - B1)
        m_got = got["adam"][i]["exp_avg"] / (1 - B1)
        keep = (m.abs() >= 100 * EPS) | ((m_got - m).abs() <= 1e-3 * m.abs())
        unstable += int((~keep).sum())
        total += keep.numel()
        np.testing.assert_allclose(got["params"][name][keep].numpy(), w[keep].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert unstable < 1e-2 * total, (unstable, total)


def check_bit_equal_across_processes(ranks):
    first = ranks[0]
    for other in ranks[1:]:
        for part in ("params", "buffers"):
            for name, t in first[part].items():
                assert torch.equal(other[part][name], t), (part, name)
        for i, state in first["adam"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(other["adam"][i][key], state[key]), (i, key)
        assert torch.equal(other["metrics"]["loss"], first["metrics"]["loss"])
