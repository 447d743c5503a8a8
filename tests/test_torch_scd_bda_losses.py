"""The port's SCD/BDA losses, loss-and-metric functions and scores held
against change3d_tpu on the same numpy-seeded inputs, on the CPU: losses
1e-5 relative, confusion matrices and pixel counts exact, scores 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.metrics import confusion as jconf
from change3d_tpu.train import engine as jengine
from change3d_tpu.train import losses as jlosses
from change3d_tpu_torch.metrics import confusion
from change3d_tpu_torch.train import engine, losses

B, H, W = 2, 8, 12


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", ["mixed", "no_valid_pixel", "all_valid"])
def test_cross_entropy_2d_matches_jax(case):
    rs = np.random.RandomState(0)
    logits = (2 * rs.randn(B, H, W, 6)).astype(np.float32)
    targets = {"mixed": rs.randint(0, 6, (B, H, W)), "no_valid_pixel": np.zeros((B, H, W), int),
               "all_valid": rs.randint(1, 6, (B, H, W))}[case].astype(np.int32)
    want = jlosses.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(targets), ignore_index=0)
    lt, tt = _t(logits, targets)
    lt.requires_grad_(True)
    got = losses.cross_entropy_2d(lt, tt, ignore_index=0)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    if case == "no_valid_pixel":
        assert float(got.detach()) == 0.0  # JAX's sum / max(count, 1), not nan
    got.backward()
    jgrad = jax.grad(lambda x: jlosses.cross_entropy_2d(x, jnp.asarray(targets), ignore_index=0))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    # The default ignore_index (-1) counts every pixel.
    np.testing.assert_allclose(
        float(losses.cross_entropy_2d(*_t(logits, targets))),
        float(jlosses.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-5)


@pytest.mark.parametrize("change_shape", ["BHW", "BHW1"])
def test_change_similarity_loss_matches_jax(change_shape):
    rs = np.random.RandomState(1)
    a, b = ((2 * rs.randn(B, H, W, 5)).astype(np.float32) for _ in range(2))
    change = (rs.rand(B, H, W) > 0.6).astype(np.int32)
    if change_shape == "BHW1":
        change = change[..., None]
    want = jlosses.change_similarity_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(change))
    got = losses.change_similarity_loss(*_t(a, b, change))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _outputs(task, rs):
    sig = lambda *s: (1 / (1 + np.exp(-2 * rs.randn(*s)))).astype(np.float32)
    if task == "scd":
        return {"pre": (2 * rs.randn(B, H, W, 6)).astype(np.float32),
                "post": (2 * rs.randn(B, H, W, 6)).astype(np.float32),
                "change": sig(B, H, W, 1)}
    return {"cls": (2 * rs.randn(B, H, W, 5)).astype(np.float32), "loc": sig(B, H, W, 1)}


def _labels(task, rs, changed=0.4):
    if task == "scd":
        return np.stack([rs.randint(0, 6, (B, H, W)), rs.randint(0, 6, (B, H, W)),
                         (rs.rand(B, H, W) < changed).astype(int)], -1).astype(np.int32)
    return np.stack([(rs.rand(B, H, W) < 0.5).astype(int), rs.randint(0, 5, (B, H, W))],
                    -1).astype(np.int32)


CASES = {"full": dict(), "padded": dict(valid=np.array([True, False])),
         "unchanged": dict(changed=0.0)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("task", ["scd", "bda"])
def test_loss_metrics_match_jax(task, case):
    """The task's loss 1e-5 relative, its matrices and counts exact; a
    padded sample leaves the matrices, and a batch with no changed pixel
    (SCD's CE sees no valid pixel) still gives JAX's finite loss."""
    rs = np.random.RandomState(2)
    outputs = _outputs(task, rs)
    opts = dict(CASES[case])
    batch = {"label": _labels(task, rs, opts.pop("changed", 0.4)), **opts}
    jfn = {"scd": jengine._scd_loss_metrics, "bda": jengine._bda_loss_metrics}[task]
    fn = {"scd": engine._scd_loss_metrics, "bda": engine._bda_loss_metrics}[task]
    jloss, jmetrics = jfn({k: jnp.asarray(v) for k, v in outputs.items()},
                          {k: jnp.asarray(v) for k, v in batch.items()}, False)
    loss, metrics = fn({k: torch.from_numpy(v) for k, v in outputs.items()},
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jmetrics[k]), err_msg=k)
    cm = metrics["cm" if task == "scd" else "loc_cm"]
    counted = H * W * (1 if case == "padded" else B) * (2 if task == "scd" else 1)
    assert float(cm.sum()) == counted


def _hist(rs, k, scale=50):
    return rs.randint(0, scale, (k, k)).astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scd_and_bda_scores_match_jax(seed):
    rs = np.random.RandomState(seed)
    hist = _hist(rs, 6)
    got, want = confusion.scd_scores(hist), jconf.scd_scores(hist)
    assert set(got) == set(want) == {"Fscd", "IoU_mean", "Sek"}
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    loc, cls = _hist(rs, 2, 500), _hist(rs, 5)
    got, want = confusion.bda_scores(loc, cls), jconf.bda_scores(loc, cls)
    assert set(got) == set(want) and len(got) == 3 + 4
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)


def test_scores_of_degenerate_matrices_match_jax():
    """No changed pixel anywhere, a class never predicted: the guards
    (kappa of an empty hist, max(., 1e-10), the harmonic floor) agree."""
    hist = np.zeros((6, 6))
    hist[0, 0] = 100.0
    assert confusion.scd_scores(hist) == pytest.approx(jconf.scd_scores(hist), nan_ok=True)
    loc = np.array([[10.0, 0.0], [0.0, 0.0]])
    cls = np.diag([5.0, 3.0, 0.0, 2.0, 1.0])
    assert confusion.bda_scores(loc, cls) == pytest.approx(jconf.bda_scores(loc, cls))
    assert confusion._cal_kappa(np.zeros((3, 3))) == 0.0


@pytest.mark.parametrize("task", ["scd", "bda"])
def test_meters_match_jax_over_device_tensors(task):
    rs = np.random.RandomState(3)
    meter = confusion.SCDMeter(6) if task == "scd" else confusion.BDAMeter(5)
    jmeter = jconf.SCDMeter(6) if task == "scd" else jconf.BDAMeter(5)
    for _ in range(3):
        if task == "scd":
            cm, correct, total = _hist(rs, 6), rs.randint(0, 100), 100 + rs.randint(0, 100)
            meter.update(torch.from_numpy(cm).float(), torch.tensor(correct), torch.tensor(total))
            jmeter.update(cm, correct, total)
        else:
            loc, cls = _hist(rs, 2), _hist(rs, 5)
            meter.update(torch.from_numpy(loc).float(), torch.from_numpy(cls).float())
            jmeter.update(loc, cls)
    assert meter.scores() == pytest.approx(jmeter.scores(), rel=1e-12)
