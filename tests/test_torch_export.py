"""The port's detection export (``export.py``) against the JAX package's on
the CPU: bridged TINY BCD weights (``from_jax_variables``), fp32, one
symbolic-batch artifact of each package, inputs seeded with numpy.

- The port's artifact against JAX's ``export_model`` artifact at batch 2
  and 5 within 3e-3 relative / 3e-4 absolute, the tolerance of the live
  models' parity tests (tests/test_torch_model.py: the fused block's plain
  version against XLA's convs, sums in another order).
- The port's artifact against the port's live forward within 1e-6.
- ``ArtifactPredictor`` against the live ``Predictor`` (masks equal) and
  JAX's ``ArtifactPredictor`` (the same tolerance; masks equal away from
  the threshold).
- The program calls ``c3d::depthwise_conv3d`` once for the stem's and each
  unfused block's depthwise conv; the one ``aten.conv3d`` is the stem's dense conv.
- ``fixed_batch``: None for a symbolic artifact, 4 for one pinned with
  ``batch=4``, which refuses another batch; ``input_shape`` read from the
  artifact; loaders without a card raise unless asked for the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.export import export_model as jax_export_model, load_exported as jax_load
from change3d_tpu.inference import ArtifactPredictor as JaxArtifactPredictor
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu_torch import export as ex
from change3d_tpu_torch.inference import ArtifactPredictor, Predictor, TiledPredictor
from change3d_tpu_torch.models.trainer import Change3D, Task

from tests.test_torch_model import ATOL, RTOL, _cfgs, _load, _random_vars

HW = 16


def _images(seed, b):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, HW, HW, 3).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def bcd():
    """(port model, its artifact's ArtifactPredictor, JAX artifact bytes)
    on one seeded tree; the artifact is loaded once."""
    jcfg, cfg = _cfgs(False)
    jmodel = JaxChange3D(task=JaxTask.BCD, in_height=HW, in_width=HW, backbone_cfg=jcfg)
    z = jnp.zeros((1, HW, HW, 3), jnp.float32)
    variables = _random_vars(jmodel, z, z, seed=31)
    _, cfg = _cfgs(True)
    model = _load(Change3D(Task.BCD, in_height=HW, in_width=HW, backbone_cfg=cfg, device="cpu"),
                  variables, cfg)
    blob = ex.export_model(model, compute_dtype=torch.float32)
    jblob = jax_export_model(jmodel, variables, compute_dtype=jnp.float32, platforms=("cpu",))
    return model, ArtifactPredictor(blob, device="cpu"), jblob


@pytest.mark.parametrize("batch", [2, 5])
def test_artifact_matches_jax_artifact_and_live_forward(bcd, batch):
    model, pred, jblob = bcd
    pre, post = _images(batch, batch)
    got = pred._fn(pre, post)
    want = jax_load(jblob)(pre, post)
    assert set(got) == set(want) == {"change"}
    assert got["change"].dtype == torch.float32 and got["change"].shape == (batch, HW, HW, 1)
    np.testing.assert_allclose(got["change"].numpy(), np.asarray(want["change"]), rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():
        live = model(torch.from_numpy(pre), torch.from_numpy(post))["change"]
    np.testing.assert_allclose(got["change"].numpy(), live.numpy(), rtol=0, atol=1e-6)


def test_artifact_predictor_matches_live_and_jax_predictors(bcd):
    model, pred, jblob = bcd
    assert (pred.model.in_height, pred.model.in_width, pred.fixed_batch) == (HW, HW, None)
    pre, post = _images(7, 3)
    probs = pred.predict_probs(pre, post)["change"]
    live = Predictor(model, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(probs, live.predict_probs(pre, post)["change"], rtol=0, atol=1e-6)
    assert np.array_equal(pred.predict(pre, post)["change"], live.predict(pre, post)["change"])
    jpred = JaxArtifactPredictor(jblob)
    jprobs = jpred.predict_probs(pre, post)["change"]
    np.testing.assert_allclose(probs, jprobs, rtol=RTOL, atol=ATOL)
    sure = np.abs(jprobs[..., 0] - 0.5) > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(pred.predict(pre, post)["change"][sure],
                                  jpred.predict(pre, post)["change"][sure])
    # TiledPredictor runs over an artifact as over a live Predictor.
    scene = np.random.RandomState(8).randn(2, 24, 20, 3).astype(np.float32)
    tiled = TiledPredictor(pred, overlap=4, batch_size=3).predict_scene(scene[0], scene[1])
    want = TiledPredictor(live, overlap=4, batch_size=3).predict_scene(scene[0], scene[1])
    assert tiled["change"].shape == (24, 20) and np.array_equal(tiled["change"], want["change"])


def test_artifact_calls_the_depthwise_op(bcd):
    model, pred, _ = bcd
    from change3d_tpu_torch.models.x3d import X3DResBlock

    unfused = [m for m in model.modules() if isinstance(m, X3DResBlock) and not m.fusable]
    assert unfused  # every stage's block 0 strides
    nodes = [n for n in pred._fn.program.graph.nodes if n.op == "call_function"]
    targets = [n.target for n in nodes]
    assert targets.count(torch.ops.c3d.depthwise_conv3d.default) == 1 + len(unfused)
    convs = [n for n in nodes if n.target == torch.ops.aten.conv3d.default]
    assert len(convs) == 1  # the stem's dense conv_s, groups 1
    assert len(convs[0].args) < 7 or convs[0].args[6] == 1


def test_pinned_batch_and_device(bcd, tmp_path):
    model, symbolic_pred, _ = bcd
    path = str(tmp_path / "bcd4.pt2")
    pinned = ex.export_model(model, path, compute_dtype=torch.float32, batch=4)
    with open(path, "rb") as f:
        assert f.read() == pinned
    pred = ArtifactPredictor(path, device="cpu")
    assert pred.fixed_batch == 4 and pred._fn.input_shape == (4, HW, HW, 3)
    symbolic = symbolic_pred._fn.input_shape
    assert symbolic[1:] == (HW, HW, 3) and not isinstance(symbolic[0], int)
    pre, post = _images(9, 4)
    live = Predictor(model, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(pred.predict_probs(pre, post)["change"],
                               live.predict_probs(pre, post)["change"], rtol=0, atol=1e-6)
    # A pinned artifact takes its batch only (the program's input guard).
    with pytest.raises((AssertionError, RuntimeError)):
        pred.predict(pre[:3], post[:3])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ArtifactPredictor(pinned)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ex.load_exported(path)
    assert model.training is False
