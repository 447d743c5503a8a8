"""The port's int8 Change3D (``X3DConfig.quantized_eval``) against the JAX
package's on bridged weights and the same seeded inputs, fp32, on the CPU.

- BCD, SCD and BDA, dynamic and static: every head's output within 1e-4 of
  its largest, 2 x 8 int8 products per TINY forward. Measured: 1e-7 to
  2.3e-6 against the jitted JAX forward, up to 1.0e-5 against the eager
  one. The fp32 activations that feed a quantiser differ by a few ulps
  between the packages (another summation order), and a value that lands
  on a rounding boundary moves its int8 code by one step in one package
  only;
- the static ranges that ``calibrate_quant_scales`` records equal JAX's
  'quant' collection (through ``from_jax_variables``) within 1e-6
  relative;
- structure: the state_dict keys are those of the unquantised model (a
  saved run loads unchanged), training ignores ``quantized_eval``, no block
  takes the fused route, the int8 weights are quantised once and again
  after the weights change, and a Predictor refuses a static model without
  ranges (CC's int8 tokens: ``tests/test_torch_quant_cli.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.inference import calibrate_quant_scales as jax_calibrate
from change3d_tpu.models.trainer import Change3D as JaxChange3D, Task as JaxTask
from change3d_tpu.models.x3d import X3DConfig as JaxX3DConfig
from change3d_tpu_torch.checkpoint.convert import from_jax_variables
from change3d_tpu_torch.inference import (
    Predictor,
    calibrate_quant_scales,
    quant_scales,
    set_quant_scales,
)
from change3d_tpu_torch.models import x3d
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.ops import quant

from tests._torch_parallel import few_threads  # noqa: F401 (autouse)
from tests.test_torch_model import TINY, _random_vars

HW = 32
CLASSES = {"bcd": 1, "scd": 6, "bda": 5}
REL = 1e-4


def _inputs(seed, b=2):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, HW, HW, 3).astype(np.float32) for _ in range(2))


def _port(task, mode, **cfg):
    return Change3D(Task(task), num_classes=CLASSES[task], in_height=HW, in_width=HW,
                    backbone_cfg=X3DConfig(**TINY, quantized_eval=mode is not None,
                                           quant_mode=mode or "dynamic", **cfg),
                    device="cpu").eval()


@pytest.fixture(scope="module")
def trees():
    """A seeded JAX variables tree per task (the unquantised tree: JAX's
    quantised model has the same one)."""
    out = {}
    for i, task in enumerate(CLASSES):
        jmodel = JaxChange3D(task=JaxTask(task), num_classes=CLASSES[task], in_height=HW,
                             in_width=HW, backbone_cfg=JaxX3DConfig(**TINY))
        z = jnp.zeros((1, HW, HW, 3), jnp.float32)
        v = jax.device_get(_random_vars(jmodel, z, z, seed=30 + i))
        out[task] = {"params": v["params"], "batch_stats": v["batch_stats"]}
    return out


def _jax_reference(task, variables, pre, post, calib):
    """JAX's dynamic and static int8 outputs and its calibrated 'quant'
    collection, in one jitted program (one compile instead of three)."""
    models = {mode: JaxChange3D(task=JaxTask(task), num_classes=CLASSES[task], in_height=HW,
                                in_width=HW, backbone_cfg=JaxX3DConfig(**TINY, quantized_eval=True,
                                                                       quant_mode=mode))
              for mode in ("dynamic", "static")}

    def run(v, a, b, ca, cb):
        ranges = jax_calibrate(models["static"], v, [(ca, cb)])
        return ({"dynamic": models["dynamic"].apply(v, a, b, train=False),
                 "static": models["static"].apply({**v, "quant": ranges}, a, b, train=False)},
                ranges)

    return jax.device_get(jax.jit(run)(variables, pre, post, *calib))


@pytest.mark.parametrize("task", list(CLASSES))
def test_quantized_forwards_and_ranges_match_jax(trees, task):
    pre, post = _inputs(1)
    calib = _inputs(2)
    variables = trees[task]
    outs, ranges = _jax_reference(task, variables, pre, post, calib)
    for mode in ("dynamic", "static"):
        model = _port(task, mode)
        model.load_state_dict(from_jax_variables(variables, X3DConfig(**TINY)), strict=True)
        if mode == "static":
            got = calibrate_quant_scales(model, [calib])
            want = from_jax_variables({"quant": ranges}, X3DConfig(**TINY))
            assert set(got) == set(want) and len(want) == 16
            for key, w in want.items():
                assert abs(float(got[key]) - float(w)) <= 1e-6 * float(w), key
        before = quant.int8_matmul.launches
        with torch.no_grad():
            out = model(torch.from_numpy(pre), torch.from_numpy(post))
        assert quant.int8_matmul.launches - before == 2 * 8
        assert set(out) == set(outs[mode])
        for key, w in outs[mode].items():
            w = np.asarray(w)
            err = float(np.abs(out[key].numpy() - w).max())
            assert err <= REL * float(np.abs(w).max()), (mode, key, err)


def test_state_dict_and_training_ignore_quantization(trees):
    plain = _port("bcd", None)
    sd = from_jax_variables(trees["bcd"], X3DConfig(**TINY))
    plain.load_state_dict(sd)
    pre, post = (torch.from_numpy(a) for a in _inputs(4))
    for mode in ("dynamic", "calibrate", "static"):
        model = _port("bcd", mode)
        assert model.state_dict().keys() == plain.state_dict().keys()
        model.load_state_dict(sd, strict=True)
        assert not any(m.fusable for m in model.modules() if isinstance(m, x3d.X3DResBlock))
        model.train()
        plain.train()
        before = quant.int8_matmul.launches
        got, want = model(pre, post)["change"], plain(pre, post)["change"]
        assert quant.int8_matmul.launches == before
        assert torch.equal(got, want), mode
    # The unquantised model fuses; the quantised one never reaches the kernel.
    assert all(m.fusable for m in plain.modules()
               if isinstance(m, x3d.X3DResBlock) and m.proj is None)


def test_int8_weights_are_quantized_once_and_again_after_a_change(trees, monkeypatch):
    model = _port("bcd", "dynamic")
    model.load_state_dict(from_jax_variables(trees["bcd"], X3DConfig(**TINY)))
    calls = []
    real = quant.prepare_weight
    monkeypatch.setattr(quant, "prepare_weight", lambda w: calls.append(1) or real(w))
    pre, post = (torch.from_numpy(a) for a in _inputs(5))
    with torch.no_grad():
        first = model(pre, post)["change"]
        assert len(calls) == 16
        assert torch.equal(model(pre, post)["change"], first) and len(calls) == 16
        block = model.encoder.x3d.stage1.block1.bottleneck
        block.conv_a.mul_(0.5)  # an in-place change, as an optimizer step makes
        model(pre, post)
        assert len(calls) == 17
        model.load_state_dict(from_jax_variables(trees["bcd"], X3DConfig(**TINY)))
        assert torch.equal(model(pre, post)["change"], first) and len(calls) == 33
    assert block.conv_a_q.dtype == torch.int8 and block.conv_a_q.shape == (8, 24)


def test_static_predictor_needs_ranges_and_set_quant_scales_loads_them(trees):
    model = _port("bcd", "static")
    model.load_state_dict(from_jax_variables(trees["bcd"], X3DConfig(**TINY)))
    with pytest.raises(ValueError, match="calibrated scales"):
        Predictor(model, device="cpu")
    scales = calibrate_quant_scales(_port("bcd", "static"), [_inputs(6)])
    with pytest.raises(KeyError, match="no range"):
        set_quant_scales(model, dict(list(scales.items())[1:]))
    set_quant_scales(model, scales)
    assert all(torch.equal(quant_scales(model)[k], v) for k, v in scales.items())
    pred = Predictor(model, compute_dtype=torch.float32, device="cpu")
    assert pred.predict(*_inputs(7))["change"].shape == (2, HW, HW)
    with pytest.raises(ValueError, match="quant_mode 'static'"):
        calibrate_quant_scales(_port("bcd", "dynamic"), [_inputs(6)])


def test_config_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="quant_mode 'int4'"):
        Change3D(Task.BCD, in_height=HW, in_width=HW, device="cpu",
                 backbone_cfg=dataclasses.replace(X3DConfig(**TINY), quantized_eval=True,
                                                  quant_mode="int4"))
