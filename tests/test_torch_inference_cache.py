"""``InferenceCache`` (``ops/norm.py``): the folded BNs and the fused blocks'
weights are kept between eval forwards while their sources are unchanged,
and every kind of write to a source is seen by the next forward."""

import numpy as np
import pytest
import torch
from torch import nn

from change3d_tpu_torch.inference import Predictor
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DBottleneck, X3DConfig
from change3d_tpu_torch.ops.norm import BatchNorm

TINY = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
            stage_depths=(2, 3, 3, 2))


def _bn(seed: int = 0) -> BatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(6)
    with torch.no_grad():
        for t in (bn.scale, bn.bias, bn.mean):
            t.copy_(torch.randn(6, generator=g))
        bn.var.copy_(torch.rand(6, generator=g) + 0.5)
    return bn.eval()


def _fold(bn: BatchNorm):
    a = bn.scale.float() * torch.rsqrt(bn.var.float() + bn.eps)
    return a, bn.bias.float() - bn.mean.float() * a


def _copy_var(bn):
    with torch.no_grad():
        bn.var.copy_(bn.var * 2)


def _load_state_dict(bn):
    bn.load_state_dict(_bn(seed=1).state_dict())


def _train_forward(bn):
    bn.train()
    with torch.no_grad():
        bn(torch.randn(4, 6, generator=torch.Generator().manual_seed(2)))
    bn.eval()


def _optimizer_step(bn):
    opt = torch.optim.SGD(bn.parameters(), lr=0.5)
    bn.train()
    bn(torch.randn(4, 6, generator=torch.Generator().manual_seed(3))).square().sum().backward()
    opt.step()
    bn.eval()


def _replaced_parameter(bn):
    # A new parameter whose version counter reads what the old one's does:
    # its address tells them apart.
    scale = nn.Parameter(torch.empty(6))
    with torch.no_grad():
        scale.copy_(bn.scale * 3)
    assert scale._version == bn.scale._version
    bn.scale = scale


def _to_float64(bn):
    bn.double()


WRITES = [_copy_var, _load_state_dict, _train_forward, _optimizer_step, _replaced_parameter,
          _to_float64]


@pytest.mark.parametrize("write", WRITES, ids=[w.__name__[1:] for w in WRITES])
def test_bn_folds_are_kept_and_follow_every_write(write):
    bn = _bn()
    with torch.inference_mode():
        a, b = bn.folded()
        again = bn.folded()
    assert again[0] is a and again[1] is b
    write(bn)
    with torch.inference_mode():
        got = bn.folded()
    want = _fold(bn)
    assert got[0] is not a and got[1] is not b
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_nothing_is_kept_under_autograd_or_for_inference_tensors():
    bn = _bn()
    a, _ = bn.folded()
    assert a.requires_grad and bn.folded()[0] is not a
    with torch.no_grad():
        kept = bn.folded()[0]
        assert bn.folded()[0] is kept
    with torch.inference_mode():
        made_here = _bn()
        first = made_here.folded()[0]
        assert made_here.folded()[0] is not first
        assert torch.equal(made_here.folded()[0], first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_predictor_after_load_state_dict_equals_a_fresh_one(dtype):
    """Eval forwards keep the fused blocks' weights; loading other weights
    gives bit for bit what a predictor built on those weights gives."""
    kw = dict(in_height=16, in_width=16, backbone_cfg=X3DConfig(**TINY), device="cpu")
    rng = np.random.default_rng(0)
    pre, post = (rng.standard_normal((2, 16, 16, 3), dtype=np.float32) for _ in range(2))
    pred = Predictor(Change3D(Task.BCD, seed=1, **kw), compute_dtype=dtype, device="cpu")
    other = Predictor(Change3D(Task.BCD, seed=2, **kw), compute_dtype=dtype, device="cpu")
    first = pred.predict_probs(pre, post)["change"]
    block = next(m for m in pred.model.modules() if isinstance(m, X3DBottleneck)
                 and m._fused_weights._value is not None)
    kept = block._fused_weights._value
    assert np.array_equal(pred.predict_probs(pre, post)["change"], first)
    assert block._fused_weights._value is kept
    pred.model.load_state_dict(other.model.state_dict())
    got, want = pred.predict_probs(pre, post)["change"], other.predict_probs(pre, post)["change"]
    assert np.array_equal(got, want) and not np.array_equal(got, first)
    assert block._fused_weights._value is not kept
