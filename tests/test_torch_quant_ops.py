"""The port's int8 ops (``change3d_tpu_torch/ops/quant.py``) against the JAX
package's (``change3d_tpu/ops/quant.py``) on the same seeded numpy inputs,
on the CPU: the int8 tensors equal exactly, the fp32 scales and outputs
within 1 ulp; the zero tensor; bf16 kept; and ``int8_matmul``'s padded
product equal to the plain int32 product at every X3D-L and TINY width."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from change3d_tpu.ops import quant as jq
from change3d_tpu_torch.ops import quant

from tests._torch_parallel import few_threads  # noqa: F401 (autouse)

T = torch.from_numpy


def _ulp1(got: torch.Tensor, want) -> None:
    np.testing.assert_array_max_ulp(got.float().numpy(), np.asarray(want, np.float32), maxulp=1)


def test_quantize_weight_matches_jax():
    rs = np.random.RandomState(0)
    w = (rs.randn(54, 24) * rs.rand(24)).astype(np.float32)
    w[:, 3] = 0.0  # a dead output channel takes the eps scale
    q, s = quant.quantize_weight(T(w), channel_axis=1)
    jq_, js = jq.quantize_weight(jnp.asarray(w), channel_axis=1)
    assert q.dtype == torch.int8 and tuple(s.shape) == (1, 24)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    _ulp1(s, js)


def test_quantize_act_matches_jax_per_sample_and_on_zeros():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 3, 5, 6, 18).astype(np.float32)
    x[2] *= 100.0  # one large sample keeps its neighbours' resolution
    q, s = quant.quantize_act(T(x))
    jq_, js = jq.quantize_act(jnp.asarray(x))
    assert tuple(s.shape) == (4, 1, 1, 1, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    _ulp1(s, js)
    q0, s0 = quant.quantize_act(torch.zeros(2, 3, 3, 4))
    jq0, js0 = jq.quantize_act(jnp.zeros((2, 3, 3, 4)))
    assert not q0.any() and torch.isfinite(s0).all()
    np.testing.assert_array_equal(s0.numpy(), np.asarray(js0))


def test_static_quantize_and_batch_amax_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 4, 4, 36).astype(np.float32)
    amax = quant.batch_amax(T(x))
    np.testing.assert_array_equal(amax.numpy(), np.asarray(jq.batch_amax(jnp.asarray(x))))
    small = amax * 0.5  # half the range: the rest saturates at +-127
    q, s = quant.quantize_act_static(T(x), small)
    jq_, js = jq.quantize_act_static(jnp.asarray(x), jnp.asarray(small.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    assert (q.abs() == 127).float().mean() > 0.02
    _ulp1(s, js)


@pytest.mark.parametrize("c_in,c_out", [(24, 54), (54, 24)])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_pointwise_int8_matches_jax(c_in, c_out, static):
    """Stage 1's widths: N = 54 and K = 54 run the padded product."""
    rs = np.random.RandomState(c_in + c_out)
    x = rs.randn(2, 3, 4, 5, c_in).astype(np.float32)
    w = (rs.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_in)).astype(np.float32)
    prepared = quant.prepare_weight(T(w))
    if static:
        amax = np.float32(0.8 * np.abs(x).max())
        got = quant.pointwise_conv3d_int8_static(T(x), prepared, torch.tensor(amax))
        want = jq.pointwise_conv3d_int8_static(jnp.asarray(x), jnp.asarray(w), jnp.asarray(amax))
    else:
        got = quant.pointwise_conv3d_int8(T(x), prepared)
        want = jq.pointwise_conv3d_int8(jnp.asarray(x), jnp.asarray(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    _ulp1(got, want)


def test_bf16_dtype_kept_and_equal_to_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(1, 2, 4, 4, 8).astype(np.float32)
    w = rs.randn(8, 16).astype(np.float32)
    xb = T(x).to(torch.bfloat16)
    got = quant.pointwise_conv3d_int8(xb, quant.prepare_weight(T(w)))
    want = jq.pointwise_conv3d_int8(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# (K, N) of conv_a and conv_c at every X3D-L stage (24/48/96/192 with inner
# 54/108/216/432) and the TINY widths; rows above and at most 16 per sample.
WIDTHS = [(24, 54), (54, 24), (48, 108), (108, 48), (96, 216), (216, 96), (192, 432),
          (432, 192), (8, 18), (18, 8), (16, 36), (36, 16)]


@pytest.mark.parametrize("rows", [12, 40])
def test_padded_int8_matmul_equals_the_int32_product(rows):
    rs = np.random.RandomState(rows)
    before = quant.int8_matmul.launches
    for k, n in WIDTHS:
        xq = T(rs.randint(-127, 128, (3 * rows, k)).astype(np.int8))
        w = quant.prepare_weight(T(rs.randn(k, n).astype(np.float32)))
        assert w.q.shape == (-(-k // 8) * 8, -(-n // 8) * 8) and w.q.is_contiguous()
        got = quant.int8_matmul(xq, w, rows_per_sample=rows)
        wq = w.q[:k, :n].int()
        assert got.dtype == torch.int32
        assert torch.equal(got, xq.int() @ wq), (k, n)
    assert quant.int8_matmul.launches - before == len(WIDTHS)
