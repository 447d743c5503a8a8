"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import depthwise_conv as dwc
from change3d_tpu_torch.ops import fused_block as fb
from change3d_tpu_torch.ops import repros

pytestmark = pytest.mark.cuda

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)  # about two bf16 ulps at max(|ref|, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from change3d_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _operands(seed, dev, dtype, b, t, h, w, c, ci, cr, has_se):
    """Operands at model scale: x >= 0 (a ReLU output), weights
    U(+-1/sqrt(fan_in)) as torch initialises convs, BN folds near identity.
    (Weights far above that scale blow the bf16 intermediates up until one
    rounding flip, from another fp32 summation order, exceeds the output's
    ulp.)"""
    rng = np.random.RandomState(seed)
    g = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    u = lambda fan, *s: g(rng.uniform(-1, 1, s) / np.sqrt(fan))
    n = lambda base, *s: g(base + 0.1 * rng.randn(*s))
    ops = [g(np.abs(rng.randn(b, t, h, w, c))).to(dtype), u(c, c, ci), n(1, ci), n(0, ci),
           u(27, 3, 3, 3, ci), n(1, ci), n(0, ci), u(ci, ci, c), n(1, c), n(0, c)]
    se = (u(ci, ci, cr), n(0, cr), u(cr, cr, ci), n(0, ci)) if has_se else None
    return ops, se


SHAPES = {
    "ragged": (3, 3, 20, 12, 24, 54, 8),
    "t5_wide": (1, 5, 8, 8, 96, 216, 16),
    "stage4": (2, 3, 16, 16, 192, 432, 32),
    # 10 x 6 under the bf16 plan's 4 x 4 tiles: the last tile row and
    # column hang over the bottom and the right edge.
    "overhang": (2, 3, 10, 6, 96, 216, 16),
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("has_se", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_block_matches_plain_version(cuda, shape, has_se, dtype):
    ops, se = _operands(0, cuda, dtype, *SHAPES[shape], has_se)
    before = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
    got = fb.fused_bottleneck_block(*ops, se)
    torch.cuda.synchronize()
    after = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
    assert after == (before[0] + 1, before[1] + int(has_se))
    assert got.dtype == dtype and got.shape == ops[0].shape
    want = fb.fused_block_reference(*ops, se)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


# The X3D-L stage shapes at 256² (H=W, C, Ci, Cr) on BDA's T = 4 and SCD's
# T = 5 clips: other tile plans than at T = 3 (tests/test_torch_fused_plan.py),
# stage 2 at T = 5 with 7 chunks of Ci (the last 12 wide) and kAcc = 16.
STAGES = {"stage1": (128, 24, 54, 8), "stage2": (64, 48, 108, 8), "stage3": (32, 96, 216, 16),
          "stage4": (16, 192, 432, 32)}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("t", [4, 5], ids=["T4", "T5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_block_matches_plain_version_at_t4_t5(cuda, stage, t, dtype):
    hw, c, ci, cr = STAGES[stage]
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    for has_se in (False, True):
        ops, se = _operands(9, cuda, dtype, 2, t, hw, hw, c, ci, cr, has_se)
        got = fb.fused_bottleneck_block(*ops, se)
        torch.testing.assert_close(got.float(), fb.fused_block_reference(*ops, se).float(), **tol)
    sums = fb.fused_block_se_sums(*ops[:7])
    _, _, _, _, n_tiles = fb.plan_tiles(t, hw, hw, c, ci, ops[0].element_size())
    assert sums.shape == (2, n_tiles, ci)
    assert torch.equal(fb.fused_block_se_sums(*ops[:7]), sums)  # bit-identical rerun


# Kinetics clips whose stages 3 and 4 take T-tiles with a one-frame halo
# (tests/test_torch_fused_plan.py): (B, T, H, W, C, Ci, Cr) of X3D-M at
# 16 x 224^2 and X3D-S at 13 x 160^2 (the last T-tile ragged).
T_TILED = {"m_stage3": (2, 16, 14, 14, 96, 216, 16), "m_stage4": (2, 16, 7, 7, 192, 432, 32),
           "s_stage3": (2, 13, 10, 10, 96, 216, 16), "s_stage4": (2, 13, 5, 5, 192, 432, 32)}


@pytest.mark.parametrize("shape", list(T_TILED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_t_tiled_block_matches_plain_version(cuda, shape, dtype):
    b, t, h, w, c, ci, cr = T_TILED[shape]
    plan = fb.plan_block(t, h, w, c, ci, 2 if dtype == torch.bfloat16 else 4)
    assert plan.tt < t or dtype == torch.float32
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    for has_se in (False, True):
        ops, se = _operands(11, cuda, dtype, *T_TILED[shape], has_se)
        got = fb.fused_bottleneck_block(*ops, se)
        torch.testing.assert_close(got.float(), fb.fused_block_reference(*ops, se).float(), **tol)
    sums = fb.fused_block_se_sums(*ops[:7])
    want = fb.se_sums_reference(*ops[:7])
    assert sums.shape == want.shape == (b, plan.n_tiles, ci)
    if dtype == torch.float32:  # tile by tile: T-tiles outermost
        torch.testing.assert_close(sums, want, **FP32_TOL)
    assert torch.equal(fb.fused_block_se_sums(*ops[:7]), sums)  # bit-identical rerun


def test_x3d_m_classifier_fused_matches_plain_on_card(cuda):
    """X3D-M with its head on a 16-frame clip at 64^2: 22 + 11 fused
    launches per forward, fp32 logits within 1e-3 of the plain model."""
    from change3d_tpu_torch.models.x3d import X3D, x3d_classifier, x3d_m_config

    fused = x3d_classifier(device=cuda, seed=2)
    rs = np.random.RandomState(2)
    with torch.no_grad():  # weights U(+-sqrt(3 / fan_in)), BN away from identity: lively logits
        for name, v in fused.state_dict().items():
            if v.dim() >= 2:
                v.mul_(3 ** 0.5)
            elif name.endswith((".scale", ".var")):
                v.copy_(torch.from_numpy(1 + 0.2 * rs.rand(*v.shape).astype(np.float32)))
            elif name.endswith((".bias", ".mean")):
                v.copy_(torch.from_numpy(0.1 * rs.randn(*v.shape).astype(np.float32)))
    plain = X3D(x3d_m_config(fused_inference=False), head=True).to(cuda).eval()
    plain.load_state_dict(fused.state_dict())
    clip = torch.from_numpy(np.random.RandomState(4).randn(2, 16, 64, 64, 3).astype(
        np.float32)).to(cuda)
    before = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
    with torch.no_grad():
        got = fused(clip, classify=True)
        torch.cuda.synchronize()
        after = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
        want = plain(clip, classify=True)
    assert (after[0] - before[0], after[1] - before[1]) == (22, 11)
    assert got.shape == (2, 400)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("task", ["scd", "bda"])
def test_tiny_scd_bda_models_fused_match_plain_on_card(cuda, task):
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                stage_depths=(2, 3, 3, 2))
    kw = dict(num_classes=6 if task == "scd" else 5, in_height=32, in_width=32, device=cuda)
    fused = Change3D(Task(task), backbone_cfg=X3DConfig(**tiny), **kw).eval()
    plain = Change3D(Task(task), backbone_cfg=X3DConfig(**tiny, fused_inference=False),
                     **kw).eval()
    plain.load_state_dict(fused.state_dict())
    rs = np.random.RandomState(3)
    pre, post = (torch.from_numpy(rs.randn(2, 32, 32, 3).astype(np.float32)).to(cuda)
                 for _ in range(2))
    before = fb.fused_block_fwd.launches
    with torch.no_grad():
        got, want = fused(pre, post), plain(pre, post)
    assert fb.fused_block_fwd.launches - before == 1 + 2 + 2
    assert set(got) == set(want) == ({"pre", "post", "change"} if task == "scd"
                                     else {"cls", "loc"})
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_se_sums_tiles_add_up_to_the_plain_sums(cuda, dtype):
    ops, _ = _operands(1, cuda, dtype, 2, 3, 20, 12, 24, 54, 8, False)
    sums = fb.fused_block_se_sums(*ops[:7])
    _, _, _, _, n_tiles = fb.plan_tiles(3, 20, 12, 24, 54, ops[0].element_size())
    assert sums.shape == (2, n_tiles, 54)
    want = fb.se_sums_reference(*ops[:7])
    assert want.shape == sums.shape
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(sums.sum(1) / (3 * 20 * 12), want.sum(1) / (3 * 20 * 12), **tol)
    if dtype == torch.float32:  # tile by tile, in the kernel's row-major order
        torch.testing.assert_close(sums, want, **FP32_TOL)
    again = fb.fused_block_se_sums(*ops[:7])
    assert torch.equal(sums, again)  # no atomics: bit-identical reruns


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    ops, _ = _operands(2, cuda, torch.float16, 1, 3, 8, 8, 8, 16, 8, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fb.fused_block_fwd(*ops)
    ops[0] = ops[0].float()
    with pytest.raises(ValueError, match="w_c"):
        fb.fused_block_fwd(*ops[:7], ops[7].t(), *ops[8:])
    with pytest.raises(ValueError, match="a_a holds 15 values"):
        fb.fused_block_fwd(ops[0], ops[1], ops[2][:-1], *ops[3:])
    with pytest.raises(ValueError, match="w_dw"):
        fb.fused_block_se_sums(*ops[:4], ops[4].permute(3, 0, 1, 2), *ops[5:7])


def test_bf16_kernels_refuse_shapes_they_do_not_take(cuda):
    ops, _ = _operands(5, cuda, torch.bfloat16, 1, 3, 8, 8, 12, 16, 8, False)
    with pytest.raises(ValueError, match="C % 8"):
        fb.fused_block_fwd(*ops)
    with pytest.raises(ValueError, match="C % 8"):
        fb.fused_block_se_sums(*ops[:7])


def test_tiny_bcd_model_fused_matches_plain_on_card(cuda):
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                stage_depths=(2, 3, 3, 2))
    fused = Change3D(Task.BCD, in_height=32, in_width=32, backbone_cfg=X3DConfig(**tiny),
                     device=cuda).eval()
    plain = Change3D(Task.BCD, in_height=32, in_width=32,
                     backbone_cfg=X3DConfig(**tiny, fused_inference=False), device=cuda).eval()
    plain.load_state_dict(fused.state_dict())
    rs = np.random.RandomState(3)
    pre, post = (torch.from_numpy(rs.randn(2, 32, 32, 3).astype(np.float32)).to(cuda)
                 for _ in range(2))
    before = fb.fused_block_fwd.launches
    dw_before = dwc.depthwise_conv3d.launches
    with torch.no_grad():
        got = fused(pre, post)["change"]
        # The stem and each stage's block 0 (the others are fused).
        assert dwc.depthwise_conv3d.launches - dw_before == 1 + 3
        want = plain(pre, post)["change"]
    assert dwc.depthwise_conv3d.launches - dw_before == 1 + 3 + 1 + 2 + 3 + 3
    assert fb.fused_block_fwd.launches - before == 1 + 2 + 2
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (B, T, H, W, C, kernel, stride, padding) of every main path's depthwise
# conv: X3D-L's stem and strided block 0s at 256² on T = 3 (BCD, CC; stage 4
# CC only), 4 (BDA) and 5 (SCD), the stride-1 blocks of stages 1-4 on every
# clip (the int8 and unfused forwards; stage 4 CC only), X3D-M's 16-frame
# stem, stage 4 and stride-1 blocks, and a temporal stride of 2.
DW_SHAPES = {
    "stem": (2, 3, 256, 256, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0)),
    "stem_t16": (2, 16, 112, 112, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0)),
    "stem_st2": (2, 5, 64, 64, 24, (5, 1, 1), (2, 1, 1), (2, 0, 0)),
    "stage1_s2": (2, 3, 256, 256, 54, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage2_s2": (2, 3, 128, 128, 108, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage3_s2": (2, 3, 64, 64, 216, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage4_s2": (2, 3, 32, 32, 432, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage1_s2_t5": (2, 5, 256, 256, 54, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage3_s2_t4": (2, 4, 64, 64, 216, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage1_s1": (2, 3, 128, 128, 54, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "stage2_s1": (2, 3, 64, 64, 108, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "stage3_s1": (2, 3, 32, 32, 216, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "stage4_s1": (2, 3, 16, 16, 432, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    **{f"stage{i}_s1_t{t}": (2, t, hw, hw, c, (3, 3, 3), (1, 1, 1), (1, 1, 1))
       for t in (4, 5) for i, hw, c in ((1, 128, 54), (2, 64, 108), (3, 32, 216))},
    "x3dm_stage4_s2": (2, 16, 14, 14, 432, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    **{f"x3dm_stage{i}_s1": (2, 16, hw, hw, c, (3, 3, 3), (1, 1, 1), (1, 1, 1))
       for i, hw, c in ((1, 56, 54), (2, 28, 108), (3, 14, 216), (4, 7, 432))},
}


def _dw_operands(seed, dev, dtype, b, t, h, w, c, ks):
    """x ~ N(0, 1) and weights U(+-1/sqrt(taps)), as torch initialises them."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, t, h, w, c).astype(np.float32)).to(dev, dtype)
    taps = int(np.prod(ks))
    k = torch.from_numpy((rng.uniform(-1, 1, (c, 1, *ks)) / np.sqrt(taps)).astype(np.float32))
    return x, k.to(dev)


def _assert_within(got, want, dtype):
    """fp32: |d| <= 1e-5 (1 + |ref|); bf16: two bf16 ulps of max(|ref|, 1)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        tol = 1e-5 * (1 + want.abs())
    else:
        tol = 2 * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1.0))) - 7)
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all()) and bool((d <= tol).all()), float((d / tol).max())


@pytest.mark.parametrize("shape", list(DW_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_depthwise_kernel_matches_plain_version(cuda, shape, dtype):
    b, t, h, w, c, ks, stride, pad = DW_SHAPES[shape]
    x, k = _dw_operands(0, cuda, dtype, b, t, h, w, c, ks)
    before = dwc.depthwise_conv3d.launches
    got = dwc.depthwise_conv3d(x, k, stride=stride, padding=pad)
    torch.cuda.synchronize()
    assert dwc.depthwise_conv3d.launches == before + 1
    want = dwc.depthwise_conv3d_reference(x, k, stride, pad)
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    _assert_within(got, want, dtype)


def test_depthwise_kernel_refuses_what_it_does_not_take(cuda):
    x, k = _dw_operands(1, cuda, torch.bfloat16, 1, 3, 8, 8, 16, (3, 3, 3))
    with pytest.raises(ValueError, match="contiguous"):
        dwc.depthwise_conv3d(x.transpose(2, 3), k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dwc.depthwise_conv3d(x.half(), k)
    with pytest.raises(ValueError, match="shape mismatch"):
        dwc.depthwise_conv3d(x, k[:8])


def test_depthwise_routing_on_card(cuda):
    """Gradients on: F.conv3d (no launch), the same values; off: the kernel."""
    from change3d_tpu_torch.ops import layers

    x, k = _dw_operands(2, cuda, torch.float32, 2, 3, 16, 16, 24, (3, 3, 3))
    k.requires_grad_(True)
    before = dwc.depthwise_conv3d.launches
    y = layers.depthwise_conv3d(x, k, stride=(1, 2, 2))
    y.sum().backward()
    assert dwc.depthwise_conv3d.launches == before and k.grad is not None
    with torch.no_grad():
        z = layers.depthwise_conv3d(x, k, stride=(1, 2, 2))
    assert dwc.depthwise_conv3d.launches == before + 1
    _assert_within(z, y.detach(), torch.float32)


# (K, N) of every int8 product of X3D-L: conv_a C -> Ci (block 0: the
# previous stage's C -> Ci) and conv_c Ci -> C per stage (the padded K = 54
# and 108 among them).
INT8_WIDTHS = [(24, 54), (54, 24), (24, 108), (48, 108), (108, 48), (48, 216), (96, 216),
               (216, 96), (96, 432), (192, 432), (432, 192)]


@pytest.mark.parametrize("rows", [12, 3 * 16 * 16, 3 * 64 * 64])
def test_padded_int8_matmul_equals_the_int32_product_on_card(cuda, rows):
    """Up to 8 x 3 x 64 x 64 rows: stage 3's first product at batch 8
    (where cuBLASLt refuses a column-major kernel); the fp64 product of the
    same int8 operands is exact (integer sums below 2^53)."""
    from change3d_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(rows)
    for k, n in INT8_WIDTHS:
        xq = torch.randint(-127, 128, (8 * rows, k), generator=gen, device=cuda,
                           dtype=torch.int8)
        w = quant.prepare_weight(torch.randn(k, n, generator=gen, device=cuda))
        got = quant.int8_matmul(xq, w, rows_per_sample=rows)
        want = xq.double() @ w.q[:k, :n].double()
        assert got.dtype == torch.int32 and torch.equal(got.double(), want), (rows, k, n)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_tiny_int8_model_on_card_matches_cpu(cuda, mode):
    from change3d_tpu_torch.inference import calibrate_quant_scales
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig
    from change3d_tpu_torch.ops import quant

    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                stage_depths=(2, 3, 3, 2), quantized_eval=True, quant_mode=mode)
    models = {d: Change3D(Task.BCD, in_height=32, in_width=32, backbone_cfg=X3DConfig(**tiny),
                          device=d, seed=4).eval() for d in ("cpu", cuda)}
    rs = np.random.RandomState(4)
    pre, post = (rs.randn(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    if mode == "static":
        for model in models.values():
            calibrate_quant_scales(model, [(pre, post)])
    out = {}
    before = quant.int8_matmul.launches
    with torch.no_grad():
        for d, model in models.items():
            out[d] = model(torch.from_numpy(pre).to(d), torch.from_numpy(post).to(d))["change"]
    assert quant.int8_matmul.launches - before == 2 * 2 * 8
    torch.testing.assert_close(out[cuda].cpu(), out["cpu"], rtol=1e-4, atol=1e-4)


def test_full_width_bf16_train_step_runs(cuda):
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    model = Change3D(Task.BCD, device=cuda, seed=0)
    opt = torch_adam(model.parameters(), weight_decay=1e-4)
    rs = np.random.RandomState(0)
    batch = {"pre": torch.from_numpy(rs.randn(2, 256, 256, 3).astype(np.float32)).to(cuda),
             "post": torch.from_numpy(rs.randn(2, 256, 256, 3).astype(np.float32)).to(cuda),
             "label": torch.from_numpy((rs.rand(2, 256, 256, 1) > 0.8).astype(np.int32)).to(cuda)}
    before = fb.fused_block_fwd.launches
    m = train_step(model, opt, lambda _: 2e-4, batch, 0, compute_dtype=torch.bfloat16)
    assert fb.fused_block_fwd.launches == before  # training runs the plain blocks
    assert torch.isfinite(m["loss"]) and float(m["cm"].sum()) == 2 * 256 * 256
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_reduced_depth_fp32_train_step_matches_cpu(cuda):
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig
    from change3d_tpu_torch.train.engine import train_step
    from change3d_tpu_torch.train.optim import torch_adam

    tiny = X3DConfig(stem_dim_out=8, stage_dims=(8, 16, 24, 32),
                     stage_inner_dims=(18, 36, 54, 72), stage_depths=(2, 3, 3, 2))
    rs = np.random.RandomState(1)
    batch = {"pre": torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32)),
             "post": torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32)),
             "label": torch.from_numpy((rs.rand(2, 64, 64, 1) > 0.7).astype(np.int32))}
    out = []
    for dev in ("cpu", cuda):
        model = Change3D(Task.BCD, in_height=64, in_width=64, backbone_cfg=tiny, device=dev,
                         seed=3)
        opt = torch_adam(model.parameters(), weight_decay=1e-4)
        m = train_step(model, opt, lambda _: 1e-3, {k: v.to(dev) for k, v in batch.items()}, 0)
        out.append((float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = out
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    # Normwise: single BN-scale gradient elements come out of a cancellation
    # (sum(dy x) - mean sum(dy)) whose fp32 error is large on either device.
    for n, want in g_cpu.items():
        assert float((g_gpu[n] - want).norm()) <= 1e-2 * float(want.norm()), n


@pytest.mark.parametrize("shape", ["ragged", "overhang", "stage4"])
def test_bf16_se_sums_reruns_are_bit_identical(cuda, shape):
    b, t, h, w, c, ci, cr = SHAPES[shape]
    ops, _ = _operands(4, cuda, torch.bfloat16, b, t, h, w, c, ci, cr, False)
    tile, _, _, _, n_tiles = fb.plan_tiles(t, h, w, c, ci, 2)
    assert h % tile or w % tile or shape == "stage4"
    first = fb.fused_block_se_sums(*ops[:7])
    assert first.shape == (b, n_tiles, ci)
    for _ in range(3):
        assert torch.equal(fb.fused_block_se_sums(*ops[:7]), first)
    torch.testing.assert_close(first.sum(1) / (t * h * w),
                               fb.se_sums_reference(*ops[:7]).sum(1) / (t * h * w), **BF16_TOL)


def test_repro_kernels_match_plain_versions(cuda):
    x, w, xd = repros.repro_operands(0, cuda)
    before = (repros.dot_1d.launches, repros.manual_dma.launches)
    got = repros.dot_1d(x, w)
    got_dma = repros.manual_dma(xd)
    torch.cuda.synchronize()
    assert (repros.dot_1d.launches, repros.manual_dma.launches) == (before[0] + 1, before[1] + 1)
    want = repros.dot_1d_reference(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (256, 128)
    assert repros.bf16_ulps_used(got, want) <= 1.0  # two bf16 ulps of max(|ref|, 1)
    assert torch.equal(got, got[:1].expand_as(got))  # one row, broadcast
    assert torch.equal(got_dma, repros.manual_dma_reference(xd))  # exact


def test_repro_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x, w, xd = repros.repro_operands(1, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        repros.dot_1d(x.float(), w)
    with pytest.raises(ValueError, match="N % 8"):
        repros.dot_1d(x, w[:, :12])
    with pytest.raises(ValueError, match="C % 8"):
        repros.dot_1d(x[:, :12], w[:12])
    with pytest.raises(TypeError, match="float32"):
        repros.manual_dma(xd.to(torch.bfloat16))
    with pytest.raises(ValueError, match=r"R\*C % 4"):
        repros.manual_dma(torch.zeros(1, 3, 3, device=cuda))


# N, R, C: chunks of 2 KB (repro), one chunk per slab (small), a ragged last
# chunk (3600 floats in chunks of 512), a 1 MB slab, four and two chunks per
# block (double buffers; the second ragged), one 16-byte slab per chunk.
DMA_SHAPES = [(4, 128, 128), (3, 16, 8), (5, 100, 36), (1, 512, 512), (16, 512, 512),
              (50, 300, 100), (1000, 1, 4)]


@pytest.mark.parametrize("shape", DMA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_manual_dma_is_exact_at_every_plan(cuda, shape):
    x = torch.from_numpy(np.random.RandomState(7).randn(*shape).astype(np.float32)).to(cuda)
    before = repros.manual_dma.launches
    got = repros.manual_dma(x)
    torch.cuda.synchronize()
    assert repros.manual_dma.launches == before + 1
    assert torch.equal(got, 2 * x)


# R, C, N: the repro, R ragged over the 8 ranks, R < 8 (ranks without rows).
DOT_SHAPES = [(256, 128, 128), (1000, 40, 40), (5, 128, 128)]


@pytest.mark.parametrize("shape", DOT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dot_1d_cluster_matches_plain_version_and_reruns_bit_identical(cuda, shape):
    r, c, n = shape
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.randn(r, c).astype(np.float32)).to(torch.bfloat16).to(cuda)
    w = torch.from_numpy(rs.randn(c, n).astype(np.float32)).to(torch.bfloat16).to(cuda)
    before = repros.dot_1d.launches
    first = repros.dot_1d(x, w)
    torch.cuda.synchronize()
    assert repros.dot_1d.launches == before + 1
    assert first.shape == (r, n) and torch.equal(first, first[:1].expand_as(first))
    assert repros.bf16_ulps_used(first, repros.dot_1d_reference(x, w)) <= 1.0
    for _ in range(5):  # fixed-order sums: no atomics
        assert torch.equal(repros.dot_1d(x, w), first)



# The four X3D-L stage shapes at B = 32, the CC evaluation batch, on T = 3.
@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_block_matches_plain_version_at_b32(cuda, stage, dtype):
    hw, c, ci, cr = STAGES[stage]
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    for has_se in (False, True):
        ops, se = _operands(11, cuda, dtype, 32, 3, hw, hw, c, ci, cr, has_se)
        got = fb.fused_bottleneck_block(*ops, se)
        torch.testing.assert_close(got.float(), fb.fused_block_reference(*ops, se).float(), **tol)


def test_tiny_cc_model_fused_matches_plain_on_card(cuda):
    """A TINY-width CC model with stage 4 (a fused SE and a fused plain
    block there): memory and teacher-forced logits, fused against plain,
    and equal beam-3 tokens through CaptionPredictor."""
    from change3d_tpu_torch.inference import CaptionPredictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72),
                stage_depths=(2, 3, 3, 3))
    kw = dict(in_height=32, in_width=32, vocab_size=11, embed_dim=32, num_heads=4,
              num_layers=2, device=cuda)
    fused = Change3D(Task.CC, backbone_cfg=X3DConfig(**tiny), **kw).eval()
    plain = Change3D(Task.CC, backbone_cfg=X3DConfig(**tiny, fused_inference=False), **kw).eval()
    plain.load_state_dict(fused.state_dict())
    rs = np.random.RandomState(4)
    pre, post = (torch.from_numpy(rs.randn(2, 32, 32, 3).astype(np.float32)).to(cuda)
                 for _ in range(2))
    caps = torch.from_numpy(rs.randint(2, 11, (2, 9))).to(cuda)
    before = fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches
    with torch.no_grad():
        got, want = fused(pre, post, caps), plain(pre, post, caps)
    assert (fb.fused_block_fwd.launches - before[0], fb.fused_block_se_sums.launches - before[1]) \
        == (1 + 2 + 2 + 2, 0 + 1 + 1 + 1)
    for k in ("memory", "logits"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
    words = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
    words.update({f"w{i}": i for i in range(4, 11)})
    caption = lambda m: CaptionPredictor(m, words, beam_size=3, compute_dtype=torch.float32,
                                         device=cuda).caption_device(pre, post)[0]
    assert torch.equal(caption(fused), caption(plain))


def test_async_launches_in_flight_equal_predict_u8(cuda):
    """Two predict_u8_async launches in flight, finalized in reverse order,
    give exactly what predict_u8 gives for each batch (every launch copies
    into its own pinned buffers)."""
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task

    pred = Predictor(Change3D(Task.BDA, num_classes=5, device=cuda, seed=1), device=cuda)
    rs = np.random.RandomState(6)
    batches = [tuple(rs.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8) for _ in range(2))
               for _ in range(2)]
    launches = [pred.predict_u8_async(*b) for b in batches]
    assert all(launch.event is not None and launch.out["loc"].is_pinned() for launch in launches)
    got = [pred.finalize_u8(launch) for launch in launches[::-1]][::-1]
    for b, g in zip(batches, got):
        want = pred.predict_u8(*b)
        assert set(g) == set(want) == {"cls", "loc"}
        for key in want:
            np.testing.assert_array_equal(g[key], want[key])


def test_served_batch_launches_37_and_18(cuda):
    """A bulk request of 8 pairs to a warmed-up BCD server (buckets 2/4/8)
    is one batch: 37 fused_block_fwd and 18 fused_block_se_sums launches,
    and the masks predict_u8 gives for the same batch."""
    import threading

    from change3d_tpu_torch.client import PredictClient
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.serving import PredictService, make_server

    pred = Predictor(Change3D(Task.BCD, device=cuda, seed=2), device=cuda)
    service = PredictService("bcd", pred, batch_size=8, max_delay_ms=5, warmup=True)
    httpd = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        rs = np.random.RandomState(7)
        pres, posts = (rs.randint(0, 256, (8, 256, 256, 3)).astype(np.uint8) for _ in range(2))
        client = PredictClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        before = fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches
        out = client.predict_raw_many(pres[..., ::-1], posts[..., ::-1])
        assert (fb.fused_block_fwd.launches - before[0],
                fb.fused_block_se_sums.launches - before[1]) == (37, 18)
        assert client.metrics()["batches_total"] == 1
        want = pred.predict_u8(pres, posts)["change"]
        np.testing.assert_array_equal(out["change"], want.astype(np.uint8) * 255)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        thread.join(timeout=10)


def _program_devices(program):
    """The device types a moved program's graph names: tensor metadata,
    device arguments, weights and constants."""
    devs = {t.device.type for t in (*program.state_dict.values(), *program.constants.values())
            if isinstance(t, torch.Tensor)}
    for mod in program.graph_module.modules():
        if isinstance(mod, torch.fx.GraphModule):
            for node in mod.graph.nodes:
                if isinstance(node.meta.get("val"), torch.Tensor):
                    devs.add(node.meta["val"].device.type)
                if "device" in node.kwargs:
                    devs.add(torch.device(node.kwargs["device"]).type)
    return devs


def test_cpu_exported_artifacts_run_the_kernels_on_the_card(cuda):
    """TINY BCD and CC models exported on the CPU (symbolic batch), moved to
    the card by the loaders: every op of the graph names the card, the
    fused blocks launch the CUDA kernels (5 + 2 per BCD forward, 7 + 3 per
    CC call) under inference mode, the BCD outputs equal the live fused
    model's on the card and the beam-3 tokens the live CaptionPredictor's."""
    from change3d_tpu_torch import export as ex
    from change3d_tpu_torch.inference import CaptionPredictor
    from change3d_tpu_torch.models.trainer import Change3D, Task
    from change3d_tpu_torch.models.x3d import X3DConfig

    tiny = dict(stem_dim_out=8, stage_dims=(8, 16, 24, 32), stage_inner_dims=(18, 36, 54, 72))
    bcd = Change3D(Task.BCD, in_height=32, in_width=32,
                   backbone_cfg=X3DConfig(**tiny, stage_depths=(2, 3, 3, 2)), device="cpu")
    fn = ex.load_exported(ex.export_model(bcd, compute_dtype=torch.float32), device=cuda)
    assert _program_devices(fn.program) == {"cuda"}
    bcd = bcd.to(cuda).eval()
    rs = np.random.RandomState(8)
    for b in (3, 5):
        pre, post = (torch.from_numpy(rs.randn(b, 32, 32, 3).astype(np.float32)).to(cuda)
                     for _ in range(2))
        before = fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches
        got = fn(pre, post)["change"]
        torch.cuda.synchronize()
        assert (fb.fused_block_fwd.launches - before[0],
                fb.fused_block_se_sums.launches - before[1]) == (5, 2)
        with torch.no_grad():
            torch.testing.assert_close(got, bcd(pre, post)["change"], rtol=0, atol=0)

    words = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3}
    words.update({f"w{i}": i for i in range(4, 11)})
    cc = Change3D(Task.CC, in_height=32, in_width=32, vocab_size=11, embed_dim=32, num_heads=4,
                  num_layers=2, backbone_cfg=X3DConfig(**tiny, stage_depths=(2, 3, 3, 3)),
                  device="cpu")
    with torch.no_grad():
        cc.decoder.out_b[3] += 2.0  # captions that end inside the 52 tokens
    fn = ex.load_exported_captioner(
        ex.export_caption_model(cc, words, beam_size=3, compute_dtype=torch.float32),
        device=cuda)
    assert _program_devices(fn.program) == {"cuda"}
    pre, post = (torch.from_numpy(rs.randn(4, 32, 32, 3).astype(np.float32)).to(cuda)
                 for _ in range(2))
    before = fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches
    tokens, scores = fn(pre, post)
    torch.cuda.synchronize()
    assert (fb.fused_block_fwd.launches - before[0],
            fb.fused_block_se_sums.launches - before[1]) == (7, 3)
    live = CaptionPredictor(cc, words, beam_size=3, compute_dtype=torch.float32, device=cuda)
    want_tokens, want_scores = live.caption_device(pre, post)
    assert torch.equal(tokens.long(), want_tokens)
    torch.testing.assert_close(scores, want_scores, rtol=1e-5, atol=0)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (a launch on the second card from the first)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernels_launch_on_their_tensors_card(two_cards, dtype):
    """Operands on card 1 from a process whose current card is 0: each
    wrapper launches on card 1 and agrees with the plain version there."""
    first, second = two_cards
    torch.cuda.set_device(first)
    ops, se = _operands(0, second, dtype, *SHAPES["ragged"], True)
    got = fb.fused_bottleneck_block(*ops, se)
    x, w, xd = repros.repro_operands(0, second)
    got_dot, got_dma = repros.dot_1d(x, w), repros.manual_dma(xd)
    torch.cuda.synchronize(second)
    assert torch.cuda.current_device() == 0
    assert got.device == got_dot.device == got_dma.device == second
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), fb.fused_block_reference(*ops, se).float(), **tol)
    assert repros.bf16_ulps_used(got_dot, repros.dot_1d_reference(x, w)) <= 1.0
    assert torch.equal(got_dma, repros.manual_dma_reference(xd))


def test_sharded_predictor_spreads_over_every_card(two_cards):
    """``Predictor(shard=True)`` over every card: one replica and one
    (37 + 18)-launch forward per card, masks equal to one card's on the
    same slices."""
    from change3d_tpu_torch.inference import Predictor
    from change3d_tpu_torch.models.trainer import Change3D, Task

    n = torch.cuda.device_count()
    one = Predictor(Change3D(Task.BCD, in_height=64, in_width=64, device="cuda:0", seed=0))
    all_cards = Predictor(Change3D(Task.BCD, in_height=64, in_width=64, device="cuda:0", seed=0),
                          shard=True)
    assert all_cards.devices == [torch.device("cuda", i) for i in range(n)]
    rs = np.random.RandomState(0)
    pre, post = (rs.randint(0, 256, (2 * n, 64, 64, 3)).astype(np.uint8) for _ in range(2))
    # One card on the same slices of 2 (another batch may take other conv
    # algorithms in bf16).
    parts = [one.predict_u8(pre[i:i + 2], post[i:i + 2]) for i in range(0, 2 * n, 2)]
    want = {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}
    before = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
    got = all_cards.predict_u8(pre, post)
    after = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (37 * n, 18 * n)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
