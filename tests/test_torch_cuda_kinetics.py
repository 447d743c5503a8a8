"""X3D-L's Kinetics classifier at its published 16 x 312^2 on the card: the
fused blocks at each stage's shape (ragged 4 x 4 tiles at 78, 39 and 10;
stage 3 in T-tiles of 8 and stage 4 of 3), the depthwise kernel at the stem
and the strided conv_b's (39 -> 20 among them), each against its plain
version, and one ``ClipClassifier.classify_u8`` call at batch 4 against the
benchmark's fp32 reference within the ``x3dl-classify-v30`` cell's limits,
with every block on its kernel.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kinetics.py -q
"""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import depthwise_conv as dwc
from change3d_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)  # about two bf16 ulps at max(|ref|, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from change3d_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _operands(seed, dev, b, t, h, w, c, ci, cr, has_se):
    """bf16 operands at model scale (as tests/test_torch_cuda.py's): x >= 0
    (a ReLU output), weights U(+-1/sqrt(fan_in)), BN folds near identity."""
    rng = np.random.RandomState(seed)
    g = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    u = lambda fan, *s: g(rng.uniform(-1, 1, s) / np.sqrt(fan))
    n = lambda base, *s: g(base + 0.1 * rng.randn(*s))
    ops = [g(np.abs(rng.randn(b, t, h, w, c))).to(torch.bfloat16), u(c, c, ci), n(1, ci),
           n(0, ci), u(27, 3, 3, 3, ci), n(1, ci), n(0, ci), u(ci, ci, c), n(1, c), n(0, c)]
    se = (u(ci, ci, cr), n(0, cr), u(cr, cr, ci), n(0, ci)) if has_se else None
    return ops, se


def _dw_operands(seed, dev, b, t, h, w, c, ks):
    """bf16 x ~ N(0, 1) and taps U(+-1/sqrt(taps)), as torch initialises them."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, t, h, w, c).astype(np.float32)).to(dev, torch.bfloat16)
    k = rng.uniform(-1, 1, (c, 1, *ks)) / np.sqrt(np.prod(ks))
    return x, torch.from_numpy(k.astype(np.float32)).to(dev)


def _assert_within_two_ulps(got, want):
    """|got - want| within two bf16 ulps of max(|want|, 1)."""
    got, want = got.float(), want.float()
    tol = 2 * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1.0))) - 7)
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all()) and bool((d <= tol).all()), float((d / tol).max())


# (B, T, H, W, C, Ci, Cr) of the fused blocks of stages 1-4 at 16 x 312^2.
STAGES = {"stage1": (2, 16, 78, 78, 24, 54, 8), "stage2": (2, 16, 39, 39, 48, 108, 8),
          "stage3": (2, 16, 20, 20, 96, 216, 16), "stage4": (2, 16, 10, 10, 192, 432, 32)}


@pytest.mark.parametrize("stage", list(STAGES))
def test_fused_block_matches_plain_version(cuda, stage):
    b, t, h, w, c, ci, _ = STAGES[stage]
    plan = fb.plan_block(t, h, w, c, ci, 2)
    assert not plan.resident and (h % plan.tile or plan.tt < t)
    for has_se in (False, True):
        ops, se = _operands(21, cuda, *STAGES[stage], has_se)
        got = fb.fused_bottleneck_block(*ops, se)
        torch.testing.assert_close(got.float(), fb.fused_block_reference(*ops, se).float(),
                                   **BF16_TOL)
    sums = fb.fused_block_se_sums(*ops[:7])
    want = fb.se_sums_reference(*ops[:7])
    assert sums.shape == want.shape == (b, plan.n_tiles, ci)
    n = t * h * w
    torch.testing.assert_close(sums.sum(1) / n, want.sum(1) / n, **BF16_TOL)
    assert torch.equal(fb.fused_block_se_sums(*ops[:7]), sums)  # bit-identical rerun


# (B, T, H, W, C, kernel, stride, padding): the stem's temporal conv and the
# strided block-0 conv_b's.
DW = {"stem": (2, 16, 156, 156, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0)),
      **{f"stage{i + 1}_s2": (2, 16, hw, hw, c, (3, 3, 3), (1, 2, 2), (1, 1, 1))
         for i, (hw, c) in enumerate(((156, 54), (78, 108), (39, 216), (20, 432)))}}


@pytest.mark.parametrize("shape", list(DW))
def test_depthwise_kernel_matches_plain_version(cuda, shape):
    b, t, h, w, c, ks, stride, pad = DW[shape]
    x, k = _dw_operands(3, cuda, b, t, h, w, c, ks)
    got = dwc.depthwise_conv3d(x, k, stride=stride, padding=pad)
    want = dwc.depthwise_conv3d_reference(x, k, stride, pad)
    assert got.shape == want.shape
    if shape == "stage3_s2":
        assert got.shape[2:4] == (20, 20)  # 39 -> 20
    _assert_within_two_ulps(got, want)


def test_classify_u8_matches_the_reference_with_every_block_on_its_kernel(cuda):
    from benchmark.benchlib.manifest import Cell
    from benchmark.drivers.closed_classify import (
        build_classifier,
        clips,
        logit_checks,
        reference_logits,
    )
    from benchmark.reference.x3d_kinetics import make_params
    from change3d_tpu_torch.inference import ClipClassifier

    cell = Cell("x3dl-classify-v30")
    cfg, seed = cell.config, 2 ** 31 + 77
    params = make_params(cfg, seed, cuda)
    pool = clips(seed, 4, cfg["frames"], cfg["crop"])
    clf = ClipClassifier(build_classifier(cfg, params, cuda), device=cuda)
    clf.classify_u8(pool)  # the first call builds the kernels
    counters = (fb.fused_block_fwd, fb.fused_block_se_sums, dwc.depthwise_conv3d)
    before = [f.launches for f in counters]
    got = clf.classify_u8(pool)
    # 51 stride-1 blocks fused, 25 of them with SE; the stem and 4 strided
    # conv_b's on the depthwise kernel.
    assert [f.launches - n for f, n in zip(counters, before)] == [51, 25, 5]
    assert got.shape == (4, 400) and got.dtype == np.float32
    checks = logit_checks([(np.arange(4), got)], reference_logits(cfg, params, pool, cuda),
                          cell.limits)
    assert all(c.ok for c in checks), checks
