"""The split design of the bf16 fused block kernels on the card: where a
block's plan takes T-tiles shorter than the clip, ``plan_block`` runs the xa
pass (``fused_block_xa_kernel``: conv_a once per position) and then the
tail (``fused_block_xa_tail_kernel``) on its output, in place of the staged
kernel that recomputes conv_a on every tile's halo. Shapes: X3D-L's
Kinetics stages 3 and 4 (16 x 20^2 in T-tiles of 8; 16 x 10^2 in T-tiles
of 3, the last of one frame, over ragged 4/4/2 tiles), X3D-M's 16-frame
stages 3 and 4 (14^2, 7^2), and X3D-L's stages 1 and 2 on 32 frames, which
take T-tiles of 16 and whose Ci (54, 108) is not a multiple of 8 (xa rows
padded to 56 and 112 channels, w_a's columns copied 4 bytes at a time).

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_cuda_xa.py -q
"""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)  # about two bf16 ulps at max(|ref|, 1)

# (T, H = W, C, Ci, Cr) of the T-tiled block shapes.
SHAPES = {"k400_stage3": (16, 20, 96, 216, 16), "k400_stage4": (16, 10, 192, 432, 32),
          "x3dm_stage3": (16, 14, 96, 216, 16), "x3dm_stage4": (16, 7, 192, 432, 32),
          "t32_stage1": (32, 16, 24, 54, 8), "t32_stage2": (32, 9, 48, 108, 8)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from change3d_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _operands(seed, dev, b, shape, has_se):
    """bf16 operands at model scale (as tests/test_torch_cuda.py's): x >= 0
    (a ReLU output), weights U(+-1/sqrt(fan_in)), BN folds near identity."""
    t, hw, c, ci, cr = shape
    rng = np.random.RandomState(seed)
    g = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    u = lambda fan, *s: g(rng.uniform(-1, 1, s) / np.sqrt(fan))
    n = lambda base, *s: g(base + 0.1 * rng.randn(*s))
    ops = [g(np.abs(rng.randn(b, t, hw, hw, c))).to(torch.bfloat16), u(c, c, ci), n(1, ci),
           n(0, ci), u(27, 3, 3, 3, ci), n(1, ci), n(0, ci), u(ci, ci, c), n(1, c), n(0, c)]
    se = (u(ci, ci, cr), n(0, cr), u(cr, cr, ci), n(0, ci)) if has_se else None
    return ops, se


def _split_at(plan: fb.BlockPlan, t: int, c: int, ck: int) -> fb.BlockPlan:
    """The split design's plan at a staged plan's tiles and chunk width."""
    fwd, sums = fb._split_smem(plan.tt, plan.tile, c, ck, fb.halo_frames(t, plan.tt))
    return plan._replace(ck=ck, smem_fwd=fwd, smem_sums=sums, resident=False, split=True)


def _gate(ops, se, t, hw):
    return fb.se_gate(fb.se_sums_reference(*ops[:7]).sum(1) / (t * hw * hw), *se)


@pytest.mark.parametrize("b", [1, 3, 30])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_equals_the_staged_t_tiled_kernel(cuda, shape, b):
    """The xa pass and the tail give the staged T-tiled kernel's outputs
    bit for bit, fwd (without and with the SE gate) and se-sums: at the
    staged plan's chunks of 16, and at the split plan's own wider chunks
    (multiples of 16, so conv_c's 16-deep K steps group the same
    channels)."""
    t, hw, c, ci, _ = SHAPES[shape]
    split, staged = fb.plan_block(t, hw, hw, c, ci, 2), fb._plan_bf16(t, hw, hw, c, ci)
    assert split.split and not staged.split and staged.tt < t
    assert (split.tt, split.tile, split.n_tiles) == (staged.tt, staged.tile, staged.n_tiles)
    narrow = _split_at(staged, t, c, staged.ck)
    ops, se = _operands(70 + b, cuda, b, SHAPES[shape], True)
    for gate in (None, _gate(ops, se, t, hw)):
        want = fb._launch_fwd(*ops, gate, plan=staged)
        assert torch.equal(fb._launch_fwd(*ops, gate, plan=narrow), want)
        assert torch.equal(fb._launch_fwd(*ops, gate, plan=split), want)
    want = fb._launch_se_sums(*ops[:7], plan=staged)
    assert torch.equal(fb._launch_se_sums(*ops[:7], plan=narrow), want)
    assert torch.equal(fb._launch_se_sums(*ops[:7], plan=split), want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_xa_pass_equals_the_plain_conv_a(cuda, shape):
    """The xa pass's output is the plain version's xa (conv_a, BN_a, ReLU,
    one bf16 rounding) within one bf16 rounding, at every position; the
    channels that pad Ci to a multiple of 8 hold zeros."""
    t, hw, c, ci, _ = SHAPES[shape]
    ops, _ = _operands(80, cuda, 3, SHAPES[shape], False)
    x, w_a, a_a, b_a = fb._front_args(*ops[:7])[:4]
    got = fb._launch_xa(x, w_a, a_a, b_a)
    want = torch.relu(torch.matmul(x.float(), w_a.float()) * a_a + b_a)
    assert got.shape == (3, t, hw, hw, -(-ci // 8) * 8) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got[..., :ci].float(), want, rtol=2 ** -7, atol=1e-5)
    assert not bool(got[..., ci:].any())


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_block_matches_plain_version(cuda, shape, b):
    """The whole block through ``plan_block``'s split plan against the plain
    version, with and without SE; the se-sums rows add up to the plain
    sums and rerun bit-identical."""
    t, hw, c, ci, _ = SHAPES[shape]
    plan = fb.plan_block(t, hw, hw, c, ci, 2)
    assert plan.split
    for has_se in (False, True):
        ops, se = _operands(90 + b, cuda, b, SHAPES[shape], has_se)
        got = fb.fused_bottleneck_block(*ops, se)
        want = fb.fused_block_reference(*ops, se)
        assert got.dtype == torch.bfloat16 and got.shape == ops[0].shape
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    sums = fb.fused_block_se_sums(*ops[:7])
    want = fb.se_sums_reference(*ops[:7])
    assert sums.shape == want.shape == (b, plan.n_tiles, ci)
    n = t * hw * hw
    torch.testing.assert_close(sums.sum(1) / n, want.sum(1) / n, **BF16_TOL)
    assert torch.equal(fb.fused_block_se_sums(*ops[:7]), sums)


def test_split_tail_refuses_a_missing_xa(cuda):
    """The tail runs only on an xa pass's output: a split launch without
    one is refused, not run on garbage."""
    t, hw, c, ci, _ = SHAPES["k400_stage4"]
    plan = fb.plan_block(t, hw, hw, c, ci, 2)
    ops, _ = _operands(95, cuda, 1, SHAPES["k400_stage4"], False)
    lib = fb.cuda_build.load("fused_block")
    args = fb._front_args(*ops[:7])
    sums = torch.empty((1, plan.n_tiles, ci), device=cuda, dtype=torch.float32)
    err = lib.c3d_fused_block_se_sums(
        1, args[0].data_ptr(), sums.data_ptr(), *(a.data_ptr() for a in args[1:]),
        1, t, hw, hw, c, ci, plan.tt, plan.tile, plan.ck, plan.smem_sums, 2, None,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_classifier_logits_equal_the_staged_route(cuda, monkeypatch):
    """``ClipClassifier`` on X3D-L at 16 x 312^2, batch 2: the logits with
    stages 3 and 4 on the split design equal bit for bit those with every
    T-tiled block on the staged kernel, with 51 + 25 launches either way."""
    from benchmark.benchlib.manifest import Cell
    from benchmark.drivers.closed_classify import build_classifier, clips
    from benchmark.reference.x3d_kinetics import make_params
    from change3d_tpu_torch.inference import ClipClassifier

    cfg, seed = Cell("x3dl-classify-v30").config, 2 ** 31 + 97
    clf = ClipClassifier(build_classifier(cfg, make_params(cfg, seed, cuda), cuda), device=cuda)
    pool = clips(seed, 2, cfg["frames"], cfg["crop"])
    launches = (fb.fused_block_fwd, fb.fused_block_se_sums)
    before = [f.launches for f in launches]
    got = clf.classify_u8(pool)
    assert [f.launches - n for f, n in zip(launches, before)] == [51, 25]
    split_shapes = []

    def staged(t, h, w, c, ci, size):
        plan = fb.plan_block(t, h, w, c, ci, size)
        if plan.split:
            split_shapes.append((t, h, c))
            return fb._plan_bf16(t, h, w, c, ci)
        return plan

    with monkeypatch.context() as m:
        m.setattr(fb, "_launch_plan", staged)
        want = clf.classify_u8(pool)
    assert sorted(set(split_shapes)) == [(16, 10, 192), (16, 20, 96)]
    assert got.shape == (2, 400) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
