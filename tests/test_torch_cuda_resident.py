"""The weight-resident design of the bf16 fused block kernels on the card:
X3D-L's stage 3 (C 96, Ci 216, 4 x 4 tiles), where ``plan_block`` routes
both kernels to ``fused_block_resident_kernel``.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py tests/test_torch_cuda_resident.py -q
"""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)  # about two bf16 ulps at max(|ref|, 1)
HW, C, CI, CR = 32, 96, 216, 16  # stage 3 at 256^2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from change3d_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _operands(seed, dev, b, t, has_se, h=HW, w=HW):
    """bf16 stage-3 operands at model scale (as tests/test_torch_cuda.py's)."""
    rng = np.random.RandomState(seed)
    g = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    u = lambda fan, *s: g(rng.uniform(-1, 1, s) / np.sqrt(fan))
    n = lambda base, *s: g(base + 0.1 * rng.randn(*s))
    ops = [g(np.abs(rng.randn(b, t, h, w, C))).to(torch.bfloat16), u(C, C, CI), n(1, CI),
           n(0, CI), u(27, 3, 3, 3, CI), n(1, CI), n(0, CI), u(CI, CI, C), n(1, C), n(0, C)]
    se = (u(CI, CI, CR), n(0, CR), u(CR, CR, CI), n(0, CI)) if has_se else None
    return ops, se


def _staged_at(plan: fb.BlockPlan, c: int = C) -> fb.BlockPlan:
    """The staged design's plan with a resident plan's tiles and chunks: the
    same K order, so the same numbers bit for bit."""
    if not plan.resident:
        return plan
    fwd, sums = fb._bf16_smem(plan.tt, plan.tile, c, plan.ck)
    return plan._replace(smem_fwd=fwd, smem_sums=sums, resident=False)


@pytest.mark.parametrize("b", [1, 3, 16, 32])
@pytest.mark.parametrize("t", [3, 4, 5])
def test_resident_block_matches_plain_version(cuda, t, b):
    """BCD's T = 3, BDA's 4 and SCD's 5 at serving's and CC's batches, with
    and without the SE gate; B = 1 leaves most of the persistent blocks'
    groups without a tile."""
    assert fb.plan_block(t, HW, HW, C, CI, 2).resident
    for has_se in (False, True):
        ops, se = _operands(20 + t, cuda, b, t, has_se)
        got = fb.fused_bottleneck_block(*ops, se)
        want = fb.fused_block_reference(*ops, se)
        assert got.dtype == torch.bfloat16 and got.shape == ops[0].shape
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("t", [3, 4, 5])
def test_resident_equals_the_staged_kernel(cuda, t):
    """The two designs on the same operands. Where they walk Ci in the same
    chunks (T = 3: 112, T = 4: 72) they feed the mma the same fragments in
    the same K order: bit-equal. At T = 5 the resident plan takes 5 chunks
    of 48 (56 does not fit with the weights), the staged one 4 of 56: conv_c's
    16-deep K steps group other channels, so fwd agrees to the plain
    version's tolerance, and bit for bit with the staged kernel run at 48.
    The se-sums never reach conv_c: bit-equal at every T."""
    resident, staged = fb.plan_block(t, HW, HW, C, CI, 2), fb._plan_bf16(t, HW, HW, C, CI)
    assert resident.resident and not staged.resident
    assert (resident.ck == staged.ck) == (t != 5)
    ops, se = _operands(30 + t, cuda, 8, t, True)
    gate = fb.se_gate(fb.se_sums_reference(*ops[:7]).sum(1) / (t * HW * HW), *se)
    got = fb._launch_fwd(*ops, gate, plan=resident)
    if resident.ck == staged.ck:
        assert torch.equal(got, fb._launch_fwd(*ops, gate, plan=staged))
    else:
        torch.testing.assert_close(got.float(), fb._launch_fwd(*ops, gate, plan=staged).float(),
                                   **BF16_TOL)
    assert torch.equal(got, fb._launch_fwd(*ops, gate, plan=_staged_at(resident)))
    sums = fb._launch_se_sums(*ops[:7], plan=resident)
    assert torch.equal(sums, fb._launch_se_sums(*ops[:7], plan=staged))


@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("b", [1, 16])
def test_resident_se_sums_add_up_and_rerun_bit_identical(cuda, t, b):
    """[B, n_tiles, Ci] rows in the plain version's tile order, adding up to
    its sums; no atomics, so reruns are bit-identical."""
    ops, _ = _operands(40 + t, cuda, b, t, False)
    sums = fb.fused_block_se_sums(*ops[:7])
    want = fb.se_sums_reference(*ops[:7])
    assert sums.shape == want.shape == (b, fb.plan_block(t, HW, HW, C, CI, 2).n_tiles, CI)
    n = t * HW * HW
    torch.testing.assert_close(sums.sum(1) / n, want.sum(1) / n, **BF16_TOL)
    assert torch.equal(fb.fused_block_se_sums(*ops[:7]), sums)


def test_resident_block_over_ragged_tiles(cuda):
    """10 x 6 pixels under 4 x 4 tiles (the last row and column of tiles
    hang over the edges), T = 4: every block's groups meet tiles that end
    early."""
    assert fb.plan_block(4, 10, 6, C, CI, 2).resident
    ops, se = _operands(50, cuda, 3, 4, True, h=10, w=6)
    got = fb.fused_bottleneck_block(*ops, se)
    torch.testing.assert_close(got.float(), fb.fused_block_reference(*ops, se).float(),
                               **BF16_TOL)


def test_resident_kernel_takes_the_card_of_its_tensors(cuda):
    """The persistent grid counts the SMs of x's card; with two cards the
    operands sit on the second while the first is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    second = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    ops, se = _operands(60, second, 4, 3, True)
    got = fb.fused_bottleneck_block(*ops, se)
    torch.cuda.synchronize(second)
    assert got.device == second and torch.cuda.current_device() == 0
    torch.testing.assert_close(got.float(), fb.fused_block_reference(*ops, se).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("cell", ["bcd-predict-b16", "scd-predict-b16"])
def test_full_width_predictor_matches_plain_forward(cuda, cell, monkeypatch):
    """A full-width BCD (T = 3) and SCD (T = 5) model through
    ``Predictor.predict_u8`` (bf16, stage 3 on the resident kernels) as the
    benchmark's cell builds it (its seeded weights and uint8 256^2 pairs, 2
    batches of 4): the served maps pass the cell's own check against the
    plain fp32 reference forward (``driver.check()``: the gaps of
    ``limits/<cell>.json``), and equal bit for bit the same forward with
    stage 3 on the staged kernels at the same chunks."""
    from benchmark.benchlib.manifest import Cell
    from benchmark.benchlib.trace import Tracer

    spec = Cell(cell)
    spec.traffic.update(batch=4, pool=8, batches=2)
    t = 2 + spec.config["perception_frames"]  # pre, perception frames, post
    assert fb.plan_block(t, HW, HW, C, CI, 2).resident
    driver = spec.driver().Driver(spec, 2 ** 31 + 11, "cuda")
    driver.window(0.0, Tracer(False, 0.0, 0.0))
    checks = driver.check()
    assert checks and all(c.ok for c in checks), checks
    for ids, got in driver.answers:
        with monkeypatch.context() as m:
            m.setattr(fb, "_launch_plan",
                      lambda t, h, w, c, ci, size: _staged_at(fb.plan_block(t, h, w, c, ci, size), c))
            staged = driver.predictor.predict_u8(driver.pre[ids], driver.post[ids])
        if not isinstance(got, dict):  # the BCD driver keeps the change mask alone
            got = {"change": got}
        assert set(got) <= set(staged)
        for key in got:
            np.testing.assert_array_equal(got[key], staged[key])
