"""The port's fused X3D block: plain PyTorch version vs the three Pallas
functions of change3d_tpu (interpret mode on the CPU), the CPU dispatch of
the kernel wrappers, and the tile planner. The CUDA kernels are tested on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from change3d_tpu.ops.pallas.fused_block import (
    fused_bottleneck_block as jax_full,
    fused_bottleneck_block_htiled as jax_htiled,
    fused_bottleneck_block_jtiled as jax_jtiled,
)
from change3d_tpu_torch.ops import fused_block as fb


def _operands(seed, b, t, h, w, c, ci, cr, has_se):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)
    ops = [f(b, t, h, w, c), f(c, ci), f(ci) * 0.1 + 1.0, f(ci) * 0.1, f(3, 3, 3, ci),
           f(ci) * 0.1 + 1.0, f(ci) * 0.1, f(ci, c), f(c) * 0.1 + 1.0, f(c) * 0.1]
    se = (f(ci, cr), f(cr), f(cr, ci), f(ci)) if has_se else None
    return ops, se


def _torch(ops, se):
    t = [torch.from_numpy(a) for a in ops]
    return t, None if se is None else tuple(torch.from_numpy(a) for a in se)


def _jax(ops, se):
    return [jnp.asarray(a) for a in ops], None if se is None else tuple(jnp.asarray(a) for a in se)


@pytest.mark.parametrize("has_se", [False, True])
def test_reference_matches_pallas_full(has_se):
    ops, se = _operands(0, 2, 3, 8, 8, 16, 36, 8, has_se)
    want = np.asarray(jax_full(*_jax(ops, se)[0], _jax(ops, se)[1], interpret=True))
    got = fb.fused_block_reference(*_torch(ops, se)[0], _torch(ops, se)[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("variant", ["htiled", "jtiled"])
@pytest.mark.parametrize("h_tile", [4, 8])
@pytest.mark.parametrize("has_se", [False, True])
def test_reference_matches_pallas_tiled(variant, h_tile, has_se):
    ops, se = _operands(1, 2, 3, 16, 8, 12, 20, 8, has_se)
    fn = jax_htiled if variant == "htiled" else jax_jtiled
    jops, jse = _jax(ops, se)
    want = np.asarray(fn(*jops, jse, h_tile=h_tile, interpret=True))
    tops, tse = _torch(ops, se)
    got = fb.fused_block_reference(*tops, tse).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("has_se", [False, True])
def test_wrapper_on_cpu_takes_plain_version_without_counting(has_se):
    ops, se = _operands(2, 2, 3, 8, 8, 8, 20, 8, has_se)
    tops, tse = _torch(ops, se)
    before = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
    got = fb.fused_bottleneck_block(*tops, tse)
    gate = None
    if has_se:  # the card's data flow: per-tile sums -> gate -> fwd
        gate = fb.se_gate(fb.se_sums_reference(*tops[:7]).sum(1) / (3 * 8 * 8), *tse)
    assert torch.equal(got, fb.fused_block_fwd_reference(*tops, gate))
    assert (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches) == before


def test_split_plain_versions_compose_to_the_block():
    """fwd(gate from se_sums) == the whole block: the CUDA path's data flow."""
    ops, se = _operands(3, 3, 3, 8, 8, 8, 20, 8, True)
    tops, tse = _torch(ops, se)
    sums = fb.fused_block_se_sums(*tops[:7])
    _, _, _, _, n_tiles = fb.plan_tiles(3, 8, 8, 8, 20, 4)
    assert sums.shape == (3, n_tiles, 20) and sums.dtype == torch.float32
    gate = fb.se_gate(sums.sum(1) / (3 * 8 * 8), *tse)
    got = fb.fused_block_fwd(*tops, gate)
    torch.testing.assert_close(got, fb.fused_block_reference(*tops, tse), rtol=1e-5, atol=1e-5)


def test_plain_se_sums_are_row_major_tiles():
    """Row k of the plain sums is tile (k // tiles_w, k % tiles_w), as the
    kernel writes it; tiles that hang over the edge sum what lies inside."""
    ops, _ = _operands(5, 2, 3, 20, 12, 8, 20, 8, False)
    tops, _ = _torch(ops, None)
    sums = fb.se_sums_reference(*tops[:7])
    tile, _, _, _, n_tiles = fb.plan_tiles(3, 20, 12, 8, 20, 4)
    xb = fb._front_reference(*tops[:7])
    tiles_w = -(-12 // tile)
    assert sums.shape == (2, n_tiles, 20)
    for k in range(n_tiles):
        y0, x0 = (k // tiles_w) * tile, (k % tiles_w) * tile
        want = xb[:, :, y0:y0 + tile, x0:x0 + tile].sum(dim=(1, 2, 3))
        torch.testing.assert_close(sums[:, k], want, rtol=1e-5, atol=1e-5)


def test_reference_bf16_rounds_like_pallas():
    """bf16 in, bf16 out, against the Pallas kernel in bf16."""
    ops, se = _operands(4, 1, 3, 8, 8, 16, 36, 8, True)
    jops, jse = _jax(ops, se)
    jops[0] = jops[0].astype(jnp.bfloat16)
    want = np.asarray(jax_full(*jops, jse, interpret=True).astype(jnp.float32))
    tops, tse = _torch(ops, se)
    tops[0] = tops[0].to(torch.bfloat16)
    got = fb.fused_block_reference(*tops, tse)
    assert got.dtype == torch.bfloat16
    # about two bf16 ulps at max(|ref|, 1): sums run in another order on each side
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize(
    "shape", [(128, 24, 54), (64, 48, 108), (32, 96, 216), (16, 192, 432)],
    ids=["stage1", "stage2", "stage3", "stage4"],
)
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
def test_plan_fits_shared_memory_and_covers_the_image(shape, itemsize):
    hw, c, ci = shape
    tile, ck, smem_fwd, smem_sums, n_tiles = fb.plan_tiles(3, hw, hw, c, ci, itemsize)
    resident = fb.plan_block(3, hw, hw, c, ci, itemsize).resident  # stage 3 in bf16
    assert smem_sums < smem_fwd <= (fb.SMEM_RESIDENT if resident else fb.SMEM_TARGET)
    assert min(ci, fb.MIN_CHUNK) <= ck <= ci
    assert n_tiles * tile * tile >= hw * hw and n_tiles == (-(-hw // tile)) ** 2
