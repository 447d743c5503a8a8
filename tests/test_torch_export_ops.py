"""The fused-block kernels as ``torch.library`` custom ops on the CPU:
``torch.library.opcheck`` on ``c3d::fused_block_fwd`` and
``c3d::fused_block_se_sums`` (schema, fake kernel, autograd registration,
AOT dispatch) in fp32 and bf16, with and without the SE gate; the public
wrappers equal the plain versions exactly; the ops run under
``torch.inference_mode`` (the Predictor's and the server's mode) without
counting a launch; and ``torch.export`` of a block keeps each op as one
graph node at a symbolic batch, with the fake shape from the tile plan."""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import fused_block as fb


def _operands(dtype, b=2, t=3, h=8, w=8, c=8, ci=20):
    rs = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy((rs.randn(*s) * 0.2).astype(np.float32))
    ops = [f(b, t, h, w, c).to(dtype), f(c, ci), f(ci) + 1.0, f(ci), f(3, 3, 3, ci),
           f(ci) + 1.0, f(ci), f(ci, c), f(c) + 1.0, f(c)]
    return ops, torch.sigmoid(f(b, ci))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("has_se", [False, True], ids=["plain", "se"])
def test_opcheck_both_ops(dtype, has_se):
    ops, gate = _operands(dtype)
    torch.library.opcheck(torch.ops.c3d.fused_block_fwd.default,
                          (*ops, gate if has_se else None))
    torch.library.opcheck(torch.ops.c3d.fused_block_se_sums.default, tuple(ops[:7]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ops_equal_plain_versions_under_inference_mode(dtype):
    ops, gate = _operands(dtype)
    before = (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches)
    with torch.inference_mode():
        got = fb.fused_block_fwd(*ops, gate)
        sums = fb.fused_block_se_sums(*ops[:7])
        assert got.is_inference() and got.dtype == dtype
    assert torch.equal(got, fb.fused_block_fwd_reference(*ops, gate))
    assert torch.equal(sums, fb.se_sums_reference(*ops[:7]))
    assert (fb.fused_block_fwd.launches, fb.fused_block_se_sums.launches) == before


class _Block(torch.nn.Module):
    def __init__(self, ops, se):
        super().__init__()
        self.ops = [torch.nn.Parameter(o, requires_grad=False) for o in ops[1:]]
        self.se = tuple(se)

    def forward(self, x):
        return fb.fused_bottleneck_block(x, *self.ops, self.se)


def test_export_keeps_one_node_per_launch_at_a_symbolic_batch():
    ops, _ = _operands(torch.float32, b=3, h=12, w=10)
    rs = np.random.RandomState(1)
    se = [torch.from_numpy((rs.randn(*s) * 0.3).astype(np.float32))
          for s in ((20, 8), (8,), (8, 20), (20,))]
    block = _Block(ops, se)
    with torch.no_grad():
        program = torch.export.export(block, (ops[0],),
                                      dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.c3d.fused_block_fwd.default) == 1
    assert targets.count(torch.ops.c3d.fused_block_se_sums.default) == 1
    sums = next(n for n in program.graph.nodes
                if n.target == torch.ops.c3d.fused_block_se_sums.default)
    n_tiles = fb.plan_tiles(3, 12, 10, 8, 20, 4)[4]
    assert not isinstance(sums.meta["val"].shape[0], int)  # the batch stays symbolic
    assert tuple(sums.meta["val"].shape[1:]) == (n_tiles, 20)
    x5 = torch.from_numpy(rs.randn(5, 3, 12, 10, 8).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(program.module()(x5), block(x5))
