"""fused_xa_share.classify: the split design's share of the fused blocks'
device time (the xa pass and the tail on its output), on made-up traced
slices."""

from types import SimpleNamespace

import pytest

from benchmark.benchlib.manifest import load_module
from benchmark.benchlib.trace import TraceSummary

NAME = "fused_xa_share.classify"
XA = "void_(anonymous_namespace)::fused_block_xa_kernel(Params)"
TAIL = "void_(anonymous_namespace)::fused_block_xa_tail_kernel<false, 16, 4, 4>(Params)"
STAGED = "void_(anonymous_namespace)::fused_block_bf16_kernel<false, 16, 4, false>(Params)"


def _read(kernels):
    trace = None if kernels is None else TraceSummary(kernels, [], 1000.0, 0.0, samples=30)
    return load_module("metrics", NAME).read(SimpleNamespace(trace=trace))


def test_share_of_the_fused_block_time():
    kernels = [(XA, 0.0, 5.0), (TAIL, 5.0, 35.0), ("gemm", 35.0, 200.0),
               (STAGED, 200.0, 260.0), (TAIL.replace("false, 16", "true, 1"), 300.0, 305.0)]
    share = _read(kernels)
    assert share == pytest.approx(100.0 * 40.0 / 100.0)
    assert 0.0 < share < 100.0


def test_zero_without_the_split_kernels():
    assert _read([(STAGED, 0.0, 50.0), ("gemm", 50.0, 80.0)]) == 0.0
    resident = "void_(anonymous_namespace)::fused_block_resident_kernel<false, 8>(Params)"
    assert _read([(resident, 0.0, 50.0)]) == 0.0


def test_all_split_and_none_without_a_trace():
    assert _read([(XA, 0.0, 10.0), (TAIL, 10.0, 50.0)]) == pytest.approx(100.0)
    assert _read(None) is None
    assert _read([("gemm", 0.0, 10.0)]) is None  # no fused block kernel to share
