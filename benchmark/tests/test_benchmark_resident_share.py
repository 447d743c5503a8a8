"""fused_resident_share.*: the weight-resident fused block kernels' share
of the fused blocks' device time, on made-up traced slices."""

from types import SimpleNamespace

import pytest

from benchmark.benchlib.manifest import load_module
from benchmark.benchlib.trace import TraceSummary

NAMES = ("fused_resident_share.scd", "fused_resident_share.infer")
RESIDENT = "void_(anonymous_namespace)::fused_block_resident_kernel<false, 8>(Params)"
STAGED = "void_(anonymous_namespace)::fused_block_bf16_kernel<false, 16, 4, false>(Params)"


def _read(name, kernels):
    trace = None if kernels is None else TraceSummary(kernels, [], 1000.0, 0.0, samples=16)
    return load_module("metrics", name).read(SimpleNamespace(trace=trace))


@pytest.mark.parametrize("name", NAMES)
def test_share_of_the_fused_block_time(name):
    kernels = [(RESIDENT, 0.0, 30.0), ("gemm", 30.0, 200.0), (STAGED, 200.0, 260.0),
               (RESIDENT.replace("false, 8", "true, 1"), 300.0, 310.0)]
    share = _read(name, kernels)
    assert share == pytest.approx(100.0 * 40.0 / 100.0)
    assert 0.0 < share < 100.0


@pytest.mark.parametrize("name", NAMES)
def test_zero_without_resident_kernels_none_without_a_trace(name):
    assert _read(name, [(STAGED, 0.0, 50.0), ("gemm", 50.0, 80.0)]) == 0.0
    assert _read(name, [(RESIDENT, 0.0, 50.0)]) == pytest.approx(100.0)
    assert _read(name, None) is None
    assert _read(name, [("gemm", 0.0, 10.0)]) is None  # no fused block kernel to share
