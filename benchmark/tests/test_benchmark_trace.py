"""The reduction of a traced slice and the per-layer readers, on made-up
events; the profiler itself on the card (marked ``cuda``)."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.benchlib.manifest import load_module
from benchmark.benchlib.trace import TraceSummary, Tracer, gaps, union_length
from benchmark.work.peaks import H100


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert union_length(spans) == 4
    assert gaps(spans, 0, 8) == [(3, 5), (6, 8)]
    assert gaps([], 1, 2) == [(1, 2)]


def _summary():
    kernels = [("fused_block_bf16_kernel", 0.0, 100.0), ("gemm", 150.0, 200.0),
               ("fused_block_bf16_kernel", 300.0, 400.0)]
    host = [("bench.step", 0.0, 1000.0), ("cudaDeviceSynchronize", 400.0, 1000.0),
            ("aten::conv3d", 100.0, 300.0)]
    return TraceSummary(kernels, host, 1000.0, 0.0, samples=16)


def test_summary_breakdown():
    s = _summary()
    assert s.busy_us == 250.0 and s.kernel_us("fused_block") == 200.0
    assert s.device_ops() == [["fused_block_bf16_kernel", 200e-6], ["gemm", 50e-6]]
    # Gaps 100-150 and 200-300 fall in aten::conv3d, 400-1000 in the sync.
    assert s.idle_gaps() == [["cudaDeviceSynchronize", 600e-6], ["aten::conv3d", 150e-6]]


def test_readers():
    s = _summary()
    ctx = SimpleNamespace(trace=s, spans={"caption_decode": [0.2, 0.3]},
                          counters={"batches": 4, "batched_requests": 30},
                          work={"flops": H100["bf16_flops_per_s"] * 0.01,
                                "fused_least_s_per_sample": 1e-6},
                          samples=16, seconds=2.5, overhead_s=0.5)
    read = lambda name: load_module("metrics", name).read(ctx)
    assert read("device_idle.infer") == pytest.approx(75.0)
    assert read("mfu.infer") == pytest.approx(0.5)
    assert read("fused_block_roofline.infer") == pytest.approx(100.0 * 16 / 200)
    assert read("caption_decode_ms") == pytest.approx(250.0)
    assert read("batch_fill.serve") == 7.5
    empty = SimpleNamespace(trace=None, spans={}, counters={}, work={}, samples=0, seconds=0,
                            overhead_s=0)
    assert all(load_module("metrics", n).read(empty) is None for n in (
        "device_idle.serve", "mfu.infer", "fused_block_roofline.infer",
        "caption_decode_ms", "batch_fill.serve"))


def test_tracer_off_does_nothing():
    t = Tracer(False, 0.0, 1.0)
    t.tick(time.perf_counter(), 0.0, 10)
    assert t.summary is None and not t.done


@pytest.mark.cuda
def test_tracer_reads_kernels_on_the_card(card):
    t, x = Tracer(True, 0.0, 0.2), torch.randn(1024, 1024, device="cuda")
    t0, n = time.perf_counter(), 0
    while not t.done:
        x = x @ x / 1024
        n += 1
        t.tick(time.perf_counter(), t0, n, torch.cuda.synchronize)
    t.close()
    s = t.summary
    assert 0 < s.busy_us <= s.window_us and s.samples > 0 and s.device_ops()
