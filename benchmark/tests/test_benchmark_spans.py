"""The readers of the program's spans (``benchlib/spans.py``,
``metrics/*_ms.*``) on a hand-built slice, and a traced CPU run of the
predict and caption cells at a small size that gives each of them."""

import time
from types import SimpleNamespace

import pytest

from benchmark.benchlib import runner, trace
from benchmark.benchlib.manifest import load_module
from benchmark.benchlib.trace import TraceSummary
from benchmark.tests.conftest import small_cell

SPANS = {"decode_ms.caption": "c3d.caption.decode",
         "decode_step_ms.caption": "c3d.caption.step",
         "decode_wait_ms.caption": "c3d.caption.alive_check",
         "h2d_ms.infer": "c3d.predict.h2d",
         "unpack_ms.infer": "c3d.predict.unpack"}


def _ctx(host, window_us=10_000.0):
    kernels = [("gemm", 0.0, 10.0)]
    return SimpleNamespace(trace=TraceSummary(kernels, host, window_us, 0.0, samples=16))


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_takes_the_mean_of_complete_spans(metric):
    name = SPANS[metric]
    host = [(name, 100.0, 1100.0), ("aten::mm", 150.0, 900.0), (name, 2000.0, 5000.0),
            (name + ".other", 0.0, 9000.0), ("c3d.elsewhere", 200.0, 400.0),
            # Cut by the profiler's stop: it ends at the slice's last instant.
            (name, 9000.0, 10_000.0), (name, 8000.0, 9999.5)]
    read = load_module("metrics", metric).read
    assert read(_ctx(host)) == pytest.approx((1000.0 + 3000.0) / 2 / 1e3)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_gives_none_without_its_span(metric):
    read = load_module("metrics", metric).read
    assert read(_ctx([("aten::mm", 0.0, 100.0), ("c3d.other", 0.0, 50.0)])) is None
    assert read(_ctx([(SPANS[metric], 9000.0, 10_000.0)])) is None
    assert read(SimpleNamespace(trace=None)) is None


def _host_only_summary(prof, samples):
    """The slice as ``trace._summarize`` reduces it, for a CPU run: no
    device events, the host's kept."""
    host = [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events()]
    start, end = min(s for _, s, _ in host), max(e for _, _, e in host)
    return TraceSummary([], host, end - start, start, samples)


@pytest.mark.parametrize("name,metrics", [
    ("bcd-predict-b16", ["h2d_ms.infer", "unpack_ms.infer"]),
    ("cc-caption-b16", ["decode_ms.caption", "decode_step_ms.caption",
                        "decode_wait_ms.caption"]),
])
def test_a_traced_cpu_run_reports_the_span_metrics(name, metrics, monkeypatch):
    monkeypatch.setattr(trace, "_summarize", _host_only_summary)
    cell = small_cell(name)
    result = runner.run(name, 2 ** 31 + 17, 3.0, True, time.perf_counter(), device="cpu",
                        cell=cell)
    assert result["correct"] is True
    got = {m: result["metrics"].get(m, {}).get("value") for m in metrics}
    assert all(v is not None and v > 0 for v in got.values()), got
    if name == "cc-caption-b16":
        # The program's span lies inside the benchmark's around the decode.
        assert got["decode_step_ms.caption"] < got["decode_ms.caption"]
        assert result["metrics"]["caption_decode_ms"]["value"] > 0
