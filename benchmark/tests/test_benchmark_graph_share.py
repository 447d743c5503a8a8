"""The reader of ``decode_graph_share.caption`` on hand-built slices: the
share of complete ``c3d.caption.step`` spans that hold a complete
``c3d.caption.replay`` span."""

from types import SimpleNamespace

import pytest

from benchmark.benchlib.manifest import load_module
from benchmark.benchlib.trace import TraceSummary

STEP, REPLAY = "c3d.caption.step", "c3d.caption.replay"


def _read(host, window_us=10_000.0):
    ctx = SimpleNamespace(trace=TraceSummary([("gemm", 0.0, 10.0)], host, window_us, 0.0,
                                             samples=16))
    return load_module("metrics", "decode_graph_share.caption").read(ctx)


def _steps(n, replayed):
    """n steps of 100 us each 200 us apart, the first ``replayed`` holding
    a replay, each with the host's other work beside it."""
    host = []
    for i in range(n):
        s = 100.0 + 200.0 * i
        host += [(STEP, s, s + 100.0), ("c3d.caption.alive_check", s - 50.0, s - 10.0)]
        if i < replayed:
            host.append((REPLAY, s + 10.0, s + 90.0))
        else:
            host.append(("aten::mm", s + 10.0, s + 90.0))
    return host


def test_every_step_replayed_reads_100():
    assert _read(_steps(40, 40)) == pytest.approx(100.0)


def test_share_counts_steps_that_hold_a_replay():
    assert _read(_steps(40, 10)) == pytest.approx(25.0)
    # A replay outside every step, and one of a step cut by the profiler's stop.
    host = _steps(4, 4) + [(REPLAY, 5000.0, 5050.0), (STEP, 9900.0, 10_000.0),
                           (REPLAY, 9910.0, 9950.0)]
    assert _read(host) == pytest.approx(100.0)
    host = _steps(4, 2) + [(STEP, 6000.0, 6100.0), (REPLAY, 6050.0, 6200.0)]
    assert _read(host) == pytest.approx(40.0)


def test_none_without_steps_or_replays():
    assert _read([("aten::mm", 0.0, 100.0), (REPLAY, 10.0, 20.0)]) is None
    assert _read(_steps(40, 0)) is None  # a program that replays no graph
    assert _read([(STEP, 9000.0, 10_000.0), (REPLAY, 9100.0, 9200.0)]) is None
    assert load_module("metrics", "decode_graph_share.caption").read(
        SimpleNamespace(trace=None)) is None
