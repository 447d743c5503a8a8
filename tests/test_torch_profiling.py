"""The port's profiling (``utils/profiling.py``) on the CPU: the three
``WindowTracer`` cases of the JAX package's tests/test_profiling.py,
mirrored (one window, inert without a logdir, ``close`` ends a short run),
``trace_context``, ``StepTimer``, and ``cli bcd --device cpu --profile_dir``
writing the trace of steps 10-14."""

import json
import os

import torch

from change3d_tpu_torch import cli
from change3d_tpu_torch.utils.profiling import StepTimer, WindowTracer, trace_context

from tests.test_torch_train_loop import _argv, data_root, tiny_model  # noqa: F401


def _tree_files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]


def _event_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_window_tracer_captures_one_window(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.ones(128)
    tracer = WindowTracer(logdir, start=2, n=2)
    for i in range(6):
        tracer.tick(i)
        float(torch.sum(x * x))
    tracer.close()
    assert _tree_files(logdir) == [tracer.path], "one trace file"
    assert "aten::mul" in _event_names(tracer.path)
    # One window only: later ticks past the window must not restart it.
    tracer.tick(10)
    assert tracer._done and tracer._prof is None
    assert len(_tree_files(logdir)) == 1


def test_window_tracer_inert_without_logdir():
    tracer = WindowTracer(None)
    for i in range(20):
        tracer.tick(i)
    tracer.close()  # no-op
    assert tracer.path is None and not tracer._done


def test_window_tracer_close_stops_short_run(tmp_path):
    logdir = str(tmp_path / "trace")
    tracer = WindowTracer(logdir, start=0, n=100)
    tracer.tick(0)  # window opens, run ends before it fills
    float(torch.ones(()) + 1)
    tracer.close()
    assert tracer._done
    assert _tree_files(logdir) == [tracer.path]


def test_trace_context_and_step_timer(tmp_path):
    logdir = str(tmp_path / "ctx")
    with trace_context(logdir, device="cpu"):
        torch.ones(4).exp()
    (path,) = _tree_files(logdir)
    assert path.endswith(".pt.trace.json") and "aten::exp" in _event_names(path)
    with trace_context(None):  # inert
        pass
    timer = StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop({"loss": torch.ones(2).sum()})
    assert timer.count == 3 and timer.mean_step_time > 0


def test_cli_bcd_profile_dir_writes_the_window(data_root, tmp_path, tiny_model):
    """16 train pairs at batch 1: steps 10-14 of epoch 0 are traced, and
    the trace holds the train step's ops."""
    prof = str(tmp_path / "prof")
    argv = [a if a != "8" else "1" for a in _argv(data_root, str(tmp_path / "run"), 1)]
    cli.main(argv + ["--profile_dir", prof])
    (path,) = _tree_files(prof)
    assert os.path.basename(path).startswith("steps_10-14.")
    names = _event_names(path)
    assert "aten::mm" in names or "aten::matmul" in names
