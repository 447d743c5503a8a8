"""The port's profiling (``utils/profiling.py``) on the CPU: the three
``WindowTracer`` cases of the JAX package's tests/test_profiling.py,
mirrored (one window, inert without a logdir, ``close`` ends a short run),
``cli bcd --device cpu --profile_dir`` writing the trace of steps 10-14;
``span`` (its name, nesting, other threads under the all-threads tracer
only); the spans of ``Predictor.predict_u8``, of a caption call and its
decode steps; answers equal with a profiler running; and ``cli serve
--profile_dir`` tracing the server's threads."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from change3d_tpu_torch import cli
from change3d_tpu_torch.client import PredictClient
from change3d_tpu_torch.inference import CaptionPredictor, Predictor
from change3d_tpu_torch.models import caption_decoder as cd
from change3d_tpu_torch.models.trainer import Change3D, Task
from change3d_tpu_torch.models.x3d import X3DConfig
from change3d_tpu_torch.serving import PredictService
from change3d_tpu_torch.train import loop
from change3d_tpu_torch.utils.profiling import WindowTracer, span

from tests._torch_parallel import CC_KW, TINY_CC
from tests.test_torch_cc_predict import WORDS
from tests.test_torch_deploy_serving import Served
from tests.test_torch_train_loop import HW, _argv, data_root, tiny_model  # noqa: F401


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


# -- spans --------------------------------------------------------------------

def _spans(prof, prefix="c3d."):
    """(name, start, end, thread) of the recorded spans, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                   for e in prof.events() if e.name.startswith(prefix)), key=lambda r: r[1])


def _named(spans, name):
    return [r for r in spans if r[0] == name]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_records_its_exact_name_on_the_profiling_thread():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("c3d.test.outer"):
            torch.ones(8).exp()
    (got,) = _spans(prof)
    assert got[0] == "c3d.test.outer" and got[2] > got[1]
    # What the profiler keeps of it: a FUNCTION-scope range on the host.
    (event,) = [e for e in prof.events() if e.name == "c3d.test.outer"]
    assert event.scope == 0 and not event.is_user_annotation
    assert event.device_type == torch.autograd.DeviceType.CPU


def test_a_nested_span_lies_inside_its_parent():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("c3d.test"):
            with span("c3d.test.child"):
                torch.ones(8).sin()
            torch.ones(8).cos()
    spans = _spans(prof)
    (parent,), (child,) = _named(spans, "c3d.test"), _named(spans, "c3d.test.child")
    assert _inside(child, parent) and child[2] - child[1] < parent[2] - parent[1]


def _on_a_worker():
    def work():
        with span("c3d.test.worker"):
            torch.ones(8).exp()

    t = threading.Thread(target=work)
    t.start()
    t.join()


def test_a_worker_thread_span_is_traced_by_the_window_tracer_only(tmp_path):
    tracer = WindowTracer(str(tmp_path), start=0, n=1)
    tracer.tick(0)
    _on_a_worker()
    tracer.close()
    events = json.load(open(tracer.path))["traceEvents"]
    main_tid = threading.get_native_id()
    worker = [e for e in events if e.get("name") == "c3d.test.worker"]
    assert len(worker) == 1 and worker[0]["tid"] != main_tid
    # A profiler that records only the thread that opened it misses it.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _on_a_worker()
    assert _spans(prof) == []


def test_a_span_open_when_tracing_starts_is_left_out(tmp_path):
    """The all-threads tracer starting inside spans, on its own thread and
    on another: neither span raises at its end, and later spans are kept."""
    opened, release = threading.Event(), threading.Event()

    def work():
        with span("c3d.test.worker"):
            opened.set()
            release.wait(timeout=30)

    t = threading.Thread(target=work)
    t.start()
    opened.wait(timeout=30)
    tracer = WindowTracer(str(tmp_path), start=0, n=1)
    with span("c3d.test.main"):
        tracer.tick(0)
    release.set()
    t.join(timeout=30)
    with span("c3d.test.after"):
        torch.ones(8).exp()
    tracer.close()
    names = _event_names(tracer.path)
    assert "c3d.test.after" in names
    assert not {"c3d.test.main", "c3d.test.worker"} & names


@pytest.fixture(scope="module")
def bcd_predictor():
    model = Change3D(Task.BCD, in_height=HW, in_width=HW, backbone_cfg=X3DConfig(**TINY_CC),
                     device="cpu", generator=torch.Generator().manual_seed(3))
    rs = np.random.RandomState(4)
    u8 = tuple(rs.randint(0, 256, (2, HW, HW, 3)).astype(np.uint8) for _ in range(2))
    return Predictor(model, compute_dtype=torch.float32, device="cpu"), u8


def test_predict_u8_spans_on_the_cpu(bcd_predictor):
    """The CPU path runs every stage but the copy back (the masks are on
    the host already): one span each, inside the call's."""
    pred, (pre, post) = bcd_predictor
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.predict_u8(pre, post)
    spans = _spans(prof)
    parts = ("c3d.predict.h2d", "c3d.predict.forward", "c3d.predict.encode",
             "c3d.predict.heads", "c3d.predict.wait", "c3d.predict.unpack")
    assert sorted(r[0] for r in spans) == sorted(("c3d.predict",) + parts)
    (call,), (forward,) = _named(spans, "c3d.predict"), _named(spans, "c3d.predict.forward")
    assert all(_inside(r, call) for r in spans)
    assert all(_inside(r, forward) for r in _named(spans, "c3d.predict.encode")
               + _named(spans, "c3d.predict.heads"))
    # In the order the work runs.
    assert [r[0] for r in spans[1:]] == list(parts)


@pytest.fixture(scope="module")
def cc_predictor():
    """A TINY CC model that never emits <end>: every caption runs the
    whole search."""
    model = Change3D(Task.CC, in_height=32, in_width=32, backbone_cfg=X3DConfig(**TINY_CC),
                     device="cpu", generator=torch.Generator().manual_seed(5), dropout=0.0,
                     **CC_KW)
    with torch.no_grad():
        model.decoder.out_b[WORDS["<end>"]] = -1e4
    rs = np.random.RandomState(6)
    u8 = tuple(rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8) for _ in range(2))
    return CaptionPredictor(model, WORDS, compute_dtype=torch.float32, device="cpu"), u8


def test_a_full_length_decode_holds_one_step_span_a_step(cc_predictor):
    pred, (pre, post) = cc_predictor
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.caption_u8(pre, post)
    spans = _spans(prof)
    steps, checks = _named(spans, "c3d.caption.step"), _named(spans, "c3d.caption.alive_check")
    assert cd.beam_search_decode.steps == cd.MAX_CAPTION_LEN - 1 == len(steps) == 51
    assert len(checks) == 50
    (call,), (decode,) = _named(spans, "c3d.caption"), _named(spans, "c3d.caption.decode")
    assert all(_inside(r, decode) for r in steps + checks) and _inside(decode, call)
    for name in ("c3d.caption.h2d", "c3d.caption.encode", "c3d.caption.detokenize"):
        (part,) = _named(spans, name)
        assert _inside(part, call) and not (decode[1] < part[1] < decode[2])
    # A check waits between two steps.
    for before, check, after in zip(steps, checks, steps[1:]):
        assert before[2] <= check[1] and check[2] <= after[1]


@pytest.mark.parametrize("path", ["predict_u8", "caption_u8"])
def test_answers_equal_with_a_profiler_running(path, bcd_predictor, cc_predictor, tmp_path):
    pred, (pre, post) = bcd_predictor if path == "predict_u8" else cc_predictor
    run = getattr(pred, path)
    plain = run(pre, post)
    tracer = WindowTracer(str(tmp_path), start=0, n=1)
    tracer.tick(0)
    traced = run(pre, post)
    tracer.close()
    assert {"c3d.predict", "c3d.caption"} & _event_names(tracer.path)
    if path == "predict_u8":
        assert plain.keys() == traced.keys()
        for key in plain:
            np.testing.assert_array_equal(plain[key], traced[key])
    else:
        assert plain == traced


def test_cli_serve_profile_dir_traces_every_thread(tmp_path, tiny_model):
    """``cli serve --profile_dir``: batches 10-14 after the warm-up in one
    trace, holding the dispatcher's, the completer's and the handlers'
    spans, each kind on its own threads."""
    run = tmp_path / "run"
    os.makedirs(run / "best")
    model = loop.build_model(loop.RunConfig(in_height=HW, in_width=HW, device="cpu"))
    torch.save(model.state_dict(), str(run / "best" / "model.pt"))
    prof = str(tmp_path / "prof")
    args = cli.build_parser().parse_args(
        ["serve", "--model_task", "bcd", "--checkpoint", str(run), "--in_height", str(HW),
         "--in_width", str(HW), "--batch_size", "2", "--max_delay_ms", "1", "--compute_dtype",
         "float32", "--device", "cpu", "--profile_dir", prof])
    served = Served(cli.build_service(args))
    try:
        client = PredictClient(served.url)
        rs = np.random.RandomState(7)
        for _ in range(16):  # one at a time: one batch each
            pre, post = (rs.randint(0, 256, (HW, HW, 3)).astype(np.uint8) for _ in range(2))
            client.predict_raw(pre, post)
    finally:
        served.close()
    (path,) = _tree_files(prof)
    assert os.path.basename(path).startswith("steps_10-14.")
    events = json.load(open(path))["traceEvents"]
    tids = {name: {e["tid"] for e in events if e.get("name") == name}
            for name in ("c3d.serve.take", "c3d.serve.launch", "c3d.serve.finalize",
                         "c3d.serve.request", "c3d.predict.forward")}
    assert all(tids.values()), tids
    dispatcher = tids["c3d.serve.take"]
    assert tids["c3d.serve.launch"] == tids["c3d.predict.forward"] == dispatcher
    assert not dispatcher & tids["c3d.serve.finalize"]
    assert not (dispatcher | tids["c3d.serve.finalize"]) & tids["c3d.serve.request"]
    assert len([e for e in events if e.get("name") == "c3d.serve.launch"]) == 5


def test_tiled_serving_refuses_profile_dir(bcd_predictor, tmp_path):
    with pytest.raises(ValueError, match="tiled serving has no batcher"):
        PredictService("bcd", bcd_predictor[0], tiled=True, profile_dir=str(tmp_path))
