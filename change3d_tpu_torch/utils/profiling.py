"""Profiling: ``torch.profiler`` traces and the port's spans (counterpart of
``change3d_tpu/utils/profiling.py``).

- ``WindowTracer(logdir, start, n)`` traces one window of steps
  (``cli bcd|scd|bda|cc --profile_dir``: training steps 10-14; ``cli serve
  --profile_dir``: served batches 10-14, counted after the warm-up);
- ``span(name)`` marks a stretch of host work in every trace.

A trace records CPU activity on every thread of the process (the loader's,
the server's handler, dispatcher and completer threads, not only the one
that opened it), and CUDA activity (kernels, copies) when a card is in use:
``device`` names it, or, left None, CUDA counts as in use once this process
has initialised it. Each trace is written as one Chrome-trace file,
``<logdir>/<label>.<pid>.pt.trace.json``, which chrome://tracing, Perfetto
and TensorBoard's profiler plugin read.

Spans are named ``c3d.<layer>[.<part>]`` with fixed strings (never a
request's or a batch's own name); a span nested in another carries its
parent's name as its prefix where it is a part of that work, as
``c3d.predict.h2d`` of ``c3d.predict``. The layers: ``c3d.predict``
(``Predictor.predict_u8``; its ``.forward`` holds ``.encode``, the
encoder, and ``.heads``, the detection heads with the hardening, for every
detection task), ``c3d.caption`` (``CaptionPredictor``'s captions and
``beam_search_decode``), ``c3d.classify`` (``ClipClassifier.classify_u8``:
``.h2d``, then ``.forward`` holding ``.encode``, the stem and stages, and
``.head``, then ``.d2h``), ``c3d.serve`` (the server's threads).
A span is a FUNCTION-scope ``RecordFunction`` range, as an aten op is: it
shares the trace's clock with the kernels, adds no device event, and costs
about a microsecond when no profiler runs. (``record_function`` opens a
user annotation instead, which a CUDA trace copies as a device event, and
costs about 12 microseconds.) No span sits inside a model's ``forward`` or in
anything ``torch.export`` traces.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile


def _activities(device) -> list:
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available() and torch.cuda.is_initialized())
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


class span:
    """``with span(name):`` records the enclosed host work as ``name`` in
    any running trace (see the module docstring for the names).

    A profiler that starts while a span is open (on its own thread, or on
    any thread once it records them all) holds no record of the span's
    start and refuses its end; that span is left out of the trace, and the
    work goes on."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = _RecordFunctionFast(name)

    def __enter__(self) -> None:
        self._range.__enter__()

    def __exit__(self, *exc) -> None:
        try:
            self._range.__exit__(*exc)
        except RuntimeError:  # the profiler started inside the span
            pass


def _start(device) -> profile:
    prof = profile(activities=_activities(device),
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    return prof


def _write(prof: profile, logdir: str, label: str) -> str:
    """Stop ``prof`` once the device has run what was queued, and write its
    trace into ``logdir``; returns the path."""
    if ProfilerActivity.CUDA in prof.activities:
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{label}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


class WindowTracer:
    """Trace a fixed window of steps (training steps, served batches) into
    ``logdir``.

    ``tick(i)`` before step ``i`` starts the trace at ``start`` and stops it
    at ``start + n``, so steps [start, start + n) are captured and the first
    steps (kernel builds, allocator warm-up) are not. One window per run;
    inert when ``logdir`` is falsy. ``close()`` stops a window the loop
    never finished (short epochs, exceptions). ``path`` is the trace file
    once written."""

    def __init__(self, logdir: Optional[str], start: int = 10, n: int = 5, device=None):
        self.logdir = logdir
        self.start = start
        self.end = start + n
        self.device = device
        self.path: Optional[str] = None
        self._prof: Optional[profile] = None
        self._done = False

    def tick(self, i: int) -> None:
        if not self.logdir or self._done:
            return
        if self._prof is None and i >= self.start:
            self._prof = _start(self.device)
        elif self._prof is not None and i >= self.end:
            self._stop()

    def _stop(self) -> None:
        self.path = _write(self._prof, self.logdir, f"steps_{self.start}-{self.end - 1}")
        self._prof = None
        self._done = True

    def close(self) -> None:
        if self._prof is not None:
            self._stop()
