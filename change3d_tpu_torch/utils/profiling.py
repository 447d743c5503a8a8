"""Profiling: ``torch.profiler`` traces and step timing (counterpart of
``change3d_tpu/utils/profiling.py``).

- ``trace_context(logdir)`` traces a region into ``logdir``;
- ``WindowTracer(logdir, start, n)`` traces one window of training steps
  (``cli bcd|scd|bda|cc --profile_dir``);
- ``StepTimer`` measures steady-state step time, synchronising the device
  the step's result lives on.

A trace records CPU activity always, and CUDA activity (kernels, copies)
when a card is in use: ``device`` names it, or, left None, CUDA counts as in
use once this process has initialised it. Each trace is written as one
Chrome-trace file, ``<logdir>/<label>.<pid>.pt.trace.json``, which
chrome://tracing, Perfetto and TensorBoard's profiler plugin read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile


def _activities(device) -> list:
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available() and torch.cuda.is_initialized())
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def _start(device) -> profile:
    prof = profile(activities=_activities(device))
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


@contextlib.contextmanager
def trace_context(logdir: Optional[str], device=None):
    """Trace the enclosed region into ``logdir`` (inert when it is falsy)."""
    if not logdir:
        yield
        return
    prof = _start(device)
    try:
        yield
    finally:
        _write(prof, logdir, "trace")


class WindowTracer:
    """Trace a fixed window of training steps into ``logdir``.

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


def _sync(result) -> None:
    """Wait for the device of the first tensor in ``result`` (a tensor, or
    a dict / list / tuple holding tensors)."""
    leaves = torch.utils._pytree.tree_leaves(result)
    tensor = next((x for x in leaves if isinstance(x, torch.Tensor)), None)
    if tensor is not None and tensor.device.type == "cuda":
        torch.cuda.synchronize(tensor.device)


class StepTimer:
    """Mean step time after ``warmup`` steps: ``start()`` before a step,
    ``stop(result)`` after it (waits for ``result``'s device first)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            _sync(result)
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return dt

    @property
    def mean_step_time(self) -> float:
        n = max(self.count - self.warmup, 1)
        return self.total / n
