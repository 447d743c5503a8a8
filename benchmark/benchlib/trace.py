"""The traced slice of a run: torch.profiler over a few steady seconds of
the window, reduced to kernel intervals, the device's busy time (the union
of kernel intervals, as the port's ``tools/profile_torch_bcd.py`` takes
it), the top device operations and the longest idle gaps by what the host
was doing. Nothing is written to disk: the events are reduced in memory."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]


def union_length(intervals: List[Interval]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class TraceSummary:
    """Kernel intervals (us, the profiler's clock) of the traced slice, its
    length, and the samples the driver finished inside it."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_us: float, start_us: float,
                 samples: float):
        self.kernels, self.host = kernels, host
        self.window_us, self.start_us, self.samples = window_us, start_us, samples
        self.busy_us = union_length([(s, e) for _, s, e in kernels])

    def kernel_us(self, substring: str) -> float:
        """Summed device time of kernels whose name contains ``substring``."""
        return sum(e - s for n, s, e in self.kernels if substring in n)

    def device_ops(self, top: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], us / 1e6] for n, us in rows]

    def idle_gaps(self, top: int = 10, labelled: int = 256) -> List[list]:
        """Idle time of the ``labelled`` longest gaps, summed by the
        innermost host operation that spans the middle of each gap."""
        import numpy as np

        lo, hi = self.start_us, self.start_us + self.window_us
        found = sorted(gaps([(s, e) for _, s, e in self.kernels], lo, hi),
                       key=lambda g: g[0] - g[1])[:labelled]
        names = [n for n, _, _ in self.host]
        hs = np.array([s for _, s, _ in self.host])
        he = np.array([e for _, _, e in self.host])
        by_host: Dict[str, float] = {}
        for s, e in found:
            mid = 0.5 * (s + e)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            name = (names[inside[np.argmin(he[inside] - hs[inside])]] if len(inside)
                    else "(no host op)")
            by_host[name] = by_host.get(name, 0.0) + (e - s)
        rows = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], us / 1e6] for n, us in rows]


class Tracer:
    """Opens torch.profiler ``lead_s`` into the window for ``slice_s``
    seconds; drivers call :meth:`tick` at step boundaries (or on a clock)
    with the samples finished so far. The events are reduced in
    :meth:`close`, after the window; ``overhead_s`` is the window's time
    spent starting and stopping the profiler. Inactive when ``enabled`` is
    false."""

    def __init__(self, enabled: bool, lead_s: float, slice_s: float):
        self.enabled, self.lead_s, self.slice_s = enabled, lead_s, slice_s
        self._prof = self._stopped = None
        self._t0 = self._samples0 = self._samples = None
        self.done = False
        self.overhead_s = 0.0
        self.summary: Optional[TraceSummary] = None

    def tick(self, now: float, window_start: float, samples: float, sync=None) -> None:
        if not self.enabled or self.done:
            return
        if self._prof is None and now - window_start >= self.lead_s:
            import torch

            if sync:
                sync()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            if sync:
                sync()
            self._t0, self._samples0 = time.perf_counter(), samples
            self.overhead_s += self._t0 - now
        elif self._prof is not None and now - self._t0 >= self.slice_s:
            self._stop(samples, sync)
            self.overhead_s += time.perf_counter() - now

    def _stop(self, samples: float, sync=None) -> None:
        if sync:
            sync()
        self._prof.__exit__(None, None, None)
        self._stopped, self._prof = self._prof, None
        self._samples = samples - self._samples0
        self.done = True

    def close(self) -> None:
        """Stop a profiler the window left open, and reduce the events."""
        if self._prof is not None:
            self._stop(self._samples0)
        if self._stopped is not None:
            self.summary = _summarize(self._stopped, self._samples)
            self._stopped = None


def _summarize(prof, samples: float) -> TraceSummary:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels, host = [], []
    for e in events:
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        (kernels if e.device_type == cuda else host).append(row)
    # Device-side copies of host annotations are not kernels.
    host_names = {n for n, _, _ in host if n.startswith("bench.")}
    kernels = [k for k in kernels if k[0] not in host_names]
    if not kernels:
        raise RuntimeError("the traced slice holds no device events")
    start = min(s for _, s, _ in host + kernels)
    end = max(e for _, _, e in host + kernels)
    return TraceSummary(kernels, host, end - start, start, samples)
