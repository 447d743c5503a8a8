"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

A driver module (``drivers/<name>.py``, named by the traffic file) gives a
``Driver(cell, seed, device, variant=None)`` whose constructor is the
set-up (weights from the seed, the program built, every shape of the
traffic warmed up), and whose methods are ``window(seconds, tracer)`` ->
``Window``, ``release()`` (free the program's state) and ``check()`` ->
the numbers compared, each with its limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional

from benchmark.benchlib.manifest import BENCH_DIR, Cell
from benchmark.benchlib.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "change3d_tpu")
# The traced slice: opens this far into the window and lasts this long
# (shorter windows get a third of their length each).
TRACE_LEAD_S, TRACE_SLICE_S = 2.0, 2.0


class Check(NamedTuple):
    """A number compared, its limit, and whether it holds (value <= limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


class Window(NamedTuple):
    """What a measured window did: requests (or samples) attempted and
    failed, the cell's end-to-end metrics, and what the per-layer readers
    take (samples and seconds of the window, spans, counters, work)."""

    attempted: int
    failed: int
    metrics: Dict[str, float]
    samples: float
    seconds: float
    spans: Dict[str, List[float]]
    counters: Dict[str, float]
    work: Dict[str, float]


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port's nvcc
    builds already go to ``change3d_tpu_torch/_build/``)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH_DIR, ".cache", "triton")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", cell: Optional[Cell] = None) -> Optional[dict]:
    """One run; returns the result object, or None (after saying why on
    standard error) when it must print none. ``device`` and ``cell`` (a
    stand-in for the manifest's) let the CPU tests drive a run at a small
    size."""
    import torch

    cell = cell or Cell(workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"bench: needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return None
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    lead, length = (TRACE_LEAD_S, TRACE_SLICE_S) if seconds >= 9 else (seconds / 3, seconds / 3)
    tracer = Tracer(trace, lead, length)
    driver = cell.driver().Driver(cell, seed, device)
    sync()
    setup_s = time.perf_counter() - t_start
    if device == "cuda":
        for d in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(d)
    win = driver.window(seconds, tracer)
    tracer.close()
    peak = (max(torch.cuda.max_memory_allocated(d) for d in range(cell.chips))
            if device == "cuda" else 0)
    driver.release()
    checks = driver.check()
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded modules it must not load: {', '.join(bad)}", file=sys.stderr)
        return None
    if trace:
        s = tracer.summary
        ctx = SimpleNamespace(trace=s, spans=win.spans, counters=win.counters, work=win.work,
                              samples=win.samples, seconds=win.seconds,
                              overhead_s=tracer.overhead_s)
        metrics = {}
        for m, reader in zip(cell.per_layer, cell.readers()):
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.metrics, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": all(c.ok for c in checks), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and tracer.summary is not None:
        s = tracer.summary
        dev["busy_s"], dev["window_s"] = s.busy_us / 1e6, s.window_us / 1e6
        result["breakdown"] = {"device_ops": s.device_ops(), "idle_gaps": s.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    print(f"bench: card {card_line() if device == 'cuda' else device}; setup_s {setup_s}; "
          f"window {win.seconds} s, {win.samples} samples", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    if result is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
