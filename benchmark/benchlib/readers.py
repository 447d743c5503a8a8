"""Arithmetic shared by the per-layer metric readers (``metrics/*.py``).
Each reader's ``read(ctx)`` returns a number, or None when its run gave it
nothing to read; ``ctx`` holds the traced slice (``trace``), the driver's
spans, counters and work, and the window's samples and seconds."""

from __future__ import annotations

from typing import Optional

from benchmark.work.peaks import H100


def mfu(ctx) -> Optional[float]:
    """The window's FLOPs (counted from shapes) over its seconds, less the
    time the tracer took to start and stop, as a share of the bf16 dense
    peak, %. The traced slice runs with the profiler's host overhead."""
    seconds = ctx.seconds - ctx.overhead_s
    if not ctx.work.get("flops") or seconds <= 0:
        return None
    return 100.0 * ctx.work["flops"] / seconds / H100["bf16_flops_per_s"]


def device_idle(ctx) -> Optional[float]:
    """Share of the traced slice in which no kernel ran, %."""
    t = ctx.trace
    if t is None or not t.window_us:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)


def fused_roofline(ctx) -> Optional[float]:
    """The fused blocks' least time for the samples finished in the traced
    slice over the device time of the kernels named ``fused_block``, %."""
    t = ctx.trace
    least = ctx.work.get("fused_least_s_per_sample")
    if t is None or not least or not t.samples:
        return None
    spent = t.kernel_us("fused_block")
    if not spent:
        return None
    return 100.0 * least * t.samples * 1e6 / spent
