"""The program's own spans in the traced slice: ``c3d.*`` ranges that the
port records on the profiler's clock (``change3d_tpu_torch/utils/
profiling.py``), read from the slice's host events."""

from __future__ import annotations

from typing import Optional


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean duration, ms, of the complete spans named ``name`` in the
    traced slice; None when it holds none (no slice, or a program without
    the span). The profiler closes a span still open when it stops at the
    slice's last instant: a span that ends within a microsecond of it is
    cut, and left out."""
    t = ctx.trace
    if t is None:
        return None
    end = t.start_us + t.window_us - 1.0
    spans = [e - s for n, s, e in t.host if n == name and s < e < end]
    return sum(spans) / len(spans) / 1e3 if spans else None
