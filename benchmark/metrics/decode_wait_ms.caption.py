"""decode_wait_ms.caption: mean ms of the program's span
``c3d.caption.alive_check`` (one early-exit check, where the search waits
for the device) in the traced slice, per span (``benchlib/spans.py``)."""

from benchmark.benchlib.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "c3d.caption.alive_check")
