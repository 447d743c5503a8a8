"""h2d_ms.classify: mean ms of the program's span ``c3d.classify.h2d`` (a
call's uint8 clips into the pinned staging buffer and onto the card) in the
traced slice, per span (``benchlib/spans.py``)."""

from benchmark.benchlib.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "c3d.classify.h2d")
