"""h2d_ms.infer: mean ms of the program's span ``c3d.predict.h2d`` (the copy
of a call's uint8 pairs from host arrays to the card) in the traced slice,
per span (``benchlib/spans.py``)."""

from benchmark.benchlib.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "c3d.predict.h2d")
