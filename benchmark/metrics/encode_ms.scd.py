"""encode_ms.scd: mean ms of the program's span ``c3d.predict.encode`` (the
encoder of one ``predict_u8`` call as the host enqueues it) in the traced
slice, per span (``benchlib/spans.py``)."""

from benchmark.benchlib.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "c3d.predict.encode")
