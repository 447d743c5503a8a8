"""unpack_ms.infer: mean ms of the program's span ``c3d.predict.unpack`` (a
call's bitpacked masks unpacked into numpy bool) in the traced slice, per
span (``benchlib/spans.py``)."""

from benchmark.benchlib.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "c3d.predict.unpack")
