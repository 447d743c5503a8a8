"""decode_ms.caption: mean ms of the program's span ``c3d.caption.decode``
(the whole KV-cached search of a caption call, ``beam_search_decode``) in
the traced slice, per span (``benchlib/spans.py``)."""

from benchmark.benchlib.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "c3d.caption.decode")
