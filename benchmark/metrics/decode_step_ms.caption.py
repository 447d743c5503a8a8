"""decode_step_ms.caption: mean ms of the program's span
``c3d.caption.step`` (one decode step as the host launches it: the step, the
log-softmax, the search's bookkeeping) in the traced slice, per span
(``benchlib/spans.py``)."""

from benchmark.benchlib.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "c3d.caption.step")
