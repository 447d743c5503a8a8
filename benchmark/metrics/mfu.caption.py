"""mfu.caption: the whole step's share of the card's bf16 peak (see benchlib/readers.py)."""

from benchmark.benchlib.readers import mfu


def read(ctx):
    return mfu(ctx)
