"""mfu.scd: the SCD forward's share of the card's bf16 peak, its FLOPs
counted by ``work/scd.py`` (see benchlib/readers.py)."""

from benchmark.benchlib.readers import mfu


def read(ctx):
    return mfu(ctx)
