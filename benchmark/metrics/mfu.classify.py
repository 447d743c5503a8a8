"""mfu.classify: the classifier's share of the card's bf16 peak, its FLOPs
counted by ``work/kinetics.py`` (see benchlib/readers.py)."""

from benchmark.benchlib.readers import mfu


def read(ctx):
    return mfu(ctx)
