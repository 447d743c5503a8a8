"""fused_block_roofline.scd: the T = 5 fused blocks' least time over their
device time (see benchlib/readers.py)."""

from benchmark.benchlib.readers import fused_roofline


def read(ctx):
    return fused_roofline(ctx)
