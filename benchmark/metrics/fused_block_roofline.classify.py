"""fused_block_roofline.classify: the 51 T = 16 fused blocks' least time
(``work/kinetics.py``) over their device time (see benchlib/readers.py)."""

from benchmark.benchlib.readers import fused_roofline


def read(ctx):
    return fused_roofline(ctx)
