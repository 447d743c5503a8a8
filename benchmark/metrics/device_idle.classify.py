"""device_idle.classify: share of the traced slice with no kernel running
(see benchlib/readers.py)."""

from benchmark.benchlib.readers import device_idle


def read(ctx):
    return device_idle(ctx)
