"""Percent of the traced window in which no device operation ran."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.kind != "train":
        return None
    return _device.idle_share(ctx)
