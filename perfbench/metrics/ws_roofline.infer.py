"""The weight-stationary path's share of its roofline: the least time of
its launches over the device time of its pack, rank and sweep kernels."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.kind != "closed":
        return None
    return _device.roofline(ctx, "ws", _device.WS)
