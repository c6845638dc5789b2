"""The weight-gradient kernels' share of their roofline: dW of every layer
and of the head, over the device time of the dW pack, product and combine
kernels."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.kind != "train":
        return None
    return _device.roofline(ctx, "dw", _device.DW)
