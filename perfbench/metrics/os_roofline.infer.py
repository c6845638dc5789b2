"""The output-stationary kernel's share of its roofline over the window:
the least time of its launches (2 pairs Cin Cout operations over its offset
columns; its inputs, weights, map columns and outputs once) over the
device time of ``os_mma_kernel``."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.kind != "closed":
        return None
    return _device.roofline(ctx, "os", _device.OS)
