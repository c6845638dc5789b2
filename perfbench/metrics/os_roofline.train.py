"""The output-stationary kernel's share of its roofline in training: the
forward of every layer and dF of every layer but the first (the same kernel
over the transposed map), over the device time of ``os_mma_kernel``."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.kind != "train":
        return None
    return _device.roofline(ctx, "os", _device.OS)
