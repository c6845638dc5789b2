"""Device ms per call of every operation not built from the program's
CUDA sources: elementwise work, concatenations, gathers, sorts, library
GEMMs, copies and sets."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.trace is None or ctx.kind != "closed" or not ctx.calls:
        return None
    return 1e3 * _device.torch_ops(ctx) / ctx.calls
