"""Device-busy ms per request: the union of the device operations'
intervals over the traced window, per request served."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.trace is None or ctx.kind != "open" or not ctx.calls:
        return None
    return 1e3 * _device.busy(ctx) / ctx.calls
