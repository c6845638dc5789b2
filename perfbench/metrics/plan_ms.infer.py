"""Device ms per call of the kernel-map search and overflow-repair
kernels."""
from perfbench.metrics import _device


def read(ctx):
    if ctx.trace is None or ctx.kind != "closed" or not ctx.calls:
        return None
    t = _device.seconds(ctx, _device.PLAN)
    return 1e3 * t / ctx.calls if t > 0 else None
