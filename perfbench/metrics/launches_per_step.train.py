"""Device kernel launches per training step in the profiler (copies and
sets left out)."""
from perfbench.lib.trace import is_copy


def read(ctx):
    if ctx.trace is None or ctx.kind != "train" or not ctx.calls:
        return None
    n = sum(1 for name, _, _ in ctx.trace.ops if not is_copy(name))
    return n / ctx.calls
