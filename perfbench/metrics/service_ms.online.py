"""Mean ms of the session's own ``session/call`` span over the window's
requests (its sum over its count: the span's percentiles are bucket
edges)."""


def read(ctx):
    n = ctx.counters.get("call_count", 0)
    if ctx.kind != "open" or not n:
        return None
    return 1e3 * ctx.counters["call_seconds"] / n
