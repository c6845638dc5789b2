"""95th percentile (nearest rank) of every request of the window, each timed
from its due time to its answer on the host; an unanswered request counts
as slower than all."""
import math

from perfbench.lib import stats


def read(ctx):
    if ctx.kind != "open" or not ctx.latencies:
        return None
    lat = list(ctx.latencies)
    missing = ctx.attempted - len(lat)
    lat += [math.inf] * missing
    v = stats.percentile(lat, 95)
    return None if math.isinf(v) else v * 1e3
