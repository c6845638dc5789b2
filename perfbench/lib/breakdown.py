"""The traced window summed up: device busy seconds, the device operations
that took most time, and the device's idle time by what the host was doing
(the harness's innermost ``bench/...`` range open at the gap)."""
from __future__ import annotations

import bisect
from typing import Dict, List

from . import stats
from .trace import Trace, short_name


def busy_s(tr: Trace) -> float:
    """Seconds in which some device operation ran."""
    return stats.covered((s, e) for _, s, e in tr.ops) / 1e9


def of(tr: Trace, top: int = 10) -> dict:
    by_op: Dict[str, float] = {}
    for name, s, e in tr.ops:
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + (e - s) / 1e9
    ranges = sorted((s, e, n) for n, s, e in tr.ranges)
    starts = [r[0] for r in ranges]
    idle: Dict[str, float] = {}
    for lo, hi in stats.gaps(((s, e) for _, s, e in tr.ops), tr.lo, tr.hi):
        mid = (lo + hi) // 2
        # the harness's ranges do not nest: only the last one opened
        # before the gap's middle can hold it
        i = bisect.bisect_right(starts, mid) - 1
        name = ranges[i][2] if i >= 0 and ranges[i][1] >= mid \
            else "between ranges"
        idle[name] = idle.get(name, 0.0) + (hi - lo) / 1e9
    return {"device_ops": _top(by_op, top), "idle_gaps": _top(idle, top)}


def _top(d: Dict[str, float], n: int) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
