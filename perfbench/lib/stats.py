"""Arithmetic on records: percentiles and interval unions."""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    if not 0 < q <= 100:
        raise ValueError(f"q = {q} outside (0, 100]")
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted ``(start, end)`` intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The parts of ``[lo, hi)`` that no interval covers."""
    out, at = [], lo
    for s, e in union((max(s, lo), min(e, hi)) for s, e in intervals
                      if e > lo and s < hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out
