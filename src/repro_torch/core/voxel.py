"""Voxel coordinate set operations on packed coordinates (torch port of
``repro.core.voxel``).

A deduplicated coordinate set keeps its input-sized buffer: the valid
prefix sorted ascending, the tail padded with ``PAD`` (the dtype's int max),
plus a count. PAD sorts after every real coordinate, which is what binary
search wants. The network sorts once, at V0 (:func:`build_coord_set`);
coarser levels come from :func:`downsample` by a run merge or a re-sort,
bit-identical either way.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .packing import BitLayout, round_down

PAD32 = torch.iinfo(torch.int32).max
PAD64 = torch.iinfo(torch.int64).max


def pad_value(dtype) -> int:
    """PAD for a torch or numpy integer dtype: that dtype's int max."""
    if isinstance(dtype, torch.dtype):
        return PAD64 if dtype == torch.int64 else PAD32
    return PAD64 if np.dtype(dtype) == np.int64 else PAD32


@dataclasses.dataclass
class CoordSet:
    """``packed[: count]`` strictly ascending; ``packed[count :] == PAD``."""

    packed: torch.Tensor  # int32/int64 [N_max]
    count: torch.Tensor   # int32 0-d tensor, on packed's device

    @property
    def capacity(self) -> int:
        return self.packed.shape[0]


def _dedup_compact(s: torch.Tensor, capacity: int) -> CoordSet:
    """Sorted, PAD-tailed array -> deduplicated CoordSet of ``capacity``.
    Kept elements scatter to ``cumsum(keep) - 1`` (ascending); dropped ones
    go to a spare slot past the end that is sliced off."""
    pad = pad_value(s.dtype)
    keep = torch.ones_like(s, dtype=torch.bool)
    keep[1:] = s[1:] != s[:-1]
    keep &= s != pad
    count = keep.sum(dtype=torch.int32)
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, capacity)
    out = torch.full((capacity + 1,), pad, dtype=s.dtype, device=s.device)
    out[dest] = s
    return CoordSet(packed=out[:capacity], count=count)


def build_coord_set(packed: torch.Tensor) -> CoordSet:
    """Sort + dedup raw packed coordinates: the network's one true sort
    (``torch.sort`` is a radix sort on the card)."""
    return _dedup_compact(torch.sort(packed).values, packed.shape[0])


# ---------------------------------------------------------------------------
# run-aware merge downsample
# ---------------------------------------------------------------------------

def _merge_two_sorted(a: torch.Tensor, b: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """Merge two sorted PAD-tailed arrays by rank: each element's output
    position is its own index plus its insertion point in the other array
    (left side for ``a``, right side for ``b``, so ties keep a before b and
    ranks form a permutation). Ranks past ``capacity`` are PAD only and are
    dropped."""
    pad = pad_value(a.dtype)
    na, nb = a.shape[0], b.shape[0]
    pos_a = torch.arange(na, device=a.device) + torch.searchsorted(
        b, a, side="left")
    pos_b = torch.arange(nb, device=a.device) + torch.searchsorted(
        a, b, side="right")
    out = torch.full((capacity + 1,), pad, dtype=a.dtype, device=a.device)
    out[pos_a.clamp(max=capacity)] = a
    out[pos_b.clamp(max=capacity)] = b
    out[capacity] = pad
    return out[:capacity]


def _partition_runs(rounded: torch.Tensor, run_id: torch.Tensor,
                    n_runs: int) -> list:
    """Stable-partition ``rounded`` by ``run_id`` into ``n_runs``
    PAD-tailed buffers; each comes out sorted by the round-down lemma."""
    n = rounded.shape[0]
    pad = pad_value(rounded.dtype)
    rank = torch.zeros(n, dtype=torch.int64, device=rounded.device)
    for q in range(n_runs):
        mask = run_id == q
        rank = torch.where(mask, torch.cumsum(mask, 0) - 1, rank)
    flat = torch.full((n_runs * n,), pad, dtype=rounded.dtype,
                      device=rounded.device)
    flat[run_id.to(torch.int64) * n + rank] = rounded
    return [flat[q * n: (q + 1) * n] for q in range(n_runs)]


def downsample_merge(coords: CoordSet, layout: BitLayout, m: int,
                     *, from_m: int = 0) -> CoordSet:
    """Downsample a sorted level-``from_m`` set to level ``m`` without
    sorting: round, split into the ``4^Δ`` sorted runs keyed by the cleared
    (x, y) residues, merge-tree, dedup."""
    delta = m - from_m
    if delta <= 0:
        raise ValueError(f"downsample_merge needs m > from_m, got {from_m}->{m}")
    pad = pad_value(coords.packed.dtype)
    p = coords.packed
    is_pad = p == pad
    rounded = torch.where(is_pad, p, round_down(p, layout, m))
    rmask = (1 << delta) - 1
    rx = (p >> (layout.shift_x + from_m)) & rmask
    ry = (p >> (layout.shift_y + from_m)) & rmask
    run_id = torch.where(is_pad, 0, (rx << delta) | ry)
    runs = _partition_runs(rounded, run_id, 1 << (2 * delta))
    while len(runs) > 1:
        runs = [_merge_two_sorted(runs[i], runs[i + 1], coords.capacity)
                for i in range(0, len(runs), 2)]
    return _dedup_compact(runs[0], coords.capacity)


def resolve_downsample_method(method: str) -> str:
    """The one place the "auto" policy lives. On the card ``torch.sort`` is
    a radix sort, cheaper than the merge's rank and scatter passes, and on
    the CPU it is a plain sort; so "auto" resolves to "sort" everywhere in
    the port (both methods are bit-identical)."""
    if method == "auto":
        return "sort"
    if method not in ("merge", "sort"):
        raise ValueError(f"unknown downsample method {method!r}")
    return method


def downsample(coords: CoordSet, layout: BitLayout, m: int,
               *, from_m: int = 0, method: str = "auto") -> CoordSet:
    """Closed-form downsample to stride ``2^m`` (Spira §5.5, Eq. 1) from a
    level-``from_m`` set: one bitmask AND plus a merge or a re-sort."""
    if m == from_m:
        return coords
    if resolve_downsample_method(method) == "merge":
        return downsample_merge(coords, layout, m, from_m=from_m)
    pad = pad_value(coords.packed.dtype)
    rounded = torch.where(coords.packed == pad, coords.packed,
                          round_down(coords.packed, layout, m))
    return build_coord_set(rounded)


def downsample_all(v0: CoordSet, layout: BitLayout, levels: Tuple[int, ...],
                   method: str = "auto") -> Tuple[CoordSet, ...]:
    """All levels from V0, chained: each level derives from the previous
    one (flooring composes), in the order of ``levels``."""
    out = []
    prev_m = 0
    prev = v0
    for m in sorted(levels):
        cur = prev if m == prev_m else downsample(
            prev, layout, m, from_m=prev_m, method=method)
        out.append(cur)
        prev, prev_m = cur, m
    order = {m: i for i, m in enumerate(sorted(levels))}
    return tuple(out[order[m]] for m in levels)
