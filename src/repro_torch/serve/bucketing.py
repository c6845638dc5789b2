"""Capacity bucketing for serving traffic (torch port of
``repro.serve.bucketing``).

Raw point counts round up to a power-of-two bucket and pad with PAD, so a
session sees few distinct buffer sizes. PAD padding is free for
correctness: ``build_coord_set`` drops PAD before dedup, and a bucketed
plan equals the unbucketed plan on the valid rows.

:class:`BucketedPlanner` builds bucketed plans without the feature pass and
counts the buckets it has planned (the reference's one compiled module
per bucket).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.network_plan import NetworkPlan, build_network_plan
from ..core.packing import BitLayout
from ..core.spconv import SpConvSpec
from ..core.voxel import pad_value


def bucket_capacity(n: int, *, min_bucket: int = 1024,
                    max_bucket: int | None = None) -> int:
    """Smallest power-of-two bucket holding ``n`` points (>= ``min_bucket``,
    itself a power of two >= 128, so every bucket is whole 128-row tiles)."""
    if min_bucket < 128 or min_bucket & (min_bucket - 1):
        raise ValueError(f"min_bucket must be a power of two >= 128, got "
                         f"{min_bucket}")
    cap = min_bucket
    while cap < n:
        cap <<= 1
    if max_bucket is not None and cap > max_bucket:
        raise ValueError(f"{n} points exceed max bucket {max_bucket}")
    return cap


def bucket_packed(packed_raw, *, min_bucket: int = 1024,
                  device="cuda") -> torch.Tensor:
    """Pad raw packed coordinates to their capacity bucket with PAD."""
    p = np.asarray(packed_raw.cpu() if torch.is_tensor(packed_raw)
                   else packed_raw)
    cap = bucket_capacity(p.shape[0], min_bucket=min_bucket)
    out = np.full((cap,), pad_value(p.dtype), p.dtype)
    out[: p.shape[0]] = p
    return torch.from_numpy(out).to(device)


@dataclasses.dataclass
class BucketedPlanner:
    """Network plans for serving, padded to capacity buckets::

        planner = BucketedPlanner(specs=specs, layout=layout)
        plan = planner.plan(packed_raw)          # any length
        planner.compile_count                    # distinct buckets seen
    """

    specs: Tuple[SpConvSpec, ...]
    layout: BitLayout
    engine: str = "zdelta_cuda"
    downsample_method: str = "auto"
    min_bucket: int = 1024
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self._buckets_seen: Dict[int, int] = {}

    @torch.no_grad()
    def plan(self, packed_raw) -> NetworkPlan:
        padded = bucket_packed(packed_raw, min_bucket=self.min_bucket,
                               device=self.device)
        cap = padded.shape[0]
        self._buckets_seen[cap] = self._buckets_seen.get(cap, 0) + 1
        return build_network_plan(padded, specs=self.specs,
                                  layout=self.layout, engine=self.engine,
                                  downsample_method=self.downsample_method)

    @property
    def compile_count(self) -> int:
        """Distinct buckets planned so far (the reference's compiled
        modules; the port plans eagerly, so this counts keys)."""
        return len(self._buckets_seen)

    @property
    def bucket_hits(self) -> Dict[int, int]:
        return dict(self._buckets_seen)
