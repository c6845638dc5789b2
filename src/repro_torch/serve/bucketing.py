"""Capacity bucketing for serving traffic (torch port of
``repro.serve.bucketing``).

Raw point counts round up to a power-of-two bucket and pad with PAD, so a
session sees few distinct buffer sizes. PAD padding is free for
correctness: ``build_coord_set`` drops PAD before dedup, and a bucketed
plan equals the unbucketed plan on the valid rows.
"""
from __future__ import annotations

import numpy as np
import torch

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
