"""KernelMap container and the static L1-norm offset split (torch port of
``repro.core.kernel_map``).

``m[i, k] = j`` means output row i reads input row j through offset δ_k
(−1: no input); columns are in z-delta group order. The hybrid dataflow's
dense/sparse offset split is a host-static function of the offset L1 norm
(Spira §4, property 3). :func:`transpose_kernel_map` mirrors a map for the
backward pass (``M[i, k] = j ⇒ Mᵀ[j, mirror(k)] = i``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .packing import offset_grid, offset_l1


@dataclasses.dataclass
class KernelMap:
    """``m[i, k] = j`` (−1 invalid), columns in z-delta group order."""

    m: torch.Tensor          # int32 [M_cap, K^3]
    out_count: torch.Tensor  # int32 0-d: valid output rows
    in_count: torch.Tensor   # int32 0-d: valid input rows

    @property
    def k3(self) -> int:
        return self.m.shape[1]

    def column_counts(self) -> torch.Tensor:
        return (self.m >= 0).sum(dim=0).to(torch.int32)

    def column_density(self) -> torch.Tensor:
        """Fraction of valid entries per offset column (among valid rows)."""
        return (self.column_counts().to(torch.float32)
                / self.out_count.to(torch.float32).clamp(min=1.0))


def transpose_kernel_map(m: torch.Tensor, *, n_in: int) -> torch.Tensor:
    """Transposed (mirrored) kernel map: ``mt[j, mirror(k)] = i`` wherever
    ``m[i, k] = j``, with ``mirror(k) = Kd − 1 − k`` (offset δ → −δ under
    the z-delta column order); ``n_in`` rows, −1 elsewhere. The backward
    pass of a sparse convolution runs over it: input j's cotangent reads
    output i's through −δ_k, so training needs no new kernel-map search.

    One flat int32 scatter over ``M · Kd`` entries. Targets of valid
    entries never collide (a kernel map is injective per column); invalid
    entries all land in one extra slot past the end, which is dropped, so
    no host sync is needed to filter them. For a submanifold map the
    result equals ``m``.

    Precondition, as in the reference: the columns of ``m`` are a
    mirror-closed, offset-ordered subset of the K³ grid (the full map or
    an ``l1_partition`` subset)."""
    mcap, kd = m.shape
    # flat targets j * Kd + mirror(k) are int32 in the reference: refuse a
    # shape whose flat index would wrap instead of corrupting dF silently
    if (max(n_in, mcap) + 1) * kd >= 2 ** 31:
        raise ValueError(f"transpose_kernel_map: {n_in}×{kd} flat index "
                         "overflows int32")
    dev = m.device
    mirror = torch.arange(kd - 1, -1, -1, dtype=torch.int64, device=dev)
    flat = torch.where(m >= 0, m.long() * kd + mirror[None, :], n_in * kd)
    rows = torch.arange(mcap, dtype=torch.int32, device=dev)
    mt = torch.full((n_in * kd + 1,), -1, dtype=torch.int32, device=dev)
    mt.scatter_(0, flat.reshape(-1),
                rows[:, None].expand(mcap, kd).reshape(-1))
    return mt[:-1].reshape(n_in, kd)


def l1_partition(K: int, stride: int, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """Offsets with ``L1(δ) < t`` are dense (OS), the rest sparse (WS);
    indices in z-delta group order. ``t = 0`` → all sparse,
    ``t = L1NormMax + 1`` → all dense."""
    l1 = offset_l1(offset_grid(K, stride))
    dense = np.nonzero(l1 < t)[0].astype(np.int32)
    sparse = np.nonzero(l1 >= t)[0].astype(np.int32)
    return dense, sparse


def l1_norm_max(K: int, stride: int) -> int:
    return 3 * ((K - 1) // 2) * stride
