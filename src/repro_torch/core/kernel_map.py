"""KernelMap container and the static L1-norm offset split (torch port of
``repro.core.kernel_map``).

``m[i, k] = j`` means output row i reads input row j through offset δ_k
(−1: no input); columns are in z-delta group order. The hybrid dataflow's
dense/sparse offset split is a host-static function of the offset L1 norm
(Spira §4, property 3).
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
