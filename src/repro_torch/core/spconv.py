"""SparseConv layer: spec, parameters and feature computation over a
KernelMap (torch port of ``repro.core.spconv``).

Voxel indexing happens outside the layer, in the NetworkPlan (network-wide
indexing); the layer only computes features — the paper's decoupling of
indexing from computation.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch
from torch import nn

from .dataflow import _mask_rows, output_stationary
from .kernel_map import KernelMap, l1_norm_max

Dataflow = Literal["os", "ws", "hybrid"]


@dataclasses.dataclass(frozen=True)
class SpConvSpec:
    """Static configuration of one sparse-convolution layer (the JAX spec's
    fields; ``backend`` takes "auto" | "torch" | "cuda")."""

    name: str
    cin: int
    cout: int
    K: int = 3
    m_in: int = 0    # log2 input coordinate stride
    m_out: int = 0   # log2 output coordinate stride (== m_in: submanifold)
    dataflow: Dataflow = "os"
    t: int = 0                    # hybrid threshold on offset L1 norm
    ws_capacity: Optional[int] = None  # None -> lossless (M_cap)
    fuse_dense: bool = False
    bias: bool = True
    backend: str = "auto"         # "auto" | "torch" | "cuda"
    bm: int = 0                   # row tile (0 = auto)
    bn: int = 0                   # output-channel tile (0 = auto)
    window: int = 0               # superwindow size (0 = auto)
    symmetry: bool = False        # §5.4 half-search + mirror fill
    dense: bool = False           # output level statically has no PAD rows

    @property
    def submanifold(self) -> bool:
        return self.m_in == self.m_out

    @property
    def offset_stride(self) -> int:
        """Stride of the offset grid: the finer of the two strides."""
        return 1 << min(self.m_in, self.m_out)

    @property
    def l1_max(self) -> int:
        return l1_norm_max(self.K, self.offset_stride)


class SpConv(nn.Module):
    """One sparse-convolution layer: ``weight`` [K³, Cin, Cout] and
    ``bias`` [Cout] (None when ``spec.bias`` is False)."""

    def __init__(self, spec: SpConvSpec, weight: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.spec = spec
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, features: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
        return apply_spconv(self, self.spec, features, kmap)


def init_spconv(spec: SpConvSpec, *, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> SpConv:
    """Weights ~ N(0, 1/fan_in) drawn on the CPU from ``generator`` (so a
    seed gives the same weights on every device), zero bias."""
    k3 = spec.K ** 3
    w = torch.randn((k3, spec.cin, spec.cout), generator=generator,
                    dtype=torch.float32) / np.sqrt(spec.cin * k3)
    b = torch.zeros(spec.cout) if spec.bias else None
    return SpConv(spec, w.to(device=device, dtype=dtype),
                  None if b is None else b.to(device=device, dtype=dtype))


def apply_spconv(params: SpConv, spec: SpConvSpec, features: torch.Tensor,
                 kmap: KernelMap) -> torch.Tensor:
    """Feature computation with the spec's dataflow; output rows at and
    beyond ``kmap.out_count`` are zero."""
    if spec.dataflow != "os":
        raise NotImplementedError(
            f"layer {spec.name}: dataflow {spec.dataflow!r} needs the "
            "weight-stationary kernel ws_scatter_gemm, not ported yet "
            "(ROADMAP Queue 2); use dataflow='os'")
    w = params.weight.to(features.dtype)
    out = output_stationary(features, kmap.m, w, fuse=spec.fuse_dense,
                            backend=spec.backend, bm=spec.bm, bn=spec.bn)
    if params.bias is not None:
        # a plain broadcast add: exact in the forward pass (the reference's
        # rank-1 dot exists for its backward's reduction order)
        out = out + params.bias.to(features.dtype)
        # PAD rows picked up the bias; zero them unless the level is dense
        if not spec.dense:
            out = _mask_rows(out, kmap.out_count)
    return out
