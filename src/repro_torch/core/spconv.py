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

from ..kernels.segsum import SegmentSpec, segment_sum
from .dataflow import (_mask_rows, hybrid, output_stationary,
                       weight_stationary)
from .kernel_map import KernelMap, l1_norm_max

Dataflow = Literal["os", "ws", "hybrid"]


@dataclasses.dataclass(frozen=True)
class SpConvSpec:
    """Static configuration of one sparse-convolution layer (the JAX spec's
    fields; ``backend`` takes "auto" | "torch" | "cuda"). K is odd
    (a centred grid), 2 (offsets ``{0, 1} · stride``: a stride-2 window
    and, ``transposed``, its inverse) or 1; a submanifold K = 1 layer's
    map is the identity."""

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
    transposed: bool = False      # map at out − δ_k (m_in > m_out)

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


class _BiasAdd(torch.autograd.Function):
    """``out + bias`` broadcast over the rows: exact in the forward pass.
    The backward reduces the cotangent over the capacity-sized row axis in
    a fixed order — a segment sum with one segment covering the buffer
    (``kernels.segsum``'s canonical schedule) — so ``db`` is bitwise equal
    across capacity buckets, where autograd's own reduction of a broadcast
    may regroup with the row count."""

    @staticmethod
    def forward(ctx, out, bias, backend):
        ctx.backend = backend
        ctx.bias_dtype = bias.dtype
        return out + bias

    @staticmethod
    def backward(ctx, g):
        cap, dev = g.shape[0], g.device
        db = None
        if ctx.needs_input_grad[1]:
            i32 = torch.int32
            db = segment_sum(
                g, torch.zeros(cap, dtype=i32, device=dev),
                torch.zeros(1, dtype=i32, device=dev),
                torch.full((1,), cap, dtype=i32, device=dev),
                num_segments=1,
                spec=SegmentSpec(backend=ctx.backend))[0].to(ctx.bias_dtype)
        return g, db, None


def spconv_features(params: SpConv, spec: SpConvSpec,
                    features: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
    """The convolution alone, before the bias: the spec's dataflow over the
    map. Differentiable (``core.dataflow``); a submanifold layer's map is
    its own transpose, so its backward skips the mirror scatter."""
    w = params.weight.to(features.dtype)
    cap = spec.ws_capacity or kmap.m.shape[0]
    st = spec.submanifold
    if spec.dataflow == "os":
        return output_stationary(features, kmap.m, w, fuse=spec.fuse_dense,
                                 backend=spec.backend, bm=spec.bm,
                                 bn=spec.bn, self_transpose=st)
    if spec.dataflow == "ws":
        return weight_stationary(features, kmap.m, w, capacity=cap,
                                 backend=spec.backend, bm=spec.bm,
                                 bn=spec.bn, self_transpose=st)
    if spec.dataflow == "hybrid":
        return hybrid(features, kmap, w, K=spec.K, stride=spec.offset_stride,
                      t=spec.t, ws_capacity=cap, fuse_dense=spec.fuse_dense,
                      backend=spec.backend, bm=spec.bm, bn=spec.bn,
                      self_transpose=st)
    raise ValueError(f"layer {spec.name}: unknown dataflow "
                     f"{spec.dataflow!r}; want os|ws|hybrid")


def add_bias(out: torch.Tensor, bias: Optional[torch.Tensor],
             spec: SpConvSpec, out_count: torch.Tensor) -> torch.Tensor:
    """The bias (already in the features' dtype) on :func:`spconv_features`'
    output, and the rows at and beyond ``out_count`` zeroed again unless
    the level is dense."""
    if bias is None:
        return out
    out = _BiasAdd.apply(out, bias, spec.backend)
    # PAD rows picked up the bias; zero them unless the level is dense
    return out if spec.dense else _mask_rows(out, out_count)


def apply_spconv(params: SpConv, spec: SpConvSpec, features: torch.Tensor,
                 kmap: KernelMap) -> torch.Tensor:
    """Feature computation with the spec's dataflow and the bias; output
    rows at and beyond ``kmap.out_count`` are zero. Differentiable."""
    bias = None if params.bias is None else params.bias.to(features.dtype)
    return add_bias(spconv_features(params, spec, features, kmap), bias,
                    spec, kmap.out_count)
