"""Feature-computation dataflows (Spira §5.4), forward only — torch port of
``repro.core.dataflow``.

Output-stationary (OS): per offset, gather the input rows through the
kernel map and multiply by that offset's weights, accumulating in fp32;
no filtering and no merge. Weight-stationary (WS): per offset, compact the
valid pairs to a static ``capacity`` (the first ``capacity`` valid rows of
a column survive, the rest are dropped), multiply the gathered rows by the
offset's weights and merge the products into their output rows, offset
after offset. Hybrid: offsets with L1 norm below ``t`` through OS, the
rest through WS, summed as ``(0 + os_half) + ws_half``.

Every dataflow takes ``backend`` ∈ {"auto", "torch", "cuda"}
(``kernels.ops.resolve_backend``): on the card the OS implicit-GEMM kernel
(``kernels.spconv_gather_gemm``) and the WS scatter-GEMM kernel
(``kernels.ws_scatter_gemm``), on CPU tensors their plain versions
(:func:`os_torch`, :func:`ws_torch`).

Numerics: fp32 accumulation over the same operands in the same offset
order on both backends; the CUDA kernels' per-element add order within one
product differs from a library matmul's, so the two agree within fp32
rounding, not bit for bit.

Not ported yet (ROADMAP Queue 1): the custom VJPs, ``chunked_rowdot`` and
the HBM traffic model.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from .kernel_map import KernelMap, l1_partition


def _mask_rows(x: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Zero rows at and beyond ``count``."""
    keep = torch.arange(x.shape[0], device=x.device) < count
    return torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def os_torch(features: torch.Tensor, m: torch.Tensor, weights: torch.Tensor,
             *, fuse: bool = False) -> torch.Tensor:
    """OS dataflow in plain torch. ``fuse=True`` materializes one
    [M, Kd, Cin] gather and contracts it in one einsum; the default loops
    over offsets with an [M, Cin] working set (the plain version of the
    CUDA kernel)."""
    if not fuse:
        from ..kernels.spconv_gather_gemm import spconv_gather_gemm_torch
        return spconv_gather_gemm_torch(features, m, weights)
    g = features[m.clamp(min=0).long()] * (m >= 0)[..., None].to(
        features.dtype)
    return torch.einsum("mkc,kcd->md", g.float(),
                        weights.float()).to(features.dtype)


def output_stationary(features: torch.Tensor, m: torch.Tensor,
                      weights: torch.Tensor, *, fuse: bool = False,
                      backend: str = "auto", bm: int = 0,
                      bn: int = 0) -> torch.Tensor:
    """OS dataflow: ``features`` [N, Cin], ``m`` int32 [M, Kd] (a kernel-map
    column subset), ``weights`` [Kd, Cin, Cout] → [M, Cout]. On the kernel
    path the gather is fused in and ``fuse`` is moot."""
    if kops.resolve_backend(backend, features):
        return kops.spconv_os_fused(features, m, weights, backend="cuda",
                                    bm=bm, bn=bn)
    return os_torch(features, m, weights, fuse=fuse)


def ws_torch(features: torch.Tensor, m: torch.Tensor, weights: torch.Tensor,
             *, capacity: int) -> torch.Tensor:
    """WS dataflow in plain torch (``ws_xla``): per-column compaction to
    ``capacity``, gather, fp32 GEMM and a merge into the output rows in
    column order; the result in the features' dtype."""
    from ..kernels.ws_scatter_gemm import ws_scatter_gemm_torch
    return ws_scatter_gemm_torch(features, m, weights,
                                 capacity=capacity).to(features.dtype)


def ws_kept_map(m: torch.Tensor, capacity: int) -> torch.Tensor:
    """The kernel map WS actually computes with: valid pairs beyond
    ``capacity`` in their column (row order) replaced by −1."""
    valid = m >= 0
    # the column scan runs over contiguous rows of the transpose (fast on
    # the card, unlike a scan over the outer dimension)
    rank = torch.cumsum(valid.t().contiguous(), dim=1).t()
    keep = valid & (rank <= capacity)
    return torch.where(keep, m, torch.full((), -1, dtype=m.dtype,
                                           device=m.device))


def weight_stationary(features: torch.Tensor, m: torch.Tensor,
                      weights: torch.Tensor, *, capacity: int,
                      backend: str = "auto", bm: int = 0,
                      bn: int = 0) -> torch.Tensor:
    """WS dataflow: ``features`` [N, Cin], ``m`` int32 [M, Ks], ``weights``
    [Ks, Cin, Cout] → [M, Cout] in the features' dtype. Valid pairs beyond
    ``capacity`` per column are dropped; ``capacity = M`` is lossless."""
    if kops.resolve_backend(backend, features):
        return kops.spconv_ws_fused(features, m, weights, capacity=capacity,
                                    backend="cuda", bm=bm, bn=bn)
    return ws_torch(features, m, weights, capacity=capacity)


def ws_overflow(kmap: KernelMap, cols: np.ndarray,
                capacity: int) -> torch.Tensor:
    """Diagnostic: True if any selected column exceeds the WS capacity."""
    idx = torch.as_tensor(cols, dtype=torch.long, device=kmap.m.device)
    return (kmap.column_counts()[idx] > capacity).any()


def _take(x: torch.Tensor, idx: np.ndarray, dim: int) -> torch.Tensor:
    """``x`` indexed by ``idx`` along ``dim``; ``x`` itself (no copy) when
    ``idx`` is every index in order."""
    if idx.size == x.shape[dim] and (idx == np.arange(idx.size)).all():
        return x
    return x.index_select(dim, torch.as_tensor(idx, dtype=torch.long,
                                               device=x.device))


def hybrid(features: torch.Tensor, kmap: KernelMap, weights: torch.Tensor,
           *, K: int, stride: int, t: int, ws_capacity: int,
           fuse_dense: bool = False, backend: str = "auto", bm: int = 0,
           bn: int = 0) -> torch.Tensor:
    """Hybrid dataflow: offsets with L1 < t through OS (the dense half),
    the rest through WS (the sparse half), added to a zero accumulator in
    that order. ``t = 0`` is full WS, ``t = L1NormMax + 1`` full OS."""
    dense_idx, sparse_idx = l1_partition(K, stride, t)
    out = torch.zeros((kmap.m.shape[0], weights.shape[-1]),
                      dtype=features.dtype, device=features.device)
    if dense_idx.size:
        out = out + output_stationary(
            features, _take(kmap.m, dense_idx, 1),
            _take(weights, dense_idx, 0), fuse=fuse_dense, backend=backend,
            bm=bm, bn=bn)
    if sparse_idx.size:
        out = out + weight_stationary(
            features, _take(kmap.m, sparse_idx, 1),
            _take(weights, sparse_idx, 0), capacity=ws_capacity,
            backend=backend, bm=bm, bn=bn)
    return out
