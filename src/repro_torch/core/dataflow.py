"""Feature-computation dataflows (Spira §5.4), forward only — torch port of
``repro.core.dataflow``.

Output-stationary (OS): per offset, gather the input rows through the
kernel map and multiply by that offset's weights, accumulating in fp32;
no filtering and no merge. Every dataflow takes ``backend`` ∈ {"auto",
"torch", "cuda"} (``kernels.ops.resolve_backend``): the CUDA implicit-GEMM
kernel (``kernels.spconv_gather_gemm``) on the card, the plain per-offset
loop (:func:`os_torch`) on CPU tensors.

Numerics: fp32 accumulation over the same operands in the same offset
order on both backends; the CUDA kernel's per-element add order differs
from a library matmul's, so the two agree within fp32 rounding, not bit for
bit.

Not ported yet (ROADMAP Queue 2): weight-stationary and hybrid, whose
kernel is ``ws_scatter_gemm``, and the custom VJPs.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops


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
