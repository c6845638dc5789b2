"""Backend dispatch for the hand-written kernels, and the OS and WS entry
points.

Every kernel entry point takes ``backend`` ∈ {"auto", "torch", "cuda"}:

  "auto"  — the CUDA kernel on a CUDA tensor, the plain PyTorch version on
            a CPU tensor;
  "cuda"  — the CUDA kernel; a CPU tensor raises;
  "torch" — the plain PyTorch version on either device (tests and
            ``chip_smoke.py`` ask for it on the card to compare).

:func:`resolve_backend` is the single decision point. Nothing falls back:
a kernel that does not build or launch raises. Besides the fused OS and WS
entry points: :func:`spconv_dw_fused`, the per-offset weight gradient
(gather fused in), :func:`output_stationary_fused`, the unfused OS
baseline over a gathered ``[M, Kd, Cin]`` tensor, and :func:`attention`,
``(BH, S, D)`` softmax attention.
"""
from __future__ import annotations

import torch

from .dw_gather_gemm import dw_gather_gemm, dw_gather_gemm_torch
from .flash_attention import flash_attention, flash_attention_torch
from . import opcount
from .masked_group_gemm import masked_group_gemm, masked_group_gemm_torch
from .spconv_gather_gemm import (TILE_M, _tile_for, spconv_gather_gemm,
                                 spconv_gather_gemm_torch)
from .ws_scatter_gemm import (PANEL, TILES_N, ws_scatter_gemm,
                              ws_scatter_gemm_torch)

BACKENDS = ("auto", "torch", "cuda")


def resolve_backend(backend: str, tensor: torch.Tensor) -> bool:
    """True when ``backend`` on ``tensor``'s device launches the CUDA
    kernel, False when it runs the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want auto|torch|cuda")
    if backend == "torch":
        return False
    on_cuda = tensor.device.type == "cuda"
    if backend == "cuda" and not on_cuda:
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got one on "
                         f"{tensor.device}")
    return on_cuda


def gemm_counts(features: torch.Tensor, m: torch.Tensor,
                weights: torch.Tensor, capacity: int = 0, cols=None):
    """The closed form of a gather GEMM over the map ``m [M, Kd]`` (PERF.md's
    kernel table): ``2 · pairs · Cin · Cout`` operations, ``pairs`` the
    valid entries (per column at most ``capacity`` when given: the WS
    kept pairs; only the map columns ``cols`` when given); bytes: the
    features, the map and the weights read once, an fp32 ``[M, Cout]``
    written once. Computed only under a counter: outside one it touches
    no tensor."""
    if not opcount.counting():
        return 0.0, 0.0
    with opcount.uncounted():
        if cols is not None:
            m = m[:, cols.long()]
        per_col = (m >= 0).sum(0)
        if capacity:
            per_col = per_col.clamp(max=capacity)
        pairs = float(per_col.sum())
    cin, cout = features.shape[-1], weights.shape[-1]
    nb = (features.numel() * features.element_size() + 4 * m.numel()
          + weights.numel() * weights.element_size() + 4 * m.shape[0] * cout)
    return 2.0 * pairs * cin * cout, nb


def spconv_os_fused(features: torch.Tensor, m: torch.Tensor,
                    weights: torch.Tensor, *, backend: str = "auto",
                    bm: int = 0, bn: int = 0) -> torch.Tensor:
    """OS dataflow as one implicit GEMM: the kernel-map gather happens inside
    the kernel, no [M, Kd, Cin] intermediate. ``bm``/``bn`` are the row and
    channel tiles; the CUDA kernel runs 128-row tiles and the Cout tile
    ``_tile_for`` picks from the layer (the add order must not depend on a
    caller's choice), and masks the ragged edges of M and Cout itself, so
    0 (auto) or those tiles are accepted."""
    if bm not in (0, TILE_M):
        raise ValueError(f"bm={bm}: the CUDA OS kernel is compiled for "
                         f"{TILE_M}-row tiles (0 = auto)")
    tile_n = _tile_for(features.shape[-1], weights.shape[-1], features.dtype)
    if bn not in (0, tile_n):
        raise ValueError(f"bn={bn}: the CUDA OS kernel runs Cout tile "
                         f"{tile_n} for this layer (0 = auto)")
    if resolve_backend(backend, features):
        return spconv_gather_gemm(features, m, weights)
    return spconv_gather_gemm_torch(features, m, weights)


def spconv_ws_fused(features: torch.Tensor, m: torch.Tensor,
                    weights: torch.Tensor, *, capacity: int,
                    backend: str = "auto", bm: int = 0, bn: int = 0,
                    cols=None) -> torch.Tensor:
    """WS dataflow as one pack + panel-sweep kernel; the result in the
    features' dtype. ``bm`` is the row panel (the CUDA kernel is compiled
    for 128; 0 = auto) and ``bn`` the Cout tile (16, 32, 64 or 96; 0 = the
    smallest that covers Cout); ``cols``: the map columns the offsets read
    (None: all)."""
    if bm not in (0, PANEL):
        raise ValueError(f"bm={bm}: the CUDA WS kernel is compiled for "
                         f"{PANEL}-row panels (0 = auto)")
    if bn not in (0, *TILES_N):
        raise ValueError(f"bn={bn}: the CUDA WS kernel is compiled for Cout "
                         f"tiles {TILES_N} (0 = auto)")
    if resolve_backend(backend, features):
        out = ws_scatter_gemm(features, m, weights, capacity=capacity, bn=bn,
                              cols=cols)
    else:
        out = ws_scatter_gemm_torch(features, m, weights, capacity=capacity,
                                    cols=cols)
    return out.to(features.dtype)


def spconv_dw_fused(features: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                    *, backend: str = "auto") -> torch.Tensor:
    """Per-offset weight gradient ``dW[k] = G_kᵀ g`` (``G_k`` the gathered,
    masked features of offset k) as fp32 ``[Kd, Cin, Cout]``, with the
    row contraction in fixed panels (``kernels.dw_gather_gemm``): one
    kernel for all offsets on the card, the panel loop in torch
    otherwise."""
    with opcount.kernel("dw_gather_gemm", *gemm_counts(features, m, g)):
        if resolve_backend(backend, features):
            return dw_gather_gemm(features, m, g)
        return dw_gather_gemm_torch(features, m, g)


def output_stationary_fused(features: torch.Tensor, m: torch.Tensor,
                            weights: torch.Tensor, *,
                            backend: str = "auto") -> torch.Tensor:
    """Unfused OS baseline: a torch gather into ``[M, Kd, Cin]`` (invalid
    entries gather row 0), then the masked grouped GEMM kernel on the card
    or its plain version. It materializes the gathered tensor; the fused
    path is :func:`spconv_os_fused`."""
    gathered = features[m.clamp(min=0).long()]
    if resolve_backend(backend, features):
        return masked_group_gemm(m, gathered, weights)
    return masked_group_gemm_torch(m, gathered, weights)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, backend: str = "auto") -> torch.Tensor:
    """``(BH, S, D)`` softmax attention with the reference's contract
    (``flash_attention_ref``): scale ``1/√D`` after the QK dot, the causal
    diagonal at the end of the keys, the result in q's dtype. The flash
    attention kernel on the card or its plain version; unlike the TPU
    wrapper there is no ``S % 128`` condition, since the kernel masks
    ragged tiles itself."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    q4, k4, v4 = q[:, :, None], k[:, :, None], v[:, :, None]
    if resolve_backend(backend, q):
        out = flash_attention(q4, k4, v4, causal=causal, scale=scale)
    else:
        out = flash_attention_torch(q4, k4, v4, causal=causal, scale=scale)
    return out[:, :, 0]
