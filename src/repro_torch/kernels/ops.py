"""Backend dispatch for the hand-written kernels, and the OS entry point.

Every kernel entry point takes ``backend`` ∈ {"auto", "torch", "cuda"}:

  "auto"  — the CUDA kernel on a CUDA tensor, the plain PyTorch version on
            a CPU tensor;
  "cuda"  — the CUDA kernel; a CPU tensor raises;
  "torch" — the plain PyTorch version on either device (tests and
            ``chip_smoke.py`` ask for it on the card to compare).

:func:`resolve_backend` is the single decision point. Nothing falls back:
a kernel that does not build or launch raises.
"""
from __future__ import annotations

import torch

from .spconv_gather_gemm import (TILE, spconv_gather_gemm,
                                 spconv_gather_gemm_torch)

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


def spconv_os_fused(features: torch.Tensor, m: torch.Tensor,
                    weights: torch.Tensor, *, backend: str = "auto",
                    bm: int = 0, bn: int = 0) -> torch.Tensor:
    """OS dataflow as one implicit GEMM: the kernel-map gather happens inside
    the kernel, no [M, Kd, Cin] intermediate. ``bm``/``bn`` are the row and
    channel tiles; the CUDA kernel is compiled for 64 x 64 and masks the
    ragged edges of M and Cout itself, so 0 (auto) or 64 are accepted."""
    for name, v in (("bm", bm), ("bn", bn)):
        if v not in (0, TILE):
            raise ValueError(f"{name}={v}: the CUDA OS kernel is compiled for "
                             f"{TILE}-wide tiles (0 = auto)")
    if resolve_backend(backend, features):
        return spconv_gather_gemm(features, m, weights)
    return spconv_gather_gemm_torch(features, m, weights)
