"""Weight gradient of a sparse convolution per offset, gather fused in:
CUDA kernel + plain version.

``dW[k] = Σ_r G_kᵀ[r] g[r]`` with ``G_k[r] = F[m[r,k]]`` (zero where
``m[r,k] < 0``), as fp32 ``[Kd, Cin, Cout]``. The contraction runs over
the capacity-sized row axis under one fixed grouping: panels of
:data:`PANEL` rows from row 0, each adding its rows in row order from +0.0,
then the panel partials in panel order from +0.0 (the reference's
``chunked_rowdot`` idea). Appending zero rows only appends exact zeros, so
the weight gradients are bitwise equal across capacity buckets.

A port-only kernel (``csrc/dw_gather_gemm.cu``): the JAX reference
computes ``_dw_per_offset`` (``repro/core/dataflow.py``) in XLA, outside
any Pallas kernel. Built from ``torch.matmul`` panels the same grouping
costs one launch per panel, per offset, per layer; the kernel does all
offsets and panels of a layer in two launches. What bounds it and what its
design does about that is written at the top of the source.

:func:`dw_gather_gemm_torch` is the plain version: per offset, gather and
mask, then ``chunked_rowdot`` with the same panel; it runs on CPU tensors
and, for comparison, on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Rows per panel (a multiple of the kernel's 16-row step): the partials
# ([Kd · ⌈M/PANEL⌉, Cin, Cout] fp32) stay under 1 GB at M = 524,288,
# Kd = 27, 256 × 256 (906 MB).
PANEL = 4096

_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_ENTRY = {torch.float32: "spira_dw_gather_gemm_f32",
          torch.bfloat16: "spira_dw_gather_gemm_bf16"}
_fns: dict = {}


def chunked_rowdot(x: torch.Tensor, g: torch.Tensor, q: int = PANEL
                   ) -> torch.Tensor:
    """``xᵀ @ g`` over the row axis with a capacity-stable grouping: rows
    zero-padded to a multiple of ``q``, one ``[A, q] @ [q, B]`` fp32 matmul
    per panel (every panel the same shape), panel results added strictly
    in order from +0.0. Returns fp32 ``[A, B]``."""
    n, a = x.shape
    npad = -(-n // q) * q
    if npad != n:
        x = torch.cat([x, x.new_zeros((npad - n, a))])
        g = torch.cat([g, g.new_zeros((npad - n, g.shape[1]))])
    acc = torch.zeros((a, g.shape[1]), dtype=torch.float32, device=x.device)
    for p in range(npad // q):
        acc = acc + torch.matmul(x[p * q:(p + 1) * q].float().t(),
                                 g[p * q:(p + 1) * q].float())
    return acc


def dw_gather_gemm_torch(features: torch.Tensor, m: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Plain version: per offset, gather ``F[m[:, k]]``, zero the rows with
    ``m < 0`` and contract with ``g`` by :func:`chunked_rowdot` over
    :data:`PANEL`-row panels; fp32 ``[Kd, Cin, Cout]``."""
    out = []
    for k in range(m.shape[1]):
        col = m[:, k]
        gk = features[col.clamp(min=0).long()] * (col >= 0)[:, None].to(
            features.dtype)
        out.append(chunked_rowdot(gk, g, PANEL))
    return torch.stack(out)


def dw_gather_gemm(features: torch.Tensor, m: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (a CPU tensor raises). F
    [N, Cin] and g [M, Cout] of one dtype (fp32 or bf16), m int32 [M, Kd];
    returns fp32 [Kd, Cin, Cout]."""
    if features.device.type != "cuda":
        raise ValueError("dw_gather_gemm launches a CUDA kernel; got a "
                         f"tensor on {features.device}")
    dt = features.dtype
    if dt not in _ENTRY or g.dtype != dt:
        raise TypeError(f"features/gradient must both be fp32 or bf16, got "
                        f"{features.dtype}/{g.dtype}")
    if m.dtype != torch.int32:
        raise TypeError(f"kernel map must be int32, got {m.dtype}")
    M, Kd = m.shape
    Cin = features.shape[1]
    if g.shape[0] != M:
        raise ValueError(f"gradient rows {g.shape[0]} != map rows {M}")
    for t in (m, g):
        if t.device != features.device:
            raise ValueError("features, map and gradient must share a device")
    Cout = g.shape[1]
    dev = features.device
    features = features.contiguous()
    m = m.contiguous()
    g = g.contiguous()
    P = -(-M // PANEL)
    partial = torch.empty((Kd * P, Cin, Cout), dtype=torch.float32,
                          device=dev)
    out = torch.empty((Kd, Cin, Cout), dtype=torch.float32, device=dev)
    fn = _fns.get(dt)
    if fn is None:
        fn = _fns[dt] = _build.function(_ENTRY[dt], _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(features.data_ptr(), Cin, m.data_ptr(), M, Kd, g.data_ptr(),
             Cout, PANEL, partial.data_ptr(), out.data_ptr(), stream)
    dw_gather_gemm.launches += 1
    _build.check(err, "dw_gather_gemm")
    return out


dw_gather_gemm.launches = 0
