"""Output-stationary implicit-GEMM sparse convolution: CUDA kernel + plain
version.

``out[i] = Σ_k 1[m[i,k] ≥ 0] · F[m[i,k]] @ W[k]``, fp32 accumulation, the
gather fused into the kernel (no ``[M, Kd, Cin]`` intermediate).

Replaces the TPU kernel ``repro/kernels/spconv_gather_gemm.py``
(``spconv_gather_gemm``, ``_kernel``) with ``csrc/spconv_gather_gemm.cu``.
What bounds it on the H100 and what its design does about that is written
at the top of that source: FMA-bound on CUDA cores in fp32 for the wide
layers (the contract is IEEE fp32, so no TF32 tensor cores), a 64×64 block
tile with a 4×4 register tile per thread, offsets unused by a whole tile
skipped. Each output element adds its terms in one fixed order (k outer,
Cin inner), so a row's result depends on nothing but its own map row.

:func:`spconv_gather_gemm_torch` is the plain version — ``os_xla``'s
per-offset loop (gather, mask, ``torch.matmul`` into an fp32 accumulator)
— run on CPU tensors and, for comparison, on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILE = 64   # the kernel's compiled row and channel tile (kBM = kBN)

_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
_ENTRY = {torch.float32: "spira_spconv_gather_gemm_f32",
          torch.bfloat16: "spira_spconv_gather_gemm_bf16"}
_fns: dict = {}


def spconv_gather_gemm_torch(features: torch.Tensor, m: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Plain version: per offset, gather the input rows, zero those with
    ``m < 0``, and add their product with ``W[k]`` into an fp32
    accumulator; the result in the features' dtype."""
    acc = torch.zeros((m.shape[0], weights.shape[-1]), dtype=torch.float32,
                      device=features.device)
    for k in range(m.shape[1]):
        col = m[:, k]
        g = features[col.clamp(min=0).long()] * (col >= 0)[:, None].to(
            features.dtype)
        acc = acc + torch.matmul(g.float(), weights[k].float())
    return acc.to(features.dtype)


def spconv_gather_gemm(features: torch.Tensor, m: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (a CPU tensor raises). F
    [N, Cin] and W [Kd, Cin, Cout] of one dtype (fp32 or bf16), m int32
    [M, Kd]; returns [M, Cout] in F's dtype."""
    if features.device.type != "cuda":
        raise ValueError("spconv_gather_gemm launches a CUDA kernel; got a "
                         f"tensor on {features.device}")
    dt = features.dtype
    if dt not in _ENTRY or weights.dtype != dt:
        raise TypeError(f"features/weights must both be fp32 or bf16, got "
                        f"{features.dtype}/{weights.dtype}")
    if m.dtype != torch.int32:
        raise TypeError(f"kernel map must be int32, got {m.dtype}")
    M, Kd = m.shape
    N, Cin = features.shape
    if weights.shape[:2] != (Kd, Cin):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"Kd={Kd}, Cin={Cin}")
    for t in (m, weights):
        if t.device != features.device:
            raise ValueError("features, map and weights must share a device")
    Cout = weights.shape[-1]
    features = features.contiguous()
    m = m.contiguous()
    weights = weights.contiguous()
    out = torch.empty((M, Cout), dtype=dt, device=features.device)
    fn = _fns.get(dt)
    if fn is None:
        fn = _fns[dt] = _build.function(_ENTRY[dt], _SIG)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = fn(features.data_ptr(), Cin, m.data_ptr(), M, Kd,
             weights.data_ptr(), Cout, out.data_ptr(), stream)
    spconv_gather_gemm.launches += 1
    _build.check(err, "spconv_gather_gemm")
    return out


spconv_gather_gemm.launches = 0
