"""Output-stationary implicit-GEMM sparse convolution: CUDA kernel + plain
version.

``out[i] = Σ_k 1[m[i,k] ≥ 0] · F[m[i,k]] @ W[k]``, fp32 accumulation, the
gather fused into the kernel (no ``[M, Kd, Cin]`` intermediate).

Replaces the TPU kernel ``repro/kernels/spconv_gather_gemm.py``
(``spconv_gather_gemm``, ``_kernel``) with ``csrc/spconv_gather_gemm.cu``.
What bounds it on the H100 and what its design does about that is written
at the top of that source: the tensor cores through ``mma.sync`` (bf16
m16n8k16; fp32 as 3xTF32 on m16n8k8, which keeps fp32-class accuracy, so
the IEEE-fp32 reference contract holds), a 128-row tile by a Cout tile
from :func:`_tile_for`, per offset only the tile's rows that use it
(packed into 16-row fragments), a ``cp.async`` pipeline for those rows
and ``W[k]``. Each output element adds its terms in one fixed order
(offsets in order, each offset's sum over the Cin slices in order added
once to one accumulator), and the tile depends only on ``(Cin, Cout,
dtype)``, so a row's result depends on nothing but its own map row.

:func:`spconv_gather_gemm_torch` is the plain version — ``os_xla``'s
per-offset loop (gather, mask, ``torch.matmul`` into an fp32 accumulator)
— run on CPU tensors and, for comparison, on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILE_M = 128              # the kernel's compiled row tile (kBM)
TILES_N = (32, 64, 96)    # its compiled Cout tiles

_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
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


def _tile_for(cin: int, cout: int, dtype: torch.dtype) -> int:
    """The kernel's Cout tile for a layer: the smallest of ``TILES_N`` that
    covers Cout, and 64 for wider layers. The kernel is bound by the
    latency of its K-steps, so two blocks on an SM and more tiles per
    layer matter more than gathering the rows once per tile; a 128-wide
    block's accumulators would leave room for one. A function of the
    layer alone, never of M, so a row's add order is the same in every
    bucket and batch. ``cin`` and ``dtype`` are part of the key, though no
    choice depends on them yet."""
    del cin, dtype
    return next((t for t in TILES_N if cout <= t), 64)


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
             weights.data_ptr(), Cout, out.data_ptr(),
             _tile_for(Cin, Cout, dt), stream)
    spconv_gather_gemm.launches += 1
    _build.check(err, "spconv_gather_gemm")
    return out


spconv_gather_gemm.launches = 0
