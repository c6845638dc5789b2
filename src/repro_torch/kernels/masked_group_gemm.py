"""Masked grouped GEMM over a pre-gathered tensor: CUDA kernel + plain
version.

``out[i] = Σ_k 1[m[i,k] ≥ 0] · g[i,k] @ W[k]``, fp32 accumulation, the
result in g's dtype. The caller gathers ``g[i, k, :] = F[max(m[i,k], 0)]``
into an ``[M, Kd, Cin]`` tensor first (``ops.output_stationary_fused``):
this is the unfused output-stationary baseline, which pays the gathered
tensor's write and re-read that the implicit-GEMM kernel
(``spconv_gather_gemm``) avoids.

Replaces the TPU kernel ``repro/kernels/masked_group_gemm.py``
(``masked_group_gemm``, ``_kernel``) with ``csrc/masked_group_gemm.cu``.
What bounds it on the H100 and what its design does about that is written
at the top of that source: one streaming GEMM of g as ``[M, Kd·Cin]`` by
W as ``[Kd·Cin, Cout]`` on the tensor cores (bf16 m16n8k16; fp32 as
3xTF32), a 128-row tile by the Cout tile of :func:`_tile_for`, a 3-stage
ring loaded by TMA (``cp.async`` where a row pitch is not a multiple of
16 bytes), the mask multiplied into the A fragments in registers (never a
skip of a non-finite value), flat-column (k-then-Cin) add order.

:func:`masked_group_gemm_torch` is the plain version — the reference's
``masked_group_gemm_ref`` in torch: mask, then one fp32 einsum.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILES_N = (32, 64, 96, 128)   # the kernel's compiled Cout tiles

_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
_ENTRY = {torch.float32: "spira_masked_group_gemm_f32",
          torch.bfloat16: "spira_masked_group_gemm_bf16"}
_fns: dict = {}


def masked_group_gemm_torch(m: torch.Tensor, gathered: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """Plain version: zero the gathered rows with ``m < 0`` (a multiply, as
    the reference), contract ``mkc,kcd->md`` in fp32; the result in the
    gathered tensor's dtype."""
    g = gathered * (m >= 0)[..., None].to(gathered.dtype)
    return torch.einsum("mkc,kcd->md", g.float(),
                        weights.float()).to(gathered.dtype)


def _tile_for(cout: int) -> int:
    """The kernel's Cout tile: the smallest of ``TILES_N`` that covers
    Cout, else 128 (Cout 256 runs two tiles side by side, which read each
    row of g from device memory once between them)."""
    return next((t for t in TILES_N if cout <= t), TILES_N[-1])


def masked_group_gemm(m: torch.Tensor, gathered: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (a CPU tensor raises). m
    int32 [M, Kd], gathered [M, Kd, Cin] and W [Kd, Cin, Cout] of one dtype
    (fp32 or bf16); returns [M, Cout] in that dtype."""
    if gathered.device.type != "cuda":
        raise ValueError("masked_group_gemm launches a CUDA kernel; got a "
                         f"tensor on {gathered.device}")
    dt = gathered.dtype
    if dt not in _ENTRY or weights.dtype != dt:
        raise TypeError(f"gathered/weights must both be fp32 or bf16, got "
                        f"{gathered.dtype}/{weights.dtype}")
    if m.dtype != torch.int32:
        raise TypeError(f"kernel map must be int32, got {m.dtype}")
    M, Kd, Cin = gathered.shape
    if tuple(m.shape) != (M, Kd) or tuple(weights.shape[:2]) != (Kd, Cin):
        raise ValueError(f"shapes do not match: m {tuple(m.shape)}, "
                         f"gathered {tuple(gathered.shape)}, weights "
                         f"{tuple(weights.shape)}")
    for t in (m, weights):
        if t.device != gathered.device:
            raise ValueError("map, gathered tensor and weights must share a "
                             "device")
    Cout = weights.shape[-1]
    m = m.contiguous()
    gathered = gathered.contiguous()
    weights = weights.contiguous()
    out = torch.empty((M, Cout), dtype=dt, device=gathered.device)
    fn = _fns.get(dt)
    if fn is None:
        fn = _fns[dt] = _build.function(_ENTRY[dt], _SIG)
    stream = torch.cuda.current_stream(gathered.device).cuda_stream
    err = fn(m.data_ptr(), gathered.data_ptr(), M, Kd, Cin,
             weights.data_ptr(), Cout, out.data_ptr(), _tile_for(Cout),
             stream)
    masked_group_gemm.launches += 1
    _build.check(err, "masked_group_gemm")
    return out


masked_group_gemm.launches = 0
