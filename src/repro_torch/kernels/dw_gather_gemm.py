"""Weight gradient of a sparse convolution per offset, gather fused in:
CUDA kernel + plain version.

``dW[k] = Σ_r G_kᵀ[r] g[r]`` with ``G_k[r] = F[m[r,k]]`` (zero where
``m[r,k] < 0``), as fp32 ``[Kd, Cin, Cout]``. The contraction runs over
the capacity-sized row axis under one fixed grouping: panels of
:data:`PANEL` rows from row 0, each panel's sum a function of its own
valid rows alone, then the panel partials in panel order from +0.0 (the
reference's ``chunked_rowdot`` idea). PAD rows appended by a larger
capacity bucket carry ``m = -1`` and change no panel's rows, so the weight
gradients are bitwise equal across buckets.

A port-only kernel (``csrc/dw_gather_gemm.cu``): the JAX reference
computes ``_dw_per_offset`` (``repro/core/dataflow.py``) in XLA, outside
any Pallas kernel. On the card one call packs each (offset, panel)'s valid
rows, multiplies them on the tensor cores (bf16 ``mma.sync``; fp32 as
3xTF32, each 16 rows summed apart and added in round-to-nearest fp32)
through a ``cp.async`` ring, and combines the panels; the source's header
says what bounds it and how. :func:`_tile_for` picks the Cin × Cout tile
from the layer, never from M. :func:`panel_counts` is the pack pass's
per-panel row count in torch, for the work the kernel multiplies.

:func:`dw_gather_gemm_torch` is the plain version: per offset, gather and
mask, then ``chunked_rowdot`` with the same panel; it runs on CPU tensors
and, for comparison, on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Rows per panel (the kernel's compiled kPanel; a panel's rows are indexed
# by 16 bits): the partials ([Kd · ⌈M/PANEL⌉, Cin, Cout] fp32) stay under
# 1 GB at M = 524,288, Kd = 27, 256 × 256 (906 MB).
PANEL = 4096
TILE_UNITS = (1, 2, 3)     # compiled tile widths, in units of 32 channels

_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
_ENTRY = {torch.float32: "spira_dw_gather_gemm_f32",
          torch.bfloat16: "spira_dw_gather_gemm_bf16"}
_fns: dict = {}


def _units(c: int) -> int:
    """Tile width (in 32-channel units) for ``c`` channels: the one of
    :data:`TILE_UNITS` whose tiles pad ``c`` least, the wider on a tie."""
    return min(TILE_UNITS, key=lambda n: (-(-c // (32 * n)) * 32 * n, -n))


def _tile_for(cin: int, cout: int, dtype: torch.dtype) -> tuple:
    """The kernel's Cin × Cout tile for a layer, as (MI, NI) units of 32:
    one tile up to 96 channels (the stem's 4 input channels run a 32-row
    tile, a 96 × 96 layer one tile that reads each gathered row once), 64
    for 128 and 256. A function of the layer alone, never of M, so a
    panel's add order is the same in every bucket. ``dtype`` is part of
    the key, though no choice depends on it yet."""
    del dtype
    return _units(cin), _units(cout)


def panel_counts(m: torch.Tensor, q: int = PANEL) -> torch.Tensor:
    """Valid map entries per (offset, panel), int64 ``[Kd, ⌈M/q⌉]``: the
    rows the pack pass lists for each unit of the kernel's work. Appended
    ``m = -1`` rows add empty panels and change no count."""
    M, Kd = m.shape
    P = -(-M // q)
    valid = torch.zeros((P * q, Kd), dtype=torch.int64, device=m.device)
    valid[:M] = m >= 0
    return valid.view(P, q, Kd).sum(1).t()


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
    mi, ni = _tile_for(Cin, Cout, dt)
    # counters; per (k, panel) its count, work item and up to PANEL / 32
    # sub-panel counts; the packed lists (int32 map entries, 16-bit rows)
    kp = Kd * P
    words = 2 + kp * (2 + PANEL // 32 + PANEL) + -(-kp * PANEL // 2)
    ws = torch.empty(words, dtype=torch.int32, device=dev)
    partial = torch.empty((Kd * P, Cin, Cout), dtype=torch.float32,
                          device=dev)
    out = torch.empty((Kd, Cin, Cout), dtype=torch.float32, device=dev)
    fn = _fns.get(dt)
    if fn is None:
        fn = _fns[dt] = _build.function(_ENTRY[dt], _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(features.data_ptr(), Cin, m.data_ptr(), M, Kd, g.data_ptr(),
             Cout, PANEL, mi, ni, ws.data_ptr(), partial.data_ptr(),
             out.data_ptr(), stream)
    dw_gather_gemm.launches += 1
    _build.check(err, "dw_gather_gemm")
    return out


dw_gather_gemm.launches = 0
