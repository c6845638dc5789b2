"""Weight-stationary scatter-GEMM: CUDA kernel + plain version.

``out[i] = Σ_k F[m[i,k]] @ W[k]`` over the pairs that survive the
per-offset capacity (the first ``capacity`` valid rows of each column, in
row order), the terms of a row added in column order from +0.0, fp32
throughout; the result is fp32 ``[M, Cout]``, cast by the caller.

Replaces the TPU kernel ``repro/kernels/ws_scatter_gemm.py``
(``ws_scatter_gemm``, ``_kernel``) with ``csrc/ws_scatter_gemm.cu``. The
TPU kernel orders its merge by sweeping (offset, chunk) on a sequential
grid with the output block resident in VMEM; here the compaction
(:func:`ws_compaction`, int32 torch ops as the reference's are XLA) builds
a flat pair table, pass A computes one fp32 partial row per kept pair and
pass B merges each output row's partials in column order, with no atomics.
What bounds it on the H100 and what the design does about that is written
at the top of the source. Both passes are one port of the one TPU kernel
and count as one launch.

:func:`ws_scatter_gemm_torch` is the plain version — ``ws_xla`` in torch:
per column, the same capacity drop, a gather, ``torch.matmul`` in fp32,
and ``acc[rows] = acc[rows] + part`` (rows are unique within a column).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

CHUNK = 64          # pairs per block of pass A (kBP in the source)
TILES_N = (16, 32, 64)  # compiled Cout tiles (16 * TN)

_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_ENTRY = {torch.float32: "spira_ws_scatter_gemm_f32",
          torch.bfloat16: "spira_ws_scatter_gemm_bf16"}
_fns: dict = {}


class Compaction(NamedTuple):
    """The kept pairs of a map under a capacity, as flat tables.

    ``pin`` [P]: input row of each kept pair, ordered by (offset, position
    in the column); ``cnt`` [Ks]: kept pairs per offset; ``choff`` [Ks]:
    first pair of each offset; ``pidx`` [M, Ks]: pair index of (row,
    offset), −1 where the pair is absent or dropped."""

    pin: torch.Tensor
    cnt: torch.Tensor
    choff: torch.Tensor
    pidx: torch.Tensor


def ws_compaction(m: torch.Tensor, capacity: int) -> Compaction:
    """Per-offset compaction of ``m`` [M, Ks] to ``capacity`` pairs per
    column (first valid rows in row order survive), in int32."""
    # offset-major [Ks, M]: the column scans run along contiguous rows; a
    # scan over the outer dimension of [M, Ks] took ~90 ms per call on the
    # card (PERF.md)
    valid = (m.t() >= 0).contiguous()
    rank = torch.cumsum(valid, dim=1, dtype=torch.int32)   # 1-based in column
    kept = valid & (rank <= capacity)
    cnt = kept.sum(dim=1, dtype=torch.int32)
    choff = (torch.cumsum(cnt, dim=0, dtype=torch.int32) - cnt).to(torch.int32)
    pidx = torch.where(kept, choff[:, None] + rank - 1,
                       torch.full((), -1, dtype=torch.int32, device=m.device))
    pin = m.t()[kept].contiguous()                         # (offset, rank)
    return Compaction(pin=pin, cnt=cnt, choff=choff,
                      pidx=pidx.t().contiguous())


def ws_scatter_gemm_torch(features: torch.Tensor, m: torch.Tensor,
                          weights: torch.Tensor, *, capacity: int
                          ) -> torch.Tensor:
    """Plain version: per column, keep the first ``capacity`` valid rows,
    multiply their gathered features by ``W[k]`` in fp32 and add the
    product into those rows of an fp32 accumulator; returns fp32."""
    acc = torch.zeros((m.shape[0], weights.shape[-1]), dtype=torch.float32,
                      device=features.device)
    for k in range(m.shape[1]):
        col = m[:, k]
        valid = col >= 0
        kept = valid & (torch.cumsum(valid, dim=0) <= capacity)
        rows = torch.nonzero(kept).squeeze(1)
        if rows.numel() == 0:
            continue
        part = torch.matmul(features[col[rows].long()].float(),
                            weights[k].float())
        acc[rows] = acc[rows] + part
    return acc


def _tile_n(cout: int, bn: int) -> int:
    if bn:
        return bn
    return next((t for t in TILES_N if cout <= t), TILES_N[-1])


def ws_scatter_gemm(features: torch.Tensor, m: torch.Tensor,
                    weights: torch.Tensor, *, capacity: int,
                    bn: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (a CPU tensor raises). F
    [N, Cin] and W [Ks, Cin, Cout] of one dtype (fp32 or bf16), m int32
    [M, Ks]; ``bn`` is the Cout tile (0 = the smallest of 16/32/64 that
    covers Cout). Returns fp32 [M, Cout]."""
    if features.device.type != "cuda":
        raise ValueError("ws_scatter_gemm launches a CUDA kernel; got a "
                         f"tensor on {features.device}")
    dt = features.dtype
    if dt not in _ENTRY or weights.dtype != dt:
        raise TypeError(f"features/weights must both be fp32 or bf16, got "
                        f"{features.dtype}/{weights.dtype}")
    if m.dtype != torch.int32:
        raise TypeError(f"kernel map must be int32, got {m.dtype}")
    M, Ks = m.shape
    N, Cin = features.shape
    if weights.shape[:2] != (Ks, Cin):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"Ks={Ks}, Cin={Cin}")
    for t in (m, weights):
        if t.device != features.device:
            raise ValueError("features, map and weights must share a device")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")
    bn = _tile_n(weights.shape[-1], bn)
    if bn not in TILES_N:
        raise ValueError(f"bn={bn}: the CUDA WS kernel is compiled for "
                         f"Cout tiles {TILES_N} (0 = auto)")
    Cout = weights.shape[-1]
    dev = features.device
    c = ws_compaction(m, capacity)
    n_ch = (c.cnt + (CHUNK - 1)) // CHUNK
    chunk_off = torch.zeros(Ks + 1, dtype=torch.int32, device=dev)
    chunk_off[1:] = torch.cumsum(n_ch, dim=0)
    n_chunks = int(chunk_off[-1])
    features = features.contiguous()
    weights = weights.contiguous()
    partial = torch.empty((c.pin.numel(), Cout), dtype=torch.float32,
                          device=dev)
    out = torch.empty((M, Cout), dtype=torch.float32, device=dev)
    fn = _fns.get(dt)
    if fn is None:
        fn = _fns[dt] = _build.function(_ENTRY[dt], _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(features.data_ptr(), Cin, c.pin.data_ptr(), c.cnt.data_ptr(),
             c.choff.data_ptr(), chunk_off.data_ptr(), Ks, n_chunks,
             weights.data_ptr(), Cout, bn // 16, partial.data_ptr(),
             c.pidx.data_ptr(), M, out.data_ptr(), stream)
    ws_scatter_gemm.launches += 1
    _build.check(err, "ws_scatter_gemm")
    return out


ws_scatter_gemm.launches = 0
