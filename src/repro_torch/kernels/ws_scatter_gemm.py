"""Weight-stationary scatter-GEMM: CUDA kernel + plain version.

``out[i] = Σ_k F[m[i,k]] @ W[k]`` over the pairs that survive the
per-offset capacity (the first ``capacity`` valid rows of each column, in
row order), the terms of a row added in column order from +0.0, fp32
throughout; the result is fp32 ``[M, Cout]``, cast by the caller. Offset
k may read column ``cols[k]`` of a wider map (the hybrid dataflow's WS
columns), so no column subset is copied.

Replaces the TPU kernel ``repro/kernels/ws_scatter_gemm.py``
(``ws_scatter_gemm``, ``_kernel``) with ``csrc/ws_scatter_gemm.cu``, which
follows the TPU kernel's structure: an output block resident on chip,
swept over the offsets in order. A pack kernel writes, per panel of
:data:`PANEL` rows and offset, the panel's valid rows in row order and
their count (:class:`Pack`); at a lossy capacity a rank kernel scans the
counts over the panels into each list's kept prefix; the sweep kernel
keeps a panel's fp32 sums in shared memory and adds each kept offset's
tensor-core product once, offset after offset. No host sync, no table
sized by pairs. What bounds it on the H100 is written at the top of the
source. The three kernels are one port of the one TPU kernel and count
as one launch.

:func:`ws_scatter_gemm_torch` is the plain version — ``ws_xla`` in torch:
per column, the same capacity drop, a gather, ``torch.matmul`` in fp32,
and ``acc[rows] = acc[rows] + part`` (rows are unique within a column).
:func:`ws_pack_torch` is the plain version of the pack and rank kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

PANEL = 128                 # rows per panel (kPanel in the source)
TILES_N = (16, 32, 64, 96)  # the sweep's compiled Cout tiles

_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_PACK_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
_ENTRY = {torch.float32: "spira_ws_scatter_gemm_f32",
          torch.bfloat16: "spira_ws_scatter_gemm_bf16"}
_fns: dict = {}


class Pack(NamedTuple):
    """The kept pairs of a map under a capacity, per panel of
    :data:`PANEL` rows.

    ``rows`` uint8 ``[n_panels, Ks, PANEL]``: per (panel, offset) the
    panel's rows with a valid entry, in row order (slots past ``count``
    are undefined); ``count`` int32 ``[Ks, n_panels]``: their number;
    ``kept`` int32 ``[Ks, n_panels]``: how many of them the capacity keeps
    (a prefix of the list)."""

    rows: torch.Tensor
    count: torch.Tensor
    kept: torch.Tensor

    def kept_mask(self, M: int) -> torch.Tensor:
        """The kept pairs as a bool ``[M, Ks]`` mask (a check, not the
        kernel path: it syncs)."""
        n_p, Ks, R = self.rows.shape
        dev = self.rows.device
        sel = (torch.arange(R, device=dev)
               < self.kept.t()[..., None])               # [n_p, Ks, R]
        row = (self.rows.long()
               + R * torch.arange(n_p, device=dev)[:, None, None])
        col = torch.arange(Ks, device=dev)[None, :, None].expand_as(row)
        mask = torch.zeros((n_p * R, Ks), dtype=torch.bool, device=dev)
        mask[row[sel], col[sel]] = True
        return mask[:M]


def _columns(m: torch.Tensor, cols) -> torch.Tensor:
    return m if cols is None else m[:, torch.as_tensor(
        cols, device=m.device).long()]


def ws_pack_torch(m: torch.Tensor, capacity: int, cols=None) -> Pack:
    """Plain version of the pack and rank kernels: per panel and offset
    the rows with ``m[row, cols[k]] ≥ 0`` in row order, their count, and
    the kept prefix under ``capacity`` (its rank in the column: the counts
    of the panels above plus its place in the list)."""
    m = _columns(m, cols)
    M, Ks = m.shape
    n_p = -(-M // PANEL)
    dev = m.device
    valid = torch.zeros((n_p * PANEL, Ks), dtype=torch.bool, device=dev)
    valid[:M] = m >= 0
    v = valid.view(n_p, PANEL, Ks).permute(0, 2, 1)      # [n_p, Ks, R]
    count = v.sum(-1, dtype=torch.int32)
    # a stable sort puts the valid rows first, in row order
    order = torch.sort((~v).to(torch.uint8), dim=-1, stable=True).indices
    rows = torch.where(torch.arange(PANEL, device=dev) < count[..., None],
                       order, 0).to(torch.uint8)
    count = count.t().contiguous()
    before = torch.cumsum(count, dim=1, dtype=torch.int32) - count
    kept = (min(capacity, M) - before).clamp(min=0).minimum(count)
    kept = kept.to(torch.int32)
    return Pack(rows=rows.contiguous(), count=count, kept=kept)


def ws_scatter_gemm_torch(features: torch.Tensor, m: torch.Tensor,
                          weights: torch.Tensor, *, capacity: int,
                          cols=None) -> torch.Tensor:
    """Plain version: per column, keep the first ``capacity`` valid rows,
    multiply their gathered features by ``W[k]`` in fp32 and add the
    product into those rows of an fp32 accumulator; returns fp32."""
    m = _columns(m, cols)
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
    """The sweep's Cout tile: ``bn``, or the smallest of ``TILES_N`` that
    covers Cout, and 64 for wider layers (as the OS kernel's tile)."""
    if bn:
        return bn
    return next((t for t in TILES_N if cout <= t), 64)


def _map_args(m: torch.Tensor, cols, dev) -> tuple:
    """(map, its row length, columns on the card or None, Ks)."""
    if m.dtype != torch.int32:
        raise TypeError(f"kernel map must be int32, got {m.dtype}")
    if m.dim() != 2:
        raise ValueError(f"kernel map must be 2-D, got {tuple(m.shape)}")
    if m.device != dev:
        raise ValueError("features, map and weights must share a device")
    m = m.contiguous()
    if cols is None:
        return m, m.shape[1], None, m.shape[1]
    cols = torch.as_tensor(cols, dtype=torch.int32, device=dev).contiguous()
    if cols.dim() != 1:
        raise ValueError(f"cols must be 1-D, got {tuple(cols.shape)}")
    return m, m.shape[1], cols, cols.numel()


def _buffers(M: int, Ks: int, capacity: int, dev) -> tuple:
    n_p = -(-M // PANEL)
    rows = torch.empty((n_p, Ks, PANEL), dtype=torch.uint8, device=dev)
    count = torch.empty((Ks, n_p), dtype=torch.int32, device=dev)
    kept = torch.empty_like(count) if capacity < M else count
    return rows, count, kept


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def ws_pack_cuda(m: torch.Tensor, capacity: int, cols=None) -> Pack:
    """The pack (and, at a lossy capacity, rank) kernels alone on a CUDA
    map, for checks against :func:`ws_pack_torch`; the sweep's launch is
    :func:`ws_scatter_gemm`."""
    if m.device.type != "cuda":
        raise ValueError(f"ws_pack_cuda launches a CUDA kernel; got a tensor "
                         f"on {m.device}")
    m, ld, cols, Ks = _map_args(m, cols, m.device)
    M = m.shape[0]
    capacity = max(0, min(capacity, M))
    rows, count, kept = _buffers(M, Ks, capacity, m.device)
    fn = _fns.get("pack")
    if fn is None:
        fn = _fns["pack"] = _build.function("spira_ws_pack", _PACK_SIG)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = fn(m.data_ptr(), ld, _ptr(cols), M, Ks, capacity, rows.data_ptr(),
             count.data_ptr(), kept.data_ptr(), stream)
    ws_pack_cuda.launches += 1
    _build.check(err, "ws_pack")
    return Pack(rows=rows, count=count, kept=kept)


ws_pack_cuda.launches = 0


def ws_scatter_gemm(features: torch.Tensor, m: torch.Tensor,
                    weights: torch.Tensor, *, capacity: int,
                    bn: int = 0, cols=None) -> torch.Tensor:
    """Launch the CUDA kernels on CUDA tensors (a CPU tensor raises). F
    [N, Cin] and W [Ks, Cin, Cout] of one dtype (fp32 or bf16), m int32
    [M, Ks] or, with ``cols`` (Ks column indices), [M, ≥ Ks] read at those
    columns; ``bn`` is the Cout tile (0 = the smallest of 16/32/64/96 that
    covers Cout, 64 above 96). Returns fp32 [M, Cout]."""
    if features.device.type != "cuda":
        raise ValueError("ws_scatter_gemm launches a CUDA kernel; got a "
                         f"tensor on {features.device}")
    dt = features.dtype
    if dt not in _ENTRY or weights.dtype != dt:
        raise TypeError(f"features/weights must both be fp32 or bf16, got "
                        f"{features.dtype}/{weights.dtype}")
    dev = features.device
    m, ld, cols, Ks = _map_args(m, cols, dev)
    M = m.shape[0]
    N, Cin = features.shape
    if tuple(weights.shape[:2]) != (Ks, Cin):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"Ks={Ks}, Cin={Cin}")
    if weights.device != dev:
        raise ValueError("features, map and weights must share a device")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")
    Cout = weights.shape[-1]
    bn = _tile_n(Cout, bn)
    if bn not in TILES_N:
        raise ValueError(f"bn={bn}: the CUDA WS kernel is compiled for "
                         f"Cout tiles {TILES_N} (0 = auto)")
    capacity = min(capacity, M)
    features = features.contiguous()
    weights = weights.contiguous()
    rows, count, kept = _buffers(M, Ks, capacity, dev)
    out = torch.empty((M, Cout), dtype=torch.float32, device=dev)
    fn = _fns.get(dt)
    if fn is None:
        fn = _fns[dt] = _build.function(_ENTRY[dt], _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(features.data_ptr(), Cin, m.data_ptr(), ld, _ptr(cols), M, Ks,
             weights.data_ptr(), Cout, capacity, rows.data_ptr(),
             count.data_ptr(), kept.data_ptr(), out.data_ptr(), bn, stream)
    ws_scatter_gemm.launches += 1
    _build.check(err, "ws_scatter_gemm")
    return out


ws_scatter_gemm.launches = 0
