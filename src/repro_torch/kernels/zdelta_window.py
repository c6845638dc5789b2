"""Superwindow z-delta kernel-map search: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/zdelta_window.py``
(``zdelta_superwindow_search``, ``_super_kernel``) with
``csrc/zdelta_superwindow.cu``.

Phase A (torch, as it is XLA in the reference): one ``searchsorted`` per
128-row output tile for the tile's smallest query (first row + first
anchor; anchors ascend) gives the window base, clamped to ``[0, N − SW]``.

Phase B (the kernel): one block per tile stages ``arr[base : base + SW]``
in shared memory once for all G anchor groups, then resolves every
(row, group) pair with a branchless binary search (pos = window words < q)
and a K-step two-pointer probe. It writes the map ``[M, G·K]`` (PAD output
rows −1) and per-(tile, group) overflow counters: queries of real rows
above the window's last word, 0 when the window reaches the array's end.
The plan repairs overflowed cells with the exact ``core.zdelta`` search.

On the H100 the kernel is bound by bytes (the map it writes); its design
note is in the source. The CUDA kernel takes int32 packed words; an int64
CUDA tensor raises (ROADMAP Queue 2). :func:`zdelta_superwindow_torch` is
the plain version, vectorised over tiles, for both dtypes: it reproduces
the kernel's map and counters exactly.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build
from .ops import resolve_backend
from ..core.voxel import CoordSet, pad_value

_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
_fns: dict = {}
MAX_GROUPS = 128   # kMaxGroups in the source


def _window_bases(arr: torch.Tensor, out2d: torch.Tensor,
                  anchors: torch.Tensor) -> torch.Tensor:
    """Phase A: insertion point of each tile's smallest query, int32."""
    return torch.searchsorted(arr, out2d[:, 0] + anchors[0], side="left",
                              out_int32=True)


def zdelta_superwindow_torch(arr: torch.Tensor, out2d: torch.Tensor,
                             anchors: torch.Tensor, starts: torch.Tensor,
                             zstep: int, *, K: int, SW: int, nbits: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of phase B over all tiles at once: returns
    (map [n_tiles·bm, G·K] int32, overflow [n_tiles, G] int32)."""
    n = arr.shape[0]
    n_tiles, bm = out2d.shape
    G = anchors.shape[0]
    pad = pad_value(arr.dtype)
    dev = arr.device
    base = starts.to(torch.int64).clamp(0, n - SW)                  # [T]
    win = arr[base[:, None] + torch.arange(SW, device=dev)]          # [T, SW]
    real = (out2d != pad)[:, :, None]                                # [T, bm, 1]
    q = out2d[:, :, None] + anchors[None, None, :]                   # [T, bm, G]
    pos = torch.zeros(q.shape, dtype=torch.int64, device=dev)
    for sbit in reversed(range(nbits)):
        cand = pos + (1 << sbit)
        vals = torch.gather(win, 1, (cand - 1).clamp(0, SW - 1)
                            .reshape(n_tiles, -1)).reshape(q.shape)
        pos = torch.where((cand <= SW) & (vals < q), cand, pos)
    last_val = win[:, SW - 1][:, None, None]
    ovf = torch.zeros((n_tiles, G), dtype=torch.int32, device=dev)
    cursor = pos
    cols = []
    for _ in range(K):
        cand = torch.gather(win, 1, cursor.clamp(0, SW - 1)
                            .reshape(n_tiles, -1)).reshape(q.shape)
        hit = (cand == q) & (cursor < SW) & real
        cols.append(torch.where(hit, cursor + base[:, None, None], -1))
        ovf += ((q > last_val) & real).sum(dim=1, dtype=torch.int32)
        cursor = cursor + hit.to(torch.int64)
        q = q + zstep
    ovf = torch.where((base + SW < n)[:, None], ovf, 0)
    m = torch.stack(cols, dim=-1).reshape(n_tiles * bm, G * K)
    return m.to(torch.int32), ovf.to(torch.int32)


def zdelta_superwindow_cuda(arr: torch.Tensor, out2d: torch.Tensor,
                            anchors: torch.Tensor, starts: torch.Tensor,
                            zstep: int, *, K: int, SW: int, nbits: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (phase B) on CUDA int32 tensors; same
    contract as :func:`zdelta_superwindow_torch`."""
    if arr.device.type != "cuda":
        raise ValueError("zdelta_superwindow_cuda launches a CUDA kernel; "
                         f"got a tensor on {arr.device}")
    if arr.dtype != torch.int32:
        raise NotImplementedError(
            f"the CUDA superwindow kernel takes int32 packed words; {arr.dtype}"
            " layouts (> 31 bits) run only the plain version (ROADMAP Queue 2)")
    n_tiles, bm = out2d.shape
    G = anchors.shape[0]
    if bm != 128:
        raise ValueError(f"the CUDA superwindow kernel is compiled for "
                         f"128-row tiles, got {bm}")
    if G > MAX_GROUPS:
        raise ValueError(f"{G} anchor groups > {MAX_GROUPS}")
    m = torch.empty((n_tiles * bm, G * K), dtype=torch.int32,
                    device=arr.device)
    ovf = torch.empty((n_tiles, G), dtype=torch.int32, device=arr.device)
    fn = _fns.get("fn")
    if fn is None:
        fn = _fns["fn"] = _build.function("spira_zdelta_superwindow_i32", _SIG)
    arr = arr.contiguous()
    out2d = out2d.contiguous()
    anchors = anchors.to(torch.int32).contiguous()
    starts = starts.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(arr.device).cuda_stream
    err = fn(arr.data_ptr(), arr.shape[0], out2d.data_ptr(), n_tiles,
             anchors.data_ptr(), G, int(zstep), K, SW, nbits,
             starts.data_ptr(), m.data_ptr(), ovf.data_ptr(), stream)
    zdelta_superwindow_cuda.launches += 1
    _build.check(err, "zdelta_superwindow")
    return m, ovf


zdelta_superwindow_cuda.launches = 0


def zdelta_superwindow_search(inputs: CoordSet, outputs: CoordSet,
                              packed_anchors: torch.Tensor, zstep: int, *,
                              K: int, W: int = 2048, bm: int = 128,
                              backend: str = "auto"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel map [M, G·K] and overflow counters [M/bm, G] by the
    superwindow search; ``packed_anchors`` [G] is any ascending anchor
    subset (K² for a full search). ``outputs.capacity`` must be a multiple
    of ``bm`` and ``W <= inputs.capacity``."""
    from ..core.zdelta import _count_search
    _count_search()
    arr = inputs.packed
    n = arr.shape[0]
    mcap = outputs.packed.shape[0]
    if mcap % bm:
        raise ValueError(f"output capacity {mcap} is not a multiple of {bm}")
    if n < W:
        raise ValueError(f"input capacity {n} must be >= superwindow {W}")
    nbits = max(1, int(np.ceil(np.log2(W))))
    out2d = outputs.packed.reshape(mcap // bm, bm)
    anchors = packed_anchors.to(device=arr.device, dtype=arr.dtype)
    starts = _window_bases(arr, out2d, anchors)
    if resolve_backend(backend, arr):
        return zdelta_superwindow_cuda(arr, out2d, anchors, starts, zstep,
                                       K=K, SW=W, nbits=nbits)
    return zdelta_superwindow_torch(arr, out2d, anchors, starts, zstep,
                                    K=K, SW=W, nbits=nbits)
