"""Windowed z-delta kernel-map searches: CUDA kernels + plain versions.

Two searches, as in ``repro/kernels/zdelta_window.py``. Both CUDA kernels
take int32 or int64 packed words (PAD is the type's maximum) and write the
map ``[M, G·K]`` and counters ``[M/128, G]`` as int32; the wrappers pick
the kernel by the words' dtype.

``zdelta_superwindow_search`` (the plan's default engine) replaces the TPU
kernel ``zdelta_superwindow_search`` (``_super_kernel``) with
``csrc/zdelta_superwindow.cu``, phase A included. Per 128-row output tile:
the window base is the lower bound of the tile's smallest query (first row
+ first anchor; anchors ascend) over the whole input array, clamped to
``[0, N − SW]``; ``arr[base : base + SW]`` is staged once for all G anchor
groups, and every (row, group) pair is resolved by a branchless binary
search (pos = window words < q) and a K-step two-pointer probe. It writes
the map (PAD output rows −1) and per-(tile, group) overflow counters:
queries of real rows above the window's last word, 0 when the window
reaches the array's end.

``zdelta_window_search`` (engine ``"zdelta_cuda_window"``, the per-group
baseline) replaces the TPU kernel ``zdelta_window_search`` (``_kernel``)
with ``csrc/zdelta_window.cu``. Phase A (torch): one ``searchsorted`` per
(tile, group) for the tile's first query of that group. The kernel: each
(row, member) query's match is the first position equal to it in the
cell's W-word window. Counters as above, per (tile, group).

``zdelta_repair`` re-searches the cells whose counter is nonzero with the
exact ``core.zdelta`` search, in place, on the card
(``csrc/zdelta_repair.cu``, port-only: the JAX package runs this repair in
XLA behind ``lax.cond``), so no host read decides whether a plan needs it.
On the H100 the three kernels are bound by bytes (the searches by the map,
the repair by the flagged cells); their design notes are in the sources. The plain versions (:func:`zdelta_superwindow_torch`,
:func:`zdelta_window_torch`) are vectorised over tiles, take the same
arguments as the kernels' wrappers, and reproduce their maps and counters
exactly; :func:`zdelta_repair_torch` is the repair's.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build
from .ops import resolve_backend
from ..core.voxel import CoordSet, pad_value

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (arr, n, outp, n_tiles, anchors, G, zstep, K, W, nbits, [starts,]
#  m_out, ovf_out, stream); the repair: (arr, n, outp, n_tiles, anchors, G,
#  zstep, K, ovf, m, stream)
_SIG = {"superwindow": [_P, _I, _P, _I, _P, _I, _L, _I, _I, _I, _P, _P, _P],
        "window": [_P, _I, _P, _I, _P, _I, _L, _I, _I, _I, _P, _P, _P, _P],
        "repair": [_P, _I, _P, _I, _P, _I, _L, _I, _P, _P, _P]}
_WORDS = {torch.int32: "i32", torch.int64: "i64"}
_fns: dict = {}
MAX_GROUPS = 128   # kMaxGroups in the superwindow source


def _nbits(W: int) -> int:
    """Binary-search steps over a W-word window."""
    return max(1, int(np.ceil(np.log2(W))))


# the launchers' shared-memory sizing (zdelta_common.cuh, the two .cu
# sources), mirrored so a window can be held to what a launch accepts
_MAX_SMEM = 227 * 1024          # kMaxSmem
_CHUNK_BUDGET = 32 * 1024       # kChunkBudget (both sources)
_SW_SLACK = 64                  # kSlack (superwindow)
_SPAN_BUDGET = 16 * 1024        # kSpanBudget (per-group window)


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def _staged_words(count: int, word: int) -> int:
    v = 16 // word
    return (count + 2 * v - 1) // v * v


def _smem_bytes(kind: str, word: int, G: int, K: int, nbits: int) -> int:
    """Shared memory a launch of ``kind`` asks for, plus the headroom its
    launcher keeps for static shared memory."""
    lg = 7
    while lg > 2 and (G * K * 4 << lg) > _CHUNK_BUDGET:
        lg -= 1
    chunk = _align16(G * K * 4 << lg)
    if kind == "superwindow":
        return (chunk + _staged_words(_SW_SLACK + (1 << nbits), word) * word
                + 4096)
    span = max(_SPAN_BUDGET // word, 1 << nbits)
    return (chunk + _align16(2 * G * 4) + _staged_words(span, word) * word
            + 2048)


def max_window(kind: str, dtype: torch.dtype, G: int, K: int) -> int:
    """The largest window ``kind``'s kernel ("superwindow" or "window")
    can stage for words of ``dtype`` with G anchor groups of K members: a
    launch stages the window padded to a power of two, so this is the
    largest power of two whose staging fits a block's shared memory
    (32,768 int32 or 16,384 int64 words)."""
    word = 8 if dtype == torch.int64 else 4
    for nbits in range(30, 0, -1):
        if _smem_bytes(kind, word, G, K, nbits) <= _MAX_SMEM:
            return 1 << nbits
    raise ValueError(f"no {kind} window fits G={G}, K={K}")


def _launcher(kind: str, arr: torch.Tensor, out2d: torch.Tensor):
    """The C entry point of ``kind``'s kernel for the words' dtype, after
    the checks every launch needs."""
    if arr.device.type != "cuda":
        raise ValueError(f"the {kind} wrapper launches a CUDA kernel; got a "
                         f"tensor on {arr.device}")
    word = _WORDS.get(arr.dtype)
    if word is None or out2d.dtype != arr.dtype:
        raise ValueError(f"the {kind} kernel takes int32 or int64 packed "
                         f"words of one dtype; got {arr.dtype} inputs and "
                         f"{out2d.dtype} outputs")
    if out2d.shape[1] != 128:
        raise ValueError(f"the CUDA {kind} kernel is compiled for 128-row "
                         f"tiles, got {out2d.shape[1]}")
    fn = _fns.get((kind, word))
    if fn is None:
        fn = _fns[(kind, word)] = _build.function(
            f"spira_zdelta_{kind}_{word}", _SIG[kind])
    return fn


def _window_bases(arr: torch.Tensor, out2d: torch.Tensor,
                  anchors: torch.Tensor) -> torch.Tensor:
    """Phase A of the superwindow search: insertion point of each tile's
    smallest query."""
    return torch.searchsorted(arr, out2d[:, 0] + anchors[0], side="left")


def zdelta_superwindow_torch(arr: torch.Tensor, out2d: torch.Tensor,
                             anchors: torch.Tensor, zstep: int, *, K: int,
                             SW: int, nbits: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the superwindow search (phases A and B) over all
    tiles at once: returns (map [n_tiles·bm, G·K] int32, overflow
    [n_tiles, G] int32)."""
    n = arr.shape[0]
    n_tiles, bm = out2d.shape
    G = anchors.shape[0]
    pad = pad_value(arr.dtype)
    dev = arr.device
    base = _window_bases(arr, out2d, anchors).clamp(0, n - SW)     # [T]
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
                            anchors: torch.Tensor, zstep: int, *, K: int,
                            SW: int, nbits: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA superwindow kernel (phases A and B) on CUDA int32 or
    int64 words; same contract as :func:`zdelta_superwindow_torch`."""
    fn = _launcher("superwindow", arr, out2d)
    n_tiles, bm = out2d.shape
    G = anchors.shape[0]
    if G > MAX_GROUPS:
        raise ValueError(f"{G} anchor groups > {MAX_GROUPS}")
    m = torch.empty((n_tiles * bm, G * K), dtype=torch.int32,
                    device=arr.device)
    ovf = torch.empty((n_tiles, G), dtype=torch.int32, device=arr.device)
    arr = arr.contiguous()
    out2d = out2d.contiguous()
    anchors = anchors.to(arr.dtype).contiguous()
    stream = torch.cuda.current_stream(arr.device).cuda_stream
    err = fn(arr.data_ptr(), arr.shape[0], out2d.data_ptr(), n_tiles,
             anchors.data_ptr(), G, int(zstep), K, SW, nbits,
             m.data_ptr(), ovf.data_ptr(), stream)
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
    nbits = _nbits(W)
    out2d = outputs.packed.reshape(mcap // bm, bm)
    anchors = packed_anchors.to(device=arr.device, dtype=arr.dtype)
    if resolve_backend(backend, arr):
        return zdelta_superwindow_cuda(arr, out2d, anchors, zstep, K=K,
                                       SW=W, nbits=nbits)
    return zdelta_superwindow_torch(arr, out2d, anchors, zstep, K=K, SW=W,
                                    nbits=nbits)


# ---------------------------------------------------------------------------
# per-group windows: one window per (tile, anchor group)
# ---------------------------------------------------------------------------

def zdelta_window_torch(arr: torch.Tensor, out2d: torch.Tensor,
                        anchors: torch.Tensor, starts: torch.Tensor,
                        zstep: int, *, K: int, W: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the per-group window search over all (tile, group)
    cells at once: returns (map [n_tiles·bm, G·K] int32, PAD rows −1;
    overflow [n_tiles, G] int32)."""
    n = arr.shape[0]
    n_tiles, bm = out2d.shape
    G = anchors.shape[0]
    dev = arr.device
    start = starts.to(torch.int64).clamp(0, n - W)                  # [T, G]
    win = arr[start[..., None] + torch.arange(W, device=dev)]      # [T, G, W]
    members = torch.arange(K, dtype=arr.dtype, device=dev) * zstep
    q = (out2d[:, None, :, None] + anchors[None, :, None, None]
         + members)                                             # [T, G, bm, K]
    real = (out2d != pad_value(arr.dtype))[:, None, :, None]
    pos = torch.searchsorted(win.reshape(n_tiles * G, W),
                             q.reshape(n_tiles * G, bm * K),
                             side="left").reshape(q.shape)
    at = torch.gather(win, 2, pos.clamp(max=W - 1).reshape(n_tiles, G, -1)
                      ).reshape(q.shape)
    hit = (pos < W) & (at == q) & real
    m = torch.where(hit, pos + start[:, :, None, None], -1)
    ovf = ((q > win[:, :, W - 1, None, None]) & real).sum(
        dim=(2, 3), dtype=torch.int32)
    ovf = torch.where(start + W < n, ovf, 0)
    m = m.permute(0, 2, 1, 3).reshape(n_tiles * bm, G * K)
    return m.to(torch.int32), ovf.to(torch.int32)


def zdelta_window_cuda(arr: torch.Tensor, out2d: torch.Tensor,
                       anchors: torch.Tensor, starts: torch.Tensor,
                       zstep: int, *, K: int, W: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA per-group window kernel on CUDA int32 or int64
    words; same contract as :func:`zdelta_window_torch`."""
    fn = _launcher("window", arr, out2d)
    n_tiles, bm = out2d.shape
    G = anchors.shape[0]
    m = torch.empty((n_tiles * bm, G * K), dtype=torch.int32,
                    device=arr.device)
    ovf = torch.empty((n_tiles, G), dtype=torch.int32, device=arr.device)
    arr = arr.contiguous()
    out2d = out2d.contiguous()
    anchors = anchors.to(arr.dtype).contiguous()
    starts = starts.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(arr.device).cuda_stream
    err = fn(arr.data_ptr(), arr.shape[0], out2d.data_ptr(), n_tiles,
             anchors.data_ptr(), G, int(zstep), K, W, _nbits(W),
             starts.data_ptr(), m.data_ptr(), ovf.data_ptr(), stream)
    zdelta_window_cuda.launches += 1
    _build.check(err, "zdelta_window")
    return m, ovf


zdelta_window_cuda.launches = 0


def zdelta_window_search(inputs: CoordSet, outputs: CoordSet,
                         packed_anchors: torch.Tensor, zstep: int, *,
                         K: int, W: int = 512, bm: int = 128,
                         backend: str = "auto"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel map [M, G·K] and overflow counters [M/bm, G] by the
    per-group window search (``packed_anchors`` [G], K² for a full
    search). ``outputs.capacity`` must be a multiple of ``bm`` and
    ``W <= inputs.capacity``."""
    from ..core.zdelta import _count_search
    _count_search()
    arr = inputs.packed
    n = arr.shape[0]
    mcap = outputs.packed.shape[0]
    if mcap % bm:
        raise ValueError(f"output capacity {mcap} is not a multiple of {bm}")
    if n < W:
        raise ValueError(f"input capacity {n} must be >= window {W}")
    out2d = outputs.packed.reshape(mcap // bm, bm)
    anchors = packed_anchors.to(device=arr.device, dtype=arr.dtype)
    starts = torch.searchsorted(arr, out2d[:, :1] + anchors[None, :],
                                side="left", out_int32=True)     # [T, G]
    if resolve_backend(backend, arr):
        return zdelta_window_cuda(arr, out2d, anchors, starts, zstep, K=K,
                                  W=W)
    return zdelta_window_torch(arr, out2d, anchors, starts, zstep, K=K, W=W)


# ---------------------------------------------------------------------------
# the overflow repair: overflowed (tile, group) cells re-searched exactly
# ---------------------------------------------------------------------------

def zdelta_repair_torch(arr: torch.Tensor, out2d: torch.Tensor,
                        anchors: torch.Tensor, zstep: int, m: torch.Tensor,
                        ovf: torch.Tensor, *, K: int) -> torch.Tensor:
    """Plain version of the repair: the map ``m`` [n_tiles·bm, G·K] with
    the entries of every (tile, group) cell whose counter ``ovf``
    [n_tiles, G] is nonzero replaced by the exact z-delta search's; a new
    tensor (the kernel writes ``m`` in place)."""
    from ..core.zdelta import zdelta_search_words
    bm = out2d.shape[1]
    exact = zdelta_search_words(arr, out2d.reshape(-1), anchors, zstep, K=K)
    bad = (ovf > 0).repeat_interleave(bm, dim=0).repeat_interleave(K, dim=1)
    return torch.where(bad, exact, m)


def zdelta_repair_cuda(arr: torch.Tensor, out2d: torch.Tensor,
                       anchors: torch.Tensor, zstep: int, m: torch.Tensor,
                       ovf: torch.Tensor, *, K: int) -> torch.Tensor:
    """Launch the CUDA repair kernel on CUDA int32 or int64 words: repairs
    ``m`` in place and returns it; same result as
    :func:`zdelta_repair_torch`."""
    fn = _launcher("repair", arr, out2d)
    n_tiles, bm = out2d.shape
    G = anchors.shape[0]
    if (m.dtype != torch.int32 or not m.is_contiguous()
            or tuple(m.shape) != (n_tiles * bm, G * K)):
        raise ValueError(f"the repair takes the search's contiguous int32 map "
                         f"[{n_tiles * bm}, {G * K}], got {m.dtype} "
                         f"{tuple(m.shape)}")
    if ovf.dtype != torch.int32 or tuple(ovf.shape) != (n_tiles, G):
        raise ValueError(f"the repair takes int32 counters [{n_tiles}, {G}], "
                         f"got {ovf.dtype} {tuple(ovf.shape)}")
    arr = arr.contiguous()
    out2d = out2d.contiguous()
    anchors = anchors.to(arr.dtype).contiguous()
    ovf = ovf.contiguous()
    stream = torch.cuda.current_stream(arr.device).cuda_stream
    err = fn(arr.data_ptr(), arr.shape[0], out2d.data_ptr(), n_tiles,
             anchors.data_ptr(), G, int(zstep), K, ovf.data_ptr(),
             m.data_ptr(), stream)
    zdelta_repair_cuda.launches += 1
    _build.check(err, "zdelta_repair")
    return m


zdelta_repair_cuda.launches = 0


def zdelta_repair(inputs: CoordSet, outputs: CoordSet,
                  packed_anchors: torch.Tensor, zstep: int, m: torch.Tensor,
                  ovf: torch.Tensor, *, K: int, bm: int = 128,
                  backend: str = "auto") -> torch.Tensor:
    """The map of a windowed search (``m`` [M, G·K], ``ovf`` [M/bm, G] as
    either search returns them, ``outputs`` the words it searched) with
    every overflowed cell re-searched exactly: on the card in place by the
    kernel, on the CPU by the plain version. Either way no host read."""
    arr = inputs.packed
    mcap = outputs.packed.shape[0]
    if mcap % bm:
        raise ValueError(f"output capacity {mcap} is not a multiple of {bm}")
    out2d = outputs.packed.reshape(mcap // bm, bm)
    anchors = packed_anchors.to(device=arr.device, dtype=arr.dtype)
    if resolve_backend(backend, arr):
        return zdelta_repair_cuda(arr, out2d, anchors, zstep, m, ovf, K=K)
    return zdelta_repair_torch(arr, out2d, anchors, zstep, m, ovf, K=K)
