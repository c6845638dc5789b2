"""One-shot z-delta search kernel-map construction (Spira §5.2), torch port
of ``repro.core.zdelta``.

The K³ offsets form K² z-delta groups of K offsets sharing (dx, dy) with dz
ascending by the input stride. Only each group's anchor query is resolved
by a binary search (``torch.searchsorted``); the K−1 other members are
resolved by a probe over consecutive positions, the cursor advancing only
on a hit. The probe is sound by the Integer Property: no packed value lies
strictly between ``a + r·s`` and ``a + (r+1)·s`` for inputs of stride s.

The hand-written CUDA form (one shared window per 128-row tile) is
``kernels.zdelta_window.zdelta_superwindow_search``; this module is the
exact reference the plan repairs window overflows with.
"""
from __future__ import annotations

import numpy as np
import torch

from .packing import BitLayout, offset_grid, pack_offsets
from .voxel import CoordSet, pad_value


# ---------------------------------------------------------------------------
# search-call counters (one per kernel-map search, on the obs registry)
# ---------------------------------------------------------------------------

_SEARCH_CALLS = None  # lazily bound registry counter


def _search_counter():
    global _SEARCH_CALLS
    if _SEARCH_CALLS is None:
        from ..obs import default_registry
        _SEARCH_CALLS = default_registry().counter("zdelta_search_calls")
    return _SEARCH_CALLS


def _count_search() -> None:
    _search_counter().inc()


def reset_search_calls() -> None:
    _search_counter().set(0)


def search_call_count() -> int:
    """Kernel-map searches run since the last reset."""
    return _search_counter().value


def zdelta_offsets(K: int, stride: int, layout: BitLayout, device=None
                   ) -> tuple[np.ndarray, torch.Tensor, int]:
    """Static per-layer offset data: raw offsets [K^3, 3] in z-delta group
    order, packed anchors [K^2] (on ``device``) and the packed z step."""
    offs = offset_grid(K, stride)
    anchors = offs.reshape(K * K, K, 3)[:, 0, :]
    packed_anchors = pack_offsets(anchors, layout, device=device)
    zstep = stride << layout.shift_z
    return offs, packed_anchors, zstep


def zdelta_search(inputs: CoordSet, outputs: CoordSet,
                  packed_anchors: torch.Tensor, zstep: int, *,
                  K: int) -> torch.Tensor:
    """Kernel map ``M[i, k] = j`` (or −1): int32 [cap(outputs), G·K],
    columns in z-delta group order (group g, member r → column g·K + r).
    G = K² for a full search; the §5.4 half-search passes the first
    ``symmetry_anchor_count(K)`` anchors. PAD output rows are −1."""
    _count_search()
    arr = inputs.packed
    n = arr.shape[0]
    pad = pad_value(arr.dtype)
    q0 = outputs.packed[:, None] + packed_anchors[None, :]   # wraps on PAD
    pos = torch.searchsorted(arr, q0, side="left", out_int32=True)
    cols = []
    cursor = pos
    query = q0
    for _ in range(K):
        cand = arr[cursor.clamp(0, n - 1)]
        hit = (cand == query) & (cursor < n) & (query != pad)
        cols.append(torch.where(hit, cursor, -1))
        cursor = cursor + hit.to(torch.int32)
        query = query + zstep
    m = torch.stack(cols, dim=-1).reshape(outputs.packed.shape[0], -1)
    valid_row = (outputs.packed != pad)[:, None]
    return torch.where(valid_row, m, -1).to(torch.int32)


def simple_bsearch(inputs: CoordSet, outputs: CoordSet,
                   packed_offsets: torch.Tensor, *, K: int) -> torch.Tensor:
    """The paper's Fig. 10 baseline: one full binary search
    (``torch.searchsorted``) per query, |Vq|·K³ of them, no
    pre-processing. ``packed_offsets`` [K³] in z-delta group order gives
    :func:`zdelta_search`'s column layout; PAD output rows are −1."""
    _count_search()
    arr = inputs.packed
    n = arr.shape[0]
    pad = pad_value(arr.dtype)
    q = outputs.packed[:, None] + packed_offsets[None, :]    # wraps on PAD
    pos = torch.searchsorted(arr, q, side="left", out_int32=True)
    cand = arr[pos.clamp(0, n - 1)]
    hit = (cand == q) & (pos < n) & (outputs.packed[:, None] != pad)
    return torch.where(hit, pos, -1).to(torch.int32)


def mirror_permutation(K: int) -> np.ndarray:
    """Column permutation δ → −δ under z-delta group order (a reversal)."""
    return np.arange(K * K * K - 1, -1, -1)


def symmetry_anchor_count(K: int) -> int:
    """Anchor groups a submanifold half-search needs: columns
    [0, ⌈K³/2⌉] live in groups [0, K²//2]."""
    return K * K // 2 + 1


def zdelta_search_symmetric(inputs: CoordSet, outputs: CoordSet,
                            packed_anchors: torch.Tensor, zstep, *,
                            K: int) -> torch.Tensor:
    """§5.4 half-search + mirror fill; bit-identical to
    :func:`zdelta_search`. Valid only when inputs == outputs."""
    g = symmetry_anchor_count(K)
    m = zdelta_search(inputs, outputs, packed_anchors[:g], zstep, K=K)
    return symmetrize_kernel_map(expand_half_map(m, K=K), K=K)


def expand_half_map(m_partial: torch.Tensor, *, K: int) -> torch.Tensor:
    """Pad a half-search map [M, symmetry_anchor_count(K)·K] to [M, K³]
    with −1 in every mirrored column."""
    k3 = K * K * K
    half = k3 // 2
    out = torch.full((m_partial.shape[0], k3), -1, dtype=torch.int32,
                     device=m_partial.device)
    out[:, : half + 1] = m_partial[:, : half + 1]
    return out


def symmetrize_kernel_map(m_half: torch.Tensor, *, K: int) -> torch.Tensor:
    """Fill column ``mirror(k)`` from ``M[i, k] = j ⇒ M[j, mirror(k)] = i``
    (Spira §5.4), one flat scatter for all searched columns; targets are
    collision-free. Valid only when outputs == inputs."""
    k3 = K * K * K
    half = k3 // 2
    mcap = m_half.shape[0]
    dev = m_half.device
    rows = torch.arange(mcap, dtype=torch.int32, device=dev)
    j = m_half[:, :half].to(torch.int64)
    mirror_cols = torch.arange(k3 - 1, k3 - 1 - half, -1, device=dev)
    # invalid entries go to a spare slot past the end, sliced off below
    flat = torch.where(j >= 0, j * k3 + mirror_cols[None, :], mcap * k3)
    out = torch.cat([m_half.reshape(-1).to(torch.int32),
                     torch.full((1,), -1, dtype=torch.int32, device=dev)])
    out[flat.reshape(-1)] = rows[:, None].expand(mcap, half).reshape(-1)
    return out[: mcap * k3].reshape(mcap, k3)
