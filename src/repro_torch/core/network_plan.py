"""Network-wide voxel indexing (Spira §5.5), torch port of
``repro.core.network_plan``.

Downsampled coordinates have the closed form ``V_m = floor(V_0 / 2^m) ·
2^m`` (Eq. 1), so every layer's indexing is independent of every other
layer's and of all feature computation. :func:`build_network_plan`
computes every level's coordinate set and every layer's kernel map from V0
up front, with one true sort; the feature pass then only reads the maps.

Engines:

* ``"zdelta"`` — the z-delta search in torch (``core.zdelta``), the JAX
  package's ``"zdelta"``;
* ``"zdelta_cuda"`` — the superwindow search kernel
  (``kernels.zdelta_window``; the plain version on CPU tensors), the JAX
  package's ``"zdelta_pallas"``;
* ``"zdelta_cuda_window"`` — the per-group window search kernel (one
  window per (tile, anchor group)), the JAX package's
  ``"zdelta_pallas_window"``: the baseline the superwindow search is
  measured against. As there, it never takes the §5.4 symmetric
  half-search.

On both kernel engines, cells whose queries ran past their window are
repaired with the exact ``"zdelta"`` search, so the map is exact either
way; ``NetworkPlan.stats`` counts the repaired cells per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from .kernel_map import KernelMap
from .packing import BitLayout
from .spconv import SpConvSpec
from .voxel import CoordSet, build_coord_set, downsample_all, pad_value
from .zdelta import (expand_half_map, symmetrize_kernel_map,
                     symmetry_anchor_count, zdelta_offsets, zdelta_search,
                     zdelta_search_symmetric)

ENGINES = ("zdelta", "zdelta_cuda", "zdelta_cuda_window")


@dataclasses.dataclass
class NetworkPlan:
    """All coordinate sets (by stride level) + all kernel maps (by layer).

    ``stats`` holds per layer the number of window (tile, group) cells
    that overflowed their window and were repaired by the exact search (an
    int32 0-d tensor; 0 for the ``"zdelta"`` engine). A persistent nonzero
    count means the window is undersized for the traffic."""

    coords: Dict[int, CoordSet]
    kmaps: Dict[str, KernelMap]
    stats: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def plan_levels(specs: Sequence[SpConvSpec]) -> Tuple[int, ...]:
    lv = set()
    for s in specs:
        lv.add(s.m_in)
        lv.add(s.m_out)
    return tuple(sorted(lv))


PLAN_BM = 128   # output-tile rows of the windowed searches


def _kernel_map_search(inputs: CoordSet, outputs: CoordSet,
                       anchors: torch.Tensor, zstep: int, *, K: int,
                       W: int = 0, superwindow: bool = True,
                       backend: str = "auto"):
    """Superwindow (or per-group window) search with the per-cell overflow
    repair: cells whose queries ran past their window are recomputed by
    :func:`zdelta_search`. Outputs are PAD-padded to a multiple of
    ``PLAN_BM`` so the kernel runs full tiles; the map is sliced back.
    Returns ``(map, overflowed cells)``."""
    from ..kernels.zdelta_window import (zdelta_superwindow_search,
                                         zdelta_window_search)

    mcap = outputs.packed.shape[0]
    bm = PLAN_BM
    mcap2 = -(-mcap // bm) * bm
    out_padded = outputs
    if mcap2 != mcap:
        outp = torch.full((mcap2,), pad_value(outputs.packed.dtype),
                          dtype=outputs.packed.dtype,
                          device=outputs.packed.device)
        outp[:mcap] = outputs.packed
        out_padded = CoordSet(packed=outp, count=outputs.count)
    n = inputs.packed.shape[0]
    if superwindow:
        W = min(W or max(16 * bm, 2048), n)
        m, ovf = zdelta_superwindow_search(inputs, out_padded, anchors,
                                           zstep, K=K, W=W, bm=bm,
                                           backend=backend)
    else:
        W = min(W or max(4 * bm, 512), n)
        m, ovf = zdelta_window_search(inputs, out_padded, anchors, zstep,
                                      K=K, W=W, bm=bm, backend=backend)
    m = m[:mcap]
    bad_cells = (ovf > 0).sum(dtype=torch.int32)
    if int(bad_cells):          # the map is exact either way (module doc)
        m_x = zdelta_search(inputs, outputs, anchors, zstep, K=K)
        bad = (ovf > 0).repeat_interleave(bm, dim=0).repeat_interleave(
            K, dim=1)[:mcap]
        m = torch.where(bad, m_x, m)
    return m, bad_cells


def _layer_map(inputs: CoordSet, outputs: CoordSet, s: SpConvSpec,
               layout: BitLayout, engine: str):
    """One layer's kernel map, symmetry-aware for submanifold layers;
    returns ``(map, window_overflow_cells)``."""
    if engine not in ENGINES:
        raise NotImplementedError(
            f"engine {engine!r} is not ported (the port has {ENGINES}; "
            "bsearch and hash are in ROADMAP Queue 1)")
    dev = inputs.packed.device
    _, anchors, zstep = zdelta_offsets(s.K, s.offset_stride, layout,
                                       device=dev)
    # the per-group window engine never takes the half-search, as in JAX
    use_sym = (s.symmetry and s.submanifold
               and engine in ("zdelta", "zdelta_cuda"))
    if engine == "zdelta":
        no_ovf = torch.zeros((), dtype=torch.int32, device=dev)
        if use_sym:
            return zdelta_search_symmetric(inputs, outputs, anchors, zstep,
                                           K=s.K), no_ovf
        return zdelta_search(inputs, outputs, anchors, zstep, K=s.K), no_ovf
    if use_sym:
        anchors = anchors[: symmetry_anchor_count(s.K)]
    m, ovf = _kernel_map_search(inputs, outputs, anchors, zstep, K=s.K,
                                W=s.window,
                                superwindow=(engine == "zdelta_cuda"))
    if use_sym:
        m = symmetrize_kernel_map(expand_half_map(m, K=s.K), K=s.K)
    return m, ovf


def build_network_plan(packed_raw: torch.Tensor, *,
                       specs: Tuple[SpConvSpec, ...], layout: BitLayout,
                       engine: str = "zdelta_cuda",
                       downsample_method: str = "auto") -> NetworkPlan:
    """One-shot, network-wide indexing from raw packed V0 words (any order,
    PAD-padded): one sort + dedup at V0, every coarser level by
    ``downsample_all``, then every layer's kernel map by ``engine``."""
    v0 = build_coord_set(packed_raw)
    levels = plan_levels(specs)
    coords: Dict[int, CoordSet] = dict(zip(
        levels, downsample_all(v0, layout, levels, method=downsample_method)))
    kmaps: Dict[str, KernelMap] = {}
    stats: Dict[str, torch.Tensor] = {}
    for s in specs:
        inputs, outputs = coords[s.m_in], coords[s.m_out]
        m, ovf = _layer_map(inputs, outputs, s, layout, engine)
        kmaps[s.name] = KernelMap(m=m, out_count=outputs.count,
                                  in_count=inputs.count)
        stats[s.name] = ovf
    return NetworkPlan(coords=coords, kmaps=kmaps, stats=stats)
