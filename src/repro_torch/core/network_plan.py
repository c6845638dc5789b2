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
repaired with the exact ``"zdelta"`` search, on the card by the repair
kernel and with no host read, so the map is exact either way and the plan
never waits on the card; ``NetworkPlan.stats`` counts the repaired cells
per layer. A layer's
window is ``spec.window`` (0: the engine's default), held to the largest
window the kernel can stage for the word type
(``kernels.zdelta_window.max_window``).

The paper's baselines, in plain torch (yardsticks, not main paths):

* ``"bsearch"`` — one full binary search per query
  (``zdelta.simple_bsearch``, Fig. 10);
* ``"hash"`` — a linear-probing hash table built over the inputs and
  probed per query (``core.hashmap``, Figs. 2 and 10);
* :func:`sequential_plan_fns` — one function per level and one per layer,
  called back to back, every level paying its own sort (Fig. 12).

Every engine gives the same kernel maps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from . import hashmap
from .kernel_map import KernelMap
from .packing import BitLayout, offset_grid, pack_offsets
from .spconv import SpConvSpec
from .voxel import (CoordSet, build_coord_set, downsample, downsample_all,
                    pad_value)
from .zdelta import (expand_half_map, simple_bsearch, symmetrize_kernel_map,
                     symmetry_anchor_count, zdelta_offsets, zdelta_search,
                     zdelta_search_symmetric)

ENGINES = ("zdelta", "zdelta_cuda", "zdelta_cuda_window", "bsearch", "hash")


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
# the windows a spec's ``window = 0`` asks for, by search
DEFAULT_WINDOW = {"superwindow": max(16 * PLAN_BM, 2048),
                  "window": max(4 * PLAN_BM, 512)}


def _kernel_map_search(inputs: CoordSet, outputs: CoordSet,
                       anchors: torch.Tensor, zstep: int, *, K: int,
                       W: int = 0, superwindow: bool = True,
                       backend: str = "auto"):
    """Superwindow (or per-group window) search with the per-cell overflow
    repair: cells whose queries ran past their window are recomputed by
    the exact z-delta search (``kernels.zdelta_window.zdelta_repair``: on
    the card a kernel that skips the cells that did not overflow, on the
    CPU its plain version), with no host read. Outputs are PAD-padded to a
    multiple of ``PLAN_BM`` so the kernel runs full tiles; the map is
    sliced back. Returns ``(map, overflowed cells)``."""
    from ..kernels.zdelta_window import (max_window, zdelta_repair,
                                         zdelta_superwindow_search,
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
    kind = "superwindow" if superwindow else "window"
    W = min(W or DEFAULT_WINDOW[kind], n,
            max_window(kind, inputs.packed.dtype, anchors.shape[0], K))
    if superwindow:
        m, ovf = zdelta_superwindow_search(inputs, out_padded, anchors,
                                           zstep, K=K, W=W, bm=bm,
                                           backend=backend)
    else:
        m, ovf = zdelta_window_search(inputs, out_padded, anchors, zstep,
                                      K=K, W=W, bm=bm, backend=backend)
    m = zdelta_repair(inputs, out_padded, anchors, zstep, m, ovf, K=K, bm=bm,
                      backend=backend)
    return m[:mcap], (ovf > 0).sum(dtype=torch.int32)


def _layer_map(inputs: CoordSet, outputs: CoordSet, s: SpConvSpec,
               layout: BitLayout, engine: str):
    """One layer's kernel map, symmetry-aware for submanifold layers;
    returns ``(map, window_overflow_cells)``, the counter 0 for the
    engines without a window."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; the port has "
                         f"{ENGINES}")
    dev = inputs.packed.device
    if engine in ("bsearch", "hash"):
        no_ovf = torch.zeros((), dtype=torch.int32, device=dev)
        offs = pack_offsets(offset_grid(s.K, s.offset_stride), layout,
                            device=dev)
        if engine == "bsearch":
            return simple_bsearch(inputs, outputs, offs, K=s.K), no_ovf
        tk, tv = hashmap.build_table(
            inputs, table_size=hashmap.table_size_for(inputs.capacity))
        return hashmap.hash_kernel_map(tk, tv, outputs, offs, K=s.K), no_ovf
    _, anchors, zstep = zdelta_offsets(s.K, s.offset_stride, layout,
                                       device=dev)
    # the per-group window engine never takes the half-search, as in JAX
    use_sym = (s.symmetry and s.submanifold
               and engine in ("zdelta", "zdelta_cuda"))
    return zdelta_engine_map(inputs, outputs, anchors, zstep, K=s.K,
                             engine=engine, symmetric=use_sym, W=s.window)


def zdelta_engine_map(inputs: CoordSet, outputs: CoordSet,
                      anchors: torch.Tensor, zstep: int, *, K: int,
                      engine: str, symmetric: bool = False, W: int = 0):
    """The map of one z-delta engine (``"zdelta"``, ``"zdelta_cuda"`` or
    ``"zdelta_cuda_window"``) over the full anchor set, by the §5.4
    half-search and mirror fill when ``symmetric`` (a submanifold layer;
    not on the per-group window engine); returns ``(map, overflowed
    cells)``. The tuner times the session's own search through it."""
    if engine == "zdelta":
        no_ovf = torch.zeros((), dtype=torch.int32,
                             device=inputs.packed.device)
        if symmetric:
            return zdelta_search_symmetric(inputs, outputs, anchors, zstep,
                                           K=K), no_ovf
        return zdelta_search(inputs, outputs, anchors, zstep, K=K), no_ovf
    if symmetric:
        anchors = anchors[: symmetry_anchor_count(K)]
    m, ovf = _kernel_map_search(inputs, outputs, anchors, zstep, K=K, W=W,
                                superwindow=(engine == "zdelta_cuda"))
    if symmetric:
        m = symmetrize_kernel_map(expand_half_map(m, K=K), K=K)
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


def sequential_plan_fns(specs: Tuple[SpConvSpec, ...], layout: BitLayout):
    """The sequential-indexing baseline of the paper's Fig. 12: a sort
    function for V0, one downsample function per coarser level (each its
    own full sort, ``method="sort"``) and one mapping function per layer
    (the ``"zdelta"`` search), called back to back by the caller.
    Returns ``(sort_fn, level_fns, map_fns)``; ``map_fns[name](inputs,
    outputs)`` gives the layer's :class:`KernelMap`, equal to
    :func:`build_network_plan`'s."""
    def sort_fn(packed_raw: torch.Tensor) -> CoordSet:
        return build_coord_set(packed_raw)

    level_fns = {m: (lambda c, m=m: downsample(c, layout, m, method="sort"))
                 for m in plan_levels(specs) if m != 0}

    def make(s: SpConvSpec):
        def one(inputs: CoordSet, outputs: CoordSet) -> KernelMap:
            _, anchors, zstep = zdelta_offsets(s.K, s.offset_stride, layout,
                                               device=inputs.packed.device)
            m = zdelta_search(inputs, outputs, anchors, zstep, K=s.K)
            return KernelMap(m=m, out_count=outputs.count,
                             in_count=inputs.count)
        return one

    map_fns = {s.name: make(s) for s in specs}
    return sort_fn, level_fns, map_fns
